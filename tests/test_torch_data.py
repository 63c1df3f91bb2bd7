"""The port's training data path against the JAX package on the CPU:
``data/audio.py``, ``data/tokenizer.py`` (the BPE greedy fallback,
``build_tokenizer``), every processor of ``data/processor.py`` and every
stage of ``data/pipeline.py``, then ``Dataset`` end to end.

Inputs are seeded numpy; every random stage gets generators of the same
seed on both sides, so the draws must line up one for one. Both packages'
``compute_fbank`` run their native host library (the port's own copy,
``native/``), whose dither generator is seeded from the same draw, so the
stage and ``Dataset``'s fbank features are bit for bit equal; the port's
numpy twin is held against the JAX numpy path (``CHUNKFORMER_NO_NATIVE=1``
on the JAX side only). Bars: the numpy fbank, log-mel and MFCC atol 1e-5
(float32 FFTs of two implementations); ``Dataset`` keys, lengths and labels
identical, feats atol 1e-6; everything else exactly equal.
"""

import json
import random
import tarfile

import numpy as np
import pytest
from scipy.io import wavfile

from chunkformer_tpu.data import audio as jaudio
from chunkformer_tpu.data import pipeline as jpipe
from chunkformer_tpu.data import processor as jproc
from chunkformer_tpu.data import tokenizer as jtok
from chunkformer_tpu_torch.data import audio as taudio
from chunkformer_tpu_torch.data import pipeline as tpipe
from chunkformer_tpu_torch.data import processor as tproc
from chunkformer_tpu_torch.data import tokenizer as ttok

UNITS = ["<blank>", "<unk>", "a", "b", "c", "▁", "▁ab", "ab", "ca", "<sos/eos>"]


def _wave(seconds, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 4000 * np.sin(2 * np.pi * (180 + 40 * seed) * t) + rng.normal(size=t.size) * 800
    return x.astype(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten WAVs of 0.4-1.6 s (one 8 kHz stereo), a list with texts and
    class labels, a char units file, a tar shard list."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(3)
    lines, jl = [], []
    for i in range(10):
        p = d / f"u{i}.wav"
        if i == 4:
            x = _wave(0.9, 8000, seed=i)
            wavfile.write(str(p), 8000, np.stack([x, x[::-1]], 1))
        else:
            wavfile.write(str(p), 16000, _wave(0.4 + 0.12 * i + 0.05 * rng.random(), seed=i))
        txt = " ".join(rng.choice(["ab", "ca", "b", "abc"], size=1 + i % 3))
        lines.append(f"u{i}\t{p}\t{txt}\n")
        jl.append(json.dumps({"key": f"u{i}", "wav": str(p), "txt": txt,
                              "label_gender": i % 2, "label_age": i % 3}) + "\n")
    (d / "data.list").write_text("".join(lines))
    (d / "data.jsonl").write_text("".join(jl))
    (d / "units.txt").write_text("".join(f"{u} {i}\n" for i, u in enumerate(UNITS)))
    shards = []
    for s in range(2):
        tp = d / f"shard{s}.tar"
        with tarfile.open(tp, "w") as tar:
            for i in range(s * 5, s * 5 + 5):
                tar.add(str(d / f"u{i}.wav"), arcname=f"u{i}.wav")
                tx = d / f"u{i}.txt"
                tx.write_text(lines[i].split("\t")[2])
                tar.add(str(tx), arcname=f"u{i}.txt")
        shards.append(f"shard{s}\t{tp}\n")  # the sources read key<TAB>path lines
    (d / "shards.list").write_text("".join(shards))
    return d


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ------------------------------------------------------------------ audio


@pytest.mark.parametrize("start,end", [(None, None), (0.1, None), (0.05, 0.3)])
def test_load_audio_matches_jax(corpus, start, end):
    for i in (1, 4):
        got = taudio.load_audio(str(corpus / f"u{i}.wav"), 16000, start, end)
        want = jaudio.load_audio(str(corpus / f"u{i}.wav"), 16000, start, end)
        _same(got[0], want[0])
        assert got[1] == want[1]


def test_load_wav_bytes_and_speed_perturb_match_jax(corpus):
    for i in (2, 4):
        raw = (corpus / f"u{i}.wav").read_bytes()
        _same(taudio.load_wav_bytes(raw), jaudio.load_wav_bytes(raw))
    x = _wave(0.7).astype(np.float32)
    for speed in (0.9, 1.0, 1.1):
        _same(taudio.speed_perturb(x, speed), jaudio.speed_perturb(x, speed))


def test_load_audio_without_ffmpeg_raises(tmp_path, monkeypatch):
    p = tmp_path / "a.flac"
    p.write_bytes(b"not audio")
    monkeypatch.setattr(taudio.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        taudio.load_audio(str(p))


# -------------------------------------------------------------- tokenizer


def test_bpe_greedy_fallback_matches_jax(corpus):
    table = {u: i for i, u in enumerate(UNITS)}
    got, want = ttok.BpeTokenizer(table), jtok.BpeTokenizer(table)
    for line in ("ab ca", "abc b", "x ab", "  cab  ", ""):
        assert got.tokenize(line) == want.tokenize(line)
    ids = got.tokenize("ab ca abc")[1]
    assert got.detokenize(ids) == want.detokenize(ids)


@pytest.mark.parametrize("kind,conf", [
    ("char", {}),
    ("char", {"split_with_space": True}),
    ("bpe", {"bpe_path": "absent.model"}),
])
def test_build_tokenizer_matches_jax(corpus, kind, conf):
    conf = {"symbol_table_path": str(corpus / "units.txt"), **conf}
    got, want = ttok.build_tokenizer(kind, conf), jtok.build_tokenizer(kind, conf)
    assert type(got).__name__ == type(want).__name__
    assert got.vocab_size == want.vocab_size
    for line in ("ab ca", "abc b c"):
        assert got.tokenize(line) == want.tokenize(line)


# -------------------------------------------------------------- processor


@pytest.mark.parametrize("window", ["povey", "hamming", "hanning", "rectangular", "blackman"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_compute_fbank_numpy_matches_jax(window, dither):
    x = _wave(0.83, seed=5).astype(np.float32)
    got = tproc.compute_fbank_numpy(x, 80, 25, 10, dither, 16000, window,
                                    rng=np.random.default_rng(1))
    want = jproc.compute_fbank_numpy(x, 80, 25, 10, dither, 16000, window,
                                     rng=np.random.default_rng(1))
    assert got.shape == want.shape == (81, 80)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_log_mel_and_mfcc_match_jax():
    x = _wave(0.61, seed=2).astype(np.float32)
    for pad in (0, 480):
        np.testing.assert_allclose(
            tproc.compute_log_mel_spectrogram_numpy(x, 400, 160, 80, 16000, pad),
            jproc.compute_log_mel_spectrogram_numpy(x, 400, 160, 80, 16000, pad),
            atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tproc.compute_mfcc_numpy(x, 23, 13, 25, 10, 1.0, 16000, rng=np.random.default_rng(4)),
        jproc.compute_mfcc_numpy(x, 23, 13, 25, 10, 1.0, 16000, rng=np.random.default_rng(4)),
        atol=1e-5, rtol=0)


def test_decode_speed_perturb_and_fbank_stages_match_jax(corpus):
    """The stages against JAX's default path: its native fbank, dither on."""
    for i in (0, 3, 4):
        sample = {"key": f"u{i}", "wav": str(corpus / f"u{i}.wav"), "start": 0.02, "end": 0.5}
        got = tproc.decode_wav(dict(sample))
        want = jproc.decode_wav(dict(sample))
        _same(got, want)
        g_rng, j_rng = np.random.default_rng(i), np.random.default_rng(i)
        got = tproc.compute_fbank(tproc.do_speed_perturb(got, rng=g_rng), dither=1.0, rng=g_rng)
        want = jproc.compute_fbank(jproc.do_speed_perturb(want, rng=j_rng), dither=1.0,
                                   rng=j_rng)
        np.testing.assert_array_equal(got["feat"], want["feat"])
        assert g_rng.integers(1 << 30) == j_rng.integers(1 << 30)
    raw = {"key": "b", "wav": (corpus / "u2.wav").read_bytes()}
    _same(tproc.decode_wav(dict(raw)), jproc.decode_wav(dict(raw)))


@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_numpy_fbank_twin_matches_jax_numpy_path(corpus, monkeypatch, dither):
    """The port's numpy twin against the JAX ``compute_fbank`` forced onto
    its numpy fallback, which draws its native seed first."""
    monkeypatch.setenv("CHUNKFORMER_NO_NATIVE", "1")
    sample = tproc.decode_wav({"key": "u1", "wav": str(corpus / "u1.wav")})
    g_rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    if dither > 0:
        g_rng.integers(2**63)
    got = tproc.compute_fbank_numpy(sample["waveform"], dither=dither,
                                    sample_rate=sample["sample_rate"], rng=g_rng)
    want = jproc.compute_fbank(dict(sample), dither=dither, rng=j_rng)["feat"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert g_rng.integers(1 << 30) == j_rng.integers(1 << 30)


def test_tokenize_and_filter_match_jax(corpus):
    conf = {"symbol_table_path": str(corpus / "units.txt")}
    tt, jt = ttok.build_tokenizer("char", conf), jtok.build_tokenizer("char", conf)
    for txt in ("ab ca", "", "abcabc"):
        _same(tproc.tokenize({"txt": txt}, tt), jproc.tokenize({"txt": txt}, jt))
    cases = [(50, 3), (5, 3), (50, 0), (50, 60), (3000, 3), (0, 0)]
    for n, u in cases:
        for kw in ({}, {"max_length": 40, "token_min_length": 0},
                   {"min_output_input_ratio": 0.1, "max_output_input_ratio": 0.5}):
            s = {"feat": np.zeros((n, 4), np.float32), "label": np.arange(u)}
            assert tproc.filter_sample(s, **kw) == jproc.filter_sample(s, **kw)


@pytest.mark.parametrize("fn,kw", [
    ("spec_aug", {}),
    ("spec_aug", {"num_t_mask": 3, "num_f_mask": 1, "max_t": 7, "max_f": 5, "fill": "mean"}),
    ("spec_sub", {}),
    ("spec_sub", {"max_t": 4, "num_t_sub": 5}),
    ("spec_trim", {}),
    ("spec_trim", {"max_t": 3}),
])
def test_spec_augmentations_match_jax(fn, kw):
    rng = np.random.default_rng(8)
    for t in (1, 9, 40, 120):
        feat = rng.standard_normal((t, 16)).astype(np.float32)
        g_rng, j_rng = np.random.default_rng(t), np.random.default_rng(t)
        got = getattr(tproc, fn)({"feat": feat.copy()}, rng=g_rng, **kw)
        want = getattr(jproc, fn)({"feat": feat.copy()}, rng=j_rng, **kw)
        _same(got, want)
        assert g_rng.integers(1 << 30) == j_rng.integers(1 << 30)


@pytest.mark.parametrize("kw", [
    {},
    {"time_bucket": 16, "label_bucket": 4},
    {"pad_to_time": 200, "pad_to_label": 20, "pad_to_batch": 6},
    {"is_classification": True},
])
def test_padding_matches_jax(kw):
    rng = np.random.default_rng(2)
    batch = []
    for i, t in enumerate((37, 90, 12, 64)):
        batch.append({"key": f"k{i}", "feat": rng.standard_normal((t, 8)).astype(np.float32),
                      "label": rng.integers(2, 9, size=1 + i * 3),
                      "class_labels": {"age": i % 3, "gender": i % 2}})
    _same(tproc.padding(batch, **kw), jproc.padding(batch, **kw))


def test_dynamic_batch_window_matches_jax():
    rng = np.random.default_rng(5)
    got, want = tproc.DynamicBatchWindow(300), jproc.DynamicBatchWindow(300)
    n = 0
    for t in rng.integers(10, 120, size=40):
        s = {"feat": np.zeros((int(t), 1))}
        a, b = got(s, n), want(s, n)
        assert a == b
        n = 1 if a else n + 1


# --------------------------------------------------------------- pipeline


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"key": f"s{i}", "feat": np.zeros((int(t), 2), np.float32)}
            for i, t in enumerate(rng.integers(5, 200, size=n))]


def _keys(batches):
    return [[s["key"] for s in b] for b in batches]


def test_sources_and_shard_match_jax(corpus):
    for name in ("data.list", "data.jsonl"):
        _same(list(tpipe.text_line_source(str(corpus / name))),
              list(jpipe.text_line_source(str(corpus / name))))
    shards = [ln.split("\t")[1] for ln in (corpus / "shards.list").read_text().splitlines()]
    _same(list(tpipe.tar_shard_source(shards)), list(jpipe.tar_shard_source(shards)))
    for n, i, full in ((3, 1, False), (2, 0, False), (4, 3, True), (1, 0, False)):
        _same([s["key"] for s in tpipe.shard(iter(_samples(11)), n, i, full)],
              [s["key"] for s in jpipe.shard(iter(_samples(11)), n, i, full)])


def test_mapper_shuffle_sort_match_jax():
    def fn(s):
        if s["key"] in ("s3", "s7"):
            raise ValueError("bad sample")
        return s

    _same([s["key"] for s in tpipe.mapper_ignore_error(iter(_samples(10)), fn, False)],
          [s["key"] for s in jpipe.mapper_ignore_error(iter(_samples(10)), fn, False)])
    for size in (4, 1000):
        _same([s["key"] for s in tpipe.shuffle(iter(_samples(23)), size, random.Random(5))],
              [s["key"] for s in jpipe.shuffle(iter(_samples(23)), size, random.Random(5))])
        _same([s["key"] for s in tpipe.sort_by_length(iter(_samples(23)), size)],
              [s["key"] for s in jpipe.sort_by_length(iter(_samples(23)), size)])


@pytest.mark.parametrize("kind", ["static", "static_drop", "dynamic", "bucket", "group"])
def test_batchers_match_jax(kind):
    def run(m):
        src = iter(_samples(37, seed=4))
        if kind == "static":
            return m.static_batch(src, 5)
        if kind == "static_drop":
            return m.static_batch(src, 5, drop_last=True)
        if kind == "dynamic":
            return m.dynamic_batch(src, 600)
        if kind == "bucket":
            return m.bucket_batch(src, [50, 120], [6, 3, 2])
        return m.group_by_window(src, lambda s: s["feat"].shape[0] // 60, 3)

    _same(_keys(run(tpipe)), _keys(run(jpipe)))


def test_repeat_interleave_prefetch_epoch_steps_match_jax():
    _same(list(tpipe.repeat(lambda: iter(range(3)), 3)),
          list(jpipe.repeat(lambda: iter(range(3)), 3)))
    srcs = lambda: [iter(range(0, 5)), iter(range(10, 13)), iter(range(20, 28))]  # noqa: E731
    _same(list(tpipe.interleave(srcs(), [1.0, 2.0, 0.5], random.Random(1))),
          list(jpipe.interleave(srcs(), [1.0, 2.0, 0.5], random.Random(1))))
    _same(list(tpipe.prefetch(iter(range(20)), 3)), list(range(20)))

    def boom():
        yield 1
        raise KeyError("upstream")

    with pytest.raises(KeyError):
        list(tpipe.prefetch(boom(), 2))
    for n in (0, 2, 7):
        _same(list(tpipe.fixed_epoch_steps(iter(range(4)), n)),
              list(jpipe.fixed_epoch_steps(iter(range(4)), n)))
    with pytest.raises(RuntimeError, match="empty"):
        list(tpipe.fixed_epoch_steps(iter([]), 3))


def test_extract_class_labels_matches_jax():
    for s in ({"key": "a", "label_age": "2", "label_gender": 1},
              {"key": "b", "class_labels": {"x": 1}}):
        _same(tpipe._extract_class_labels(dict(s)), jpipe._extract_class_labels(dict(s)))


# --------------------------------------------------------- Dataset end to end

_AUG = {"speed_perturb": True, "fbank_conf": {"num_mel_bins": 80, "dither": 1.0},
        "spec_aug": True, "spec_aug_conf": {"max_t": 10, "max_f": 8},
        "spec_sub": True, "spec_trim": True, "shuffle": True,
        "shuffle_conf": {"shuffle_size": 4}, "sort": True, "sort_conf": {"sort_size": 3}}


@pytest.mark.parametrize("name,data_type,conf,classification", [
    ("static", "raw", {**_AUG, "batch_conf": {"batch_type": "static", "batch_size": 3}}, False),
    ("dynamic", "raw", {**_AUG, "batch_conf": {"batch_type": "dynamic",
                                               "max_frames_in_batch": 300}}, False),
    ("bucket", "raw", {**_AUG, "batch_conf": {"batch_type": "bucket",
                                              "bucket_boundaries": [70, 120],
                                              "bucket_batch_sizes": [4, 3, 2]}}, False),
    ("static_shapes", "raw", {**_AUG, "filter_conf": {"max_length": 400,
                                                      "token_max_length": 30},
                              "batch_conf": {"batch_type": "static", "batch_size": 4,
                                             "static_shapes": True}}, False),
    ("epoch_steps_prefetch", "raw", {**_AUG, "epoch_steps": 5, "prefetch_buffer": 2,
                                     "batch_conf": {"batch_type": "static",
                                                    "batch_size": 3}}, False),
    ("shard", "shard", {**_AUG, "batch_conf": {"batch_type": "static", "batch_size": 2}},
     False),
    ("mfcc_classification", "raw", {"feats_type": "mfcc", "mfcc_conf": {"dither": 1.0},
                                    "spec_aug": True, "shuffle": True,
                                    "batch_conf": {"batch_size": 4}}, True),
    ("log_mel", "raw", {"feats_type": "log_mel_spectrogram", "speed_perturb": True,
                        "batch_conf": {"batch_size": 4}}, False),
])
def test_dataset_matches_jax(corpus, name, data_type, conf, classification):
    """Two epochs of ``Dataset`` in both packages, one of them a shard of
    two, each package on its default (native) fbank: keys, lengths, labels
    identical, feats atol 1e-6."""
    tconf = {"symbol_table_path": str(corpus / "units.txt")}
    lst = {"shard": "shards.list"}.get(data_type, "data.jsonl" if classification
                                       else "data.list")
    for shards, shard_id in ((1, 0), (2, 1)):
        kw = dict(num_shards=shards, shard_id=shard_id, seed=11,
                  is_classification=classification)
        got = tpipe.Dataset(data_type, str(corpus / lst), ttok.build_tokenizer("char", tconf),
                            conf, **kw)
        want = jpipe.Dataset(data_type, str(corpus / lst),
                             jtok.build_tokenizer("char", tconf), conf, **kw)
        n = 0
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            gb, wb = list(got), list(want)
            assert len(gb) == len(wb) > 0
            for a, b in zip(gb, wb):
                assert a.keys() == b.keys()
                for k in a:
                    if k == "feats":
                        assert a[k].shape == b[k].shape
                        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0)
                    else:
                        _same(a[k], b[k])
                n += len(a["keys"])
        assert n > 0
