"""The port's remaining data helpers against the JAX package on the CPU:
``data/kaldi_io.py`` (each reader gives JAX's arrays on the same files,
each writer writes JAX's bytes; the cases of ``tests/test_data_aux.py``),
``data/wav_distortion.py`` (equal under one seed), ``utils/params.py``
(``random_params_like`` equals ``convert`` of the JAX draw bit for bit;
``count_params`` and ``tree_bytes`` equal JAX's), the chunk masks (equal)
and ``ops/fbank.py:fbank_batch`` (frame lengths equal; features within the
fbank bar, atol 2e-3 + rtol 1e-3: the port's plain fbank computes in
float64, JAX's in float32).
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.data import kaldi_io as jk
from chunkformer_tpu.data import wav_distortion as jw
from chunkformer_tpu.ops import masks as jmasks
from chunkformer_tpu.ops.fbank import fbank_batch as jax_fbank_batch
from chunkformer_tpu.utils import params as jparams
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params
from chunkformer_tpu_torch.data import kaldi_io as tk
from chunkformer_tpu_torch.data import wav_distortion as tw
from chunkformer_tpu_torch.ops import masks as tmasks
from chunkformer_tpu_torch.ops.fbank import fbank_batch

# --------------------------------------------------------------- kaldi I/O


def _same_tree(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


def _write_both(tmp_path, name, write):
    """Write one file with each package's module; return the path of the
    JAX file after checking that the bytes are equal."""
    paths = []
    for tag, mod in (("jax", jk), ("port", tk)):
        p = tmp_path / f"{tag}_{name}"
        with open(p, "wb") as f:
            write(mod, f)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    return str(paths[0])


def test_ark_and_scp_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    items = [("utt1", rng.normal(size=(5, 3)).astype(np.float32)),
             ("utt2", rng.normal(size=(2, 3)).astype(np.float32)),
             ("vec1", rng.normal(size=7).astype(np.float32))]
    for tag, mod in (("jax", jk), ("port", tk)):
        mod.write_ark(str(tmp_path / f"{tag}.ark"), items, str(tmp_path / f"{tag}.scp"))
    assert (tmp_path / "jax.ark").read_bytes() == (tmp_path / "port.ark").read_bytes()
    ark, scp = str(tmp_path / "jax.ark"), str(tmp_path / "jax.scp")
    _same_tree(list(tk.read_ark(ark)), list(jk.read_ark(ark)))
    _same_tree(list(tk.read_scp(scp)), list(jk.read_scp(scp)))


def test_vectors_matrices_and_specifiers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    m32 = rng.normal(size=(4, 3)).astype(np.float32)
    m64 = rng.normal(size=(2, 5)).astype(np.float64)

    def ints(mod, f):
        mod.write_vec_int(f, [3, 1, 4, 1, 5], key="u1")
        mod.write_vec_int(f, np.arange(0, dtype=np.int32), key="u2")
        mod.write_vec_int(f, [-7, 2**20], key="u3")

    def flts(mod, f):
        mod.write_vec_flt(f, np.arange(3, dtype=np.float32), key="f1")
        mod.write_vec_flt(f, np.linspace(0, 1, 4), key="f2")

    def mats(mod, f):
        mod.write_mat(f, m32, key="m32")
        mod.write_mat(f, m64, key="m64")

    p = _write_both(tmp_path, "ints.ark", ints)
    _same_tree(list(tk.read_vec_int_ark(p)), list(jk.read_vec_int_ark(p)))
    _same_tree(list(tk.read_ali_ark(p)), list(jk.read_ali_ark(p)))
    p = _write_both(tmp_path, "flts.ark", flts)
    _same_tree(list(tk.read_vec_flt_ark(p)), list(jk.read_vec_flt_ark(p)))
    p = _write_both(tmp_path, "mats.ark", mats)
    _same_tree(list(tk.read_mat_ark(p)), list(jk.read_mat_ark(p)))
    _same_tree(list(tk.read_mat_ark(f"cat {p} |")), list(jk.read_mat_ark(f"cat {p} |")))
    off = len(b"m32 ")
    _same_tree(tk.read_mat(f"{p}:{off}"), jk.read_mat(f"{p}:{off}"))
    for tag, mod in (("jax", jk), ("port", tk)):
        with open(tmp_path / f"{tag}_as.ark", "wb") as f, \
                open(tmp_path / f"{tag}_as.scp", "w") as s:
            mod.write_ark_scp("m32", m32, f, s)
    assert (tmp_path / "jax_as.ark").read_bytes() == (tmp_path / "port_as.ark").read_bytes()
    scp = str(tmp_path / "jax_as.scp")
    _same_tree(list(tk.read_mat_scp(scp)), list(jk.read_mat_scp(scp)))


def test_ascii_compressed_posteriors_cntime_and_segments_match_jax(tmp_path):
    a = tmp_path / "ascii.txt"
    a.write_text("  [\n  1 2 3\n  4 5 6 ]\n")
    _same_tree(tk.read_mat(str(a)), jk.read_mat(str(a)))
    v = tmp_path / "vec.txt"
    v.write_text(" [ 1.5 2.5 ]\n")
    _same_tree(tk.read_vec_flt(str(v)), jk.read_vec_flt(str(v)))

    rng = np.random.default_rng(3)
    rows, cols = 20, 5
    header = struct.pack("<ffii", -3.0, 7.5, rows, cols)
    pct = rng.integers(0, 65536, size=(cols, 4)).astype(np.uint16)
    pct.sort(axis=1)
    codes = rng.integers(0, 256, size=(cols, rows)).astype(np.uint8)
    cm = tmp_path / "cm.bin"
    cm.write_bytes(b"\0BCM " + header + pct.tobytes() + codes.tobytes())
    _same_tree(tk.read_mat(str(cm)), jk.read_mat(str(cm)))

    post = tmp_path / "post.ark"
    with open(post, "wb") as f:
        f.write(b"u1 \0B\x04" + struct.pack("<i", 2))
        for pairs in ([(1, 0.5), (2, 0.5)], [(3, 1.0)]):
            f.write(b"\x04" + struct.pack("<i", len(pairs)))
            for i, w in pairs:
                f.write(b"\x04" + struct.pack("<i", i) + b"\x04" + struct.pack("<f", w))
    _same_tree(list(tk.read_post_ark(str(post))), list(jk.read_post_ark(str(post))))
    cnt = tmp_path / "cntime.ark"
    with open(cnt, "wb") as f:
        f.write(b"u1 \0B\x04" + struct.pack("<i", 2))
        for b_, e_ in ((0.0, 0.5), (0.5, 1.25)):
            f.write(b"\x04" + struct.pack("<f", b_) + b"\x04" + struct.pack("<f", e_))
    _same_tree(list(tk.read_cntime_ark(str(cnt))), list(jk.read_cntime_ark(str(cnt))))
    seg = tmp_path / "segments"
    seg.write_text("seg1 rec1 0.10 0.25\nseg2 rec1 0.50 0.60\n")
    _same_tree(tk.read_segments_as_bool_vec(str(seg)), jk.read_segments_as_bool_vec(str(seg)))


# --------------------------------------------------------------- distortion


@pytest.mark.parametrize("method", ["gain_db", "max_distortion", "fence_distortion",
                                    "jag_distortion", "poly_distortion", "quad_distortion",
                                    "none"])
def test_distortions_match_jax(method):
    x = (np.random.default_rng(0).normal(size=8000) * 0.2).astype(np.float32)
    got = tw.distort_chain(x, method, 0.05, np.random.default_rng(4))
    want = jw.distort_chain(x, method, 0.05, np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    conf = {"distortion_prob": 0.7, "distortion_method": method}
    for seed in range(4):
        got = tw.distort_wav_conf({"waveform": x * 32768.0}, conf, np.random.default_rng(seed))
        want = jw.distort_wav_conf({"waveform": x * 32768.0}, conf, np.random.default_rng(seed))
        np.testing.assert_array_equal(got["waveform"], want["waveform"])


# ------------------------------------------------------------------ params

ENC = {"output_size": 64, "attention_heads": 4, "linear_units": 128, "num_blocks": 2,
       "cnn_module_kernel": 15, "cnn_module_norm": "batch_norm"}
CONFIGS = {
    "ctc_aed": {"model": "asr_model", "encoder_conf": ENC, "decoder": "bitransformer",
                "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                                 "r_num_blocks": 1},
                "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3}, "output_dim": 40},
    "classification": {"model": "classification", "encoder_conf": ENC,
                       "model_conf": {"tasks": {"gender": 2, "emotion": 4}},
                       "output_dim": 40},
    "transducer": {"model": "transducer", "encoder_conf": ENC, "predictor": "rnn",
                   "predictor_conf": {"embed_size": 32, "output_size": 32, "hidden_size": 32,
                                      "num_layers": 2},
                   "joint_conf": {"join_dim": 48, "pred_output_size": 32},
                   "model_conf": {"ctc_weight": 0.3}, "output_dim": 40},
}


def _models(name):
    from chunkformer_tpu.models.asr import init_asr_model
    from chunkformer_tpu.models.classification import init_classification_model
    from chunkformer_tpu.models.transducer import init_transducer
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.models.classification import ClassificationModel
    from chunkformer_tpu_torch.models.transducer import TransducerModel

    d = CONFIGS[name]
    jcfg, cfg = JaxConfig.from_dict(d), ChunkFormerConfig.from_dict(d)
    jcfg.vocab_size = d["output_dim"]
    init = {"ctc_aed": init_asr_model, "classification": init_classification_model,
            "transducer": init_transducer}[name]
    if name == "transducer":
        port = TransducerModel(cfg, cmvn=False, ctc=True, simple=False)
    else:
        port = {"ctc_aed": ASRModel, "classification": ClassificationModel}[name](cfg, False)
    return (lambda key: init(key, jcfg)), cfg, port


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_random_params_like_equals_the_jax_draw(name):
    init_fn, cfg, model = _models(name)
    jp = jparams.random_params_like(init_fn, seed=3, scale=0.07)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jp), cfg)
    from chunkformer_tpu_torch.utils.params import count_params, random_params_like, tree_bytes

    got = random_params_like(model, seed=3, scale=0.07).state_dict()
    assert want.keys() <= got.keys()
    for k in want:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    assert count_params(model) == jparams.count_params(jp)
    assert tree_bytes(model) == jparams.tree_bytes(jp)
    assert tree_bytes(model.to(torch.bfloat16)) == jparams.count_params(jp) * 2


# ------------------------------------------------------------ masks, fbank


@pytest.mark.parametrize("size,chunk,left", [(10, 3, -1), (10, 3, 1), (16, 4, 0), (7, 8, 2)])
def test_chunk_masks_match_jax(size, chunk, left):
    np.testing.assert_array_equal(tmasks.subsequent_chunk_mask(size, chunk, left).numpy(),
                                  np.asarray(jmasks.subsequent_chunk_mask(size, chunk, left)))
    lens = np.array([size, size - 3, 1])
    pad = np.arange(size)[None, None, :] < lens[:, None, None]
    for c in (chunk, 0):
        np.testing.assert_array_equal(
            tmasks.add_optional_chunk_mask(torch.from_numpy(pad), c, left).numpy(),
            np.asarray(jmasks.add_optional_chunk_mask(jnp.asarray(pad), c, left)))


@pytest.mark.parametrize("kw", [{}, {"sample_rate": 8000, "num_mel_bins": 40},
                                {"frame_length": 50.0, "frame_shift": 12.5}])
def test_fbank_batch_matches_jax(kw):
    rng = np.random.default_rng(5)
    lengths = np.array([16000, 9000, 399, 12345], np.int32)
    waves = np.zeros((4, 16000), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = rng.normal(size=n) * 2000
    feats, frames = fbank_batch(torch.from_numpy(waves), torch.from_numpy(lengths), **kw)
    jfeats, jframes = jax_fbank_batch(jnp.asarray(waves), jnp.asarray(lengths), **kw)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    assert feats.shape == jfeats.shape and feats.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-3, rtol=1e-3)
