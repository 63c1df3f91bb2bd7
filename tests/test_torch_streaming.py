"""The port's streaming path against the JAX package on the CPU: the conv and
attention streaming steps, ``streaming_step`` over consecutive steps (outputs
and both caches, at R = 0 and R > 0, from the first steps where the cache
holds less than L frames of history), the R = 0 identity with the
limited-context ``encode``, ``StreamingASR``, the stream CLI,
``recognize --simulate_streaming`` and the capture layer.

A random tiny hybrid CTC/AED JAX model (2 layers, 64 d, 4 heads,
``dynamic_conv``, a 1 + 1-block decoder) is exported with
``chunkformer_tpu.export`` and loaded by both packages' ``from_pretrained``;
the single-step tests hand the JAX functions that model's parameters. Step
outputs and caches are held at f32 atol 1e-5 (single modules) and 1e-4 (the
encoder), tokens, text and result files exactly. The encoder's biases are
zero, so the random model's frame tokens vary with the audio.
"""

import os
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.bin import recognize as jax_recognize
from chunkformer_tpu.bin import stream as jax_stream
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.data import capture as jax_capture
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.nn.attention import attention_streaming
from chunkformer_tpu.nn.convolution import conv_streaming
from chunkformer_tpu.nn.encoder import encoder_streaming_step
from chunkformer_tpu.nn.encoder import init_caches as jax_init_caches
from chunkformer_tpu.ops.chunk import reverse_calc_length as jax_reverse_calc_length
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.bin import recognize, stream
from chunkformer_tpu_torch.data import capture
from chunkformer_tpu_torch.nn.embedding import rel_pos_slice
from chunkformer_tpu_torch.ops.chunk import reverse_calc_length

from .test_torch_api import _speechlike
from .test_torch_search import HYBRID

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STREAM = {**HYBRID, "encoder_conf": {**HYBRID["encoder_conf"], "dynamic_conv": True}}
SYMBOLS = string.ascii_lowercase + string.ascii_uppercase + string.digits + "▁"
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "ctc_prefix_beam_search_batched",
         "attention", "attention_rescoring"]
CONTEXTS = [(4, 8, 0), (4, 8, 4), (6, 10, 2)]   # L = 10 is no multiple of c = 6


def _zero_biases(tree):
    return {k: (_zero_biases(v) if isinstance(v, dict)
                else np.zeros_like(v) if k in ("b", "bias") else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The export, its JAX parameters, both packages' models, four WAVs of
    1.3-3.1 s and a test list."""
    root = tmp_path_factory.mktemp("torch_streaming")
    rng = np.random.default_rng(12)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(12),
                                                     JaxConfig.from_dict(STREAM), cmvn))
    # without its biases the random encoder's output moves with the audio,
    # so the frame tokens vary (with them one token wins every frame)
    params["encoder"] = _zero_biases(params["encoder"])
    table = {"<blank>": 0, **{ch: i + 1 for i, ch in enumerate(SYMBOLS)}}
    model_dir = export_model_dir(str(root / "export"), STREAM, params, table)
    rows, wavs = [], []
    for i, seconds in enumerate((3.1, 1.3, 2.2, 1.7)):
        path = str(root / f"u{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        wavs.append(path)
        rows.append(f"utt{i}\t{path}\tab c{i}")
    test_list = root / "test.list"
    test_list.write_text("\n".join(rows) + "\n", encoding="utf-8")
    return dict(root=root, model_dir=model_dir, params=params, wavs=wavs,
                test_list=str(test_list), jm=JaxModel.from_pretrained(model_dir),
                tm=ChunkFormerModel.from_pretrained(model_dir, device="cpu"))


def _layer(params, i=0):
    return jax.tree.map(lambda a: a[i], params["encoder"]["layers"])


@pytest.mark.parametrize("c,right", [(4, 0), (4, 4), (6, 2)])
def test_conv_streaming_matches_jax(setup, c, right):
    """One conv step on the same cache and input: the output and the whole
    [B, D, lorder + T] stream, f32 atol 1e-5."""
    tm = setup["tm"]
    module = tm.model.encoder.encoders[0].conv_module
    rng = np.random.default_rng(c + right)
    x = rng.normal(size=(2, c + right, 64)).astype(np.float32)
    cache = rng.normal(size=(2, 64, module.lorder)).astype(np.float32)
    want_y, want_stream = conv_streaming(_layer(setup["params"])["conv"], jnp.asarray(x),
                                         jnp.asarray(cache), c, 15, True)
    with torch.inference_mode():
        y, stream_ = module.streaming(torch.from_numpy(x), torch.from_numpy(cache), c)
    assert y.shape == want_y.shape and stream_.shape == want_stream.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(stream_.numpy(), np.asarray(want_stream), atol=1e-5, rtol=0)


@pytest.mark.parametrize("offset", [0, 4, 12])
def test_attention_streaming_matches_jax(setup, offset):
    """One attention step of c + R = 6 queries over an L = 10 cache, with
    the offset mask (offset < L hides the empty cache rows): the output and
    the [B, L + T1, H, 2dk] key/value stream, f32 atol 1e-5."""
    tm = setup["tm"]
    c, left, right = 4, 10, 2
    module = tm.model.encoder.encoders[1].self_attn
    rng = np.random.default_rng(offset)
    x = rng.normal(size=(2, c + right, 64)).astype(np.float32)
    cache = rng.normal(size=(2, left, 4, 32)).astype(np.float32)
    pos = rel_pos_slice(64, c + right, left, 0)
    mask = np.broadcast_to(np.arange(left + c + right) >= left - offset,
                           (2, 1, left + c + right)).copy()
    want, want_kv = attention_streaming(_layer(setup["params"], 1)["self_attn"],
                                        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask),
                                        jnp.asarray(cache), 4)
    with torch.inference_mode():
        got, kv = module.streaming(torch.from_numpy(x), torch.from_numpy(pos),
                                   torch.from_numpy(mask), torch.from_numpy(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(kv.numpy(), np.asarray(want_kv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ctx", CONTEXTS)
def test_streaming_step_matches_jax(setup, ctx):
    """Seven consecutive steps of a batch of 2 from zero caches (the first
    steps have offset < L): outputs [B, c + R, D] and both caches after
    every step, f32 atol 1e-4."""
    c, left, right = ctx
    tm, cfg = setup["tm"], JaxConfig.from_dict(STREAM).encoder_conf
    frames_in = reverse_calc_length(c) + 8 * right
    assert frames_in == jax_reverse_calc_length(c) + 8 * right
    rng = np.random.default_rng(sum(ctx))
    ja, jc = jax_init_caches(cfg, left, batch=2)
    ta, tc = tm.model.encoder.init_caches(left, torch.float32, torch.device("cpu"), batch=2)
    assert ta.shape == ja.shape and tc.shape == jc.shape
    for s in range(7):
        x = rng.normal(10.0, 2.0, size=(2, frames_in, 80)).astype(np.float32)
        want, ja, jc = encoder_streaming_step(setup["params"]["encoder"], cfg, jnp.asarray(x),
                                              ja, jc, c, left, right, jnp.asarray(s * c))
        with torch.inference_mode():
            got, ta, tc = tm.model.encoder.streaming_step(torch.from_numpy(x), ta, tc, c, left,
                                                          right, s * c)
        assert got.shape == (2, c + right, 64)
        for a, b in ((got, want), (ta, ja), (tc, jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("c,left", [(4, 8), (6, 10)])
def test_streaming_equals_encode_at_r0(setup, c, left):
    """tests/test_encoder_modes.py:127 on the port: at R = 0 the streamed
    outputs equal the limited-context ``encode`` at (c, L, 0), atol 2e-4."""
    tm = setup["tm"]
    feats = np.random.default_rng(c).normal(10.0, 2.0, size=(300, 80)).astype(np.float32)
    size, stride = reverse_calc_length(c), 8 * c
    pad = (stride - ((len(feats) - size) % stride)) % stride
    x = torch.from_numpy(np.pad(feats, ((0, pad), (0, 0))))
    att, cnn = tm.model.encoder.init_caches(left, torch.float32, torch.device("cpu"), batch=1)
    outs = []
    with torch.inference_mode():
        for s, i in enumerate(range(0, x.shape[0] - size + stride, stride)):
            out, att, cnn = tm.model.encoder.streaming_step(x[None, i:i + size], att, cnn, c,
                                                            left, 0, s * c)
            outs.append(out[0])
    streamed = torch.cat(outs).numpy()
    enc, enc_len = tm.encode(x[None], [x.shape[0]], c, left, 0)
    n = min(streamed.shape[0], int(enc_len[0]))
    assert n >= 30
    np.testing.assert_allclose(streamed[:n], enc[0, :n].numpy(), atol=2e-4, rtol=0)


def test_streaming_asr_matches_jax(setup):
    """``StreamingASR.accept_audio`` on a WAV fed in uneven pieces: the new
    tokens of every call, all tokens and the text equal JAX's."""
    sr, wav = wavfile.read(setup["wavs"][0])
    wav = wav.astype(np.float32)
    jasr = jax_stream.StreamingASR(setup["jm"], 6, 10, 2)
    tasr = stream.StreamingASR(setup["tm"], 6, 10, 2)
    cuts = [0, 1000, 9000, 9333, 21000, 30000, 41000, len(wav)]
    for a, b in zip(cuts, cuts[1:]):
        assert tasr.accept_audio(wav[a:b]) == jasr.accept_audio(wav[a:b])
    assert len(tasr.tokens) == 30 and len(set(tasr.tokens)) > 1 and tasr.tokens == jasr.tokens
    assert len(tasr.step_seconds) * 6 == len(tasr.tokens)
    assert tasr.text() == jasr.text()


def test_stream_cli_prints_the_jax_final_line(setup, capsys):
    """``bin/stream.main`` at its defaults (c = 6, L = 50, R = 0) on a file:
    its ``final:`` line equals the JAX CLI's."""
    argv = ["--model_checkpoint", setup["model_dir"], "--audio_file", setup["wavs"][0]]
    assert jax_stream.main(argv) == 0
    want = [x for x in capsys.readouterr().out.splitlines() if x.startswith("final:")]
    assert stream.main([*argv, "--device", "cpu"]) == 0
    got = [x for x in capsys.readouterr().out.splitlines() if x.startswith("final:")]
    assert len(want) == 1 and len(want[0]) > len("final: ") and got == want


def test_stream_cli_without_a_source_or_backend(setup, capsys):
    """No source, and ``--mic`` with neither capture backend installed: exit
    2 with the JAX CLI's messages; ``--list_devices`` lists none."""
    base = ["--model_checkpoint", setup["model_dir"]]
    for argv in ([], ["--mic"]):
        assert jax_stream.main([*base, *argv]) == 2
        want = capsys.readouterr().err
        assert stream.main([*base, *argv, "--device", "cpu"]) == 2
        assert capsys.readouterr().err == want and want
    assert stream.main([*base, "--list_devices"]) == 0
    assert capsys.readouterr().out == "no input devices (or no capture backend installed)\n"


def _files(d):
    return {name: open(os.path.join(d, name), encoding="utf-8").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("ctx", [(8, 16, 0), (6, 10, 2)])
def test_recognize_simulate_streaming_writes_the_jax_result_files(setup, ctx):
    """All five CTC/AED modes over the streaming encode, beam 4, batch 3
    (two batches, padded): result files byte for byte equal to the JAX
    CLI's."""
    root = setup["root"]
    tag = "_".join(map(str, ctx))
    argv = ["--model_checkpoint", setup["model_dir"], "--test_data", setup["test_list"],
            "--modes", *MODES, "--beam_size", "4", "--batch_size", "3",
            "--reverse_weight", "0.3", "--simulate_streaming",
            "--chunk_size", str(ctx[0]), "--left_context_size", str(ctx[1]),
            "--right_context_size", str(ctx[2])]
    want_dir, got_dir = str(root / f"jax_sim_{tag}"), str(root / f"torch_sim_{tag}")
    assert jax_recognize.main([*argv, "--result_dir", want_dir]) == 0
    assert recognize.main([*argv, "--result_dir", got_dir, "--device", "cpu"]) == 0
    want = _files(want_dir)
    assert sorted(want) == sorted(f"{m}.{e}" for m in MODES for e in ("txt", "wer"))
    assert _files(got_dir) == want


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_file_simulator_matches_jax(setup, sample_rate):
    """``FileSimulator`` at speed 0: fixed-size chunks but the last, the
    same samples as JAX's (the linear resample at 8 kHz too), and
    ``audio_seconds``."""
    path = setup["wavs"][1]
    with capture.open_capture(path, sample_rate, chunk_samples=4000, speed=0.0) as cap:
        got = list(cap)
    with jax_capture.open_capture(path, sample_rate, chunk_samples=4000, speed=0.0) as ref:
        want = list(ref)
    assert isinstance(cap, capture.FileSimulator) and capture.AudioFileSimulator is \
        capture.FileSimulator
    assert len(got) == len(want) >= 3 and all(len(x) == 4000 for x in got[:-1])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert cap.audio_seconds == ref.audio_seconds == sum(map(len, got)) / sample_rate


def test_queue_capture_drops_the_oldest_chunk():
    """The bounded queue keeps the newest chunks; the mic needs a backend."""
    cap = capture._QueueCapture(chunk_samples=100, max_buffer_chunks=2)
    cap._running = True
    cap._push(np.arange(250, dtype=np.float32))
    assert cap.buffered_chunks() == 2 and cap.dropped_chunks == 0
    cap._push(np.arange(150, dtype=np.float32))   # two more chunks: the two oldest go
    assert cap.buffered_chunks() == 2 and cap.dropped_chunks == 2
    first = cap.read_chunk(timeout=0.1)
    np.testing.assert_array_equal(first, np.r_[np.arange(200, 250), np.arange(0, 50)])
    assert capture.list_input_devices() == []
    with pytest.raises(RuntimeError, match="sounddevice or pyaudio"):
        capture.open_capture("mic")
