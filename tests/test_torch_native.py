"""The port's native host library (``chunkformer_tpu_torch/native``) against
the JAX package's (``chunkformer_tpu.native``), and the int8 feature
transfer of the long-form paths (C15) against the JAX package's default.

The two libraries are built from two copies of one source with the same
g++ flags, so every float result is compared bit for bit: fbank at dither
0 and 1.0 (one seed) with each window type, short and empty waves, thread
counts (without dither the result does not depend on them),
``resample_linear``, ``quantize_int8`` (int8 and scale). The numpy
twin stays within 2e-3 of the native fbank (``tests/test_native.py``'s
bar). C15: the bf16 dequantized features equal JAX's (``api.py:411``) bit
for bit; bf16 encoder outputs within 0.1 of JAX's bf16 path (bf16 rounding
of two implementations through two random layers); tokens with int8
forced in f32 identical to JAX under ``CHUNKFORMER_TRANSFER=int8``; host
and device features give the same tokens.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu import native as jnative
from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu_torch import native
from chunkformer_tpu_torch.api import (ChunkFormerModel, FeatureUpload, dequantize,
                                       quantize_int8, quantize_int8_tensor)
from chunkformer_tpu_torch.data.processor import compute_fbank_numpy
from chunkformer_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX library loads (its first load may meet another worker's build
    of the same file mid-write, ROADMAP C3: retry)."""
    for _ in range(40):
        if jnative.load() is not None:
            return
        jnative._tried = False
        time.sleep(0.25)
    pytest.fail("the JAX package's native library did not load")


def _wave(n, seed=0, scale=3000.0):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(np.float32)


@pytest.mark.parametrize("window", ["povey", "hanning", "hamming", "rectangular", "blackman"])
@pytest.mark.parametrize("dither", [0.0, 1.0])
def test_fbank_equals_the_jax_library(window, dither):
    wave = _wave(16000 * 3 + 123, seed=1)
    got = native.fbank(wave, dither=dither, window_type=window, seed=1234)
    want = jnative.fbank(wave, dither=dither, window_type=window, seed=1234)
    assert got.shape == want.shape == (299, 80)
    np.testing.assert_array_equal(got, want)


def test_fbank_short_empty_and_threads():
    assert native.fbank(_wave(0)).shape == (0, 80)
    assert native.fbank(_wave(100)).shape == (0, 80)
    one = native.fbank(_wave(400))
    assert one.shape == (1, 80)
    np.testing.assert_array_equal(one, jnative.fbank(_wave(400)))
    wave = _wave(16000 * 30, seed=2)
    a = native.fbank(wave, n_threads=1)
    for threads in (2, 4, 0):
        np.testing.assert_array_equal(native.fbank(wave, n_threads=threads), a)
    # with dither the library's stream follows its split of the frames
    # among threads, so the two libraries are compared at one count
    for threads in (1, 3):
        np.testing.assert_array_equal(
            native.fbank(wave, dither=1.0, seed=7, n_threads=threads),
            jnative.fbank(wave, dither=1.0, seed=7, n_threads=threads))
    with pytest.raises(ValueError, match="window"):
        native.fbank(wave, window_type="kaiser")


def test_numpy_twin_within_2e3_of_the_native_fbank():
    wave = _wave(16000 * 5)
    np.testing.assert_allclose(native.fbank(wave), compute_fbank_numpy(wave), atol=2e-3)


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000), (44100, 16000)])
def test_resample_linear_equals_the_jax_library(rates):
    from chunkformer_tpu_torch.data.audio import resample_linear

    x = np.sin(np.linspace(0, 100, 16001)).astype(np.float32) * 1000
    got = resample_linear(x, *rates)
    np.testing.assert_array_equal(got, jnative.resample_linear(x, *rates))
    assert got.shape == (int(16001 * rates[1] / rates[0]),)


def _features(seed=0, t=2000):
    """log-mel-like magnitudes with exact halves of the quantization step"""
    x = (np.random.default_rng(seed).normal(size=(t, 80)) * 4 + 12).astype(np.float32)
    x[0, 0] = -30.0
    scale = np.float32(30.0) / np.float32(127.0)
    x[1, :8] = (np.arange(8, dtype=np.float32) + np.float32(0.5)) * scale
    return x


@pytest.mark.parametrize("case", ["features", "zeros", "one_row"])
def test_quantize_int8_equals_the_jax_library(case):
    x = {"features": _features(), "zeros": np.zeros((7, 80), np.float32),
         "one_row": _features()[:1]}[case]
    q, scale = quantize_int8(x)
    jq, jscale = jnative.quantize_int8(x)
    assert q.dtype == np.int8 and scale == jscale
    np.testing.assert_array_equal(q, jq)
    # the PyTorch arithmetic (the path of features on a card) gives the same
    tq, tscale = quantize_int8_tensor(torch.from_numpy(x))
    assert tscale == scale
    np.testing.assert_array_equal(tq.numpy(), q)
    assert quantize_int8(torch.from_numpy(x))[1] == scale


def test_host_library_builds_race_free_and_raises_on_a_bad_source(tmp_path, monkeypatch):
    """Four processes build into one empty directory at once and each loads
    a whole library; a source g++ refuses raises with its log."""
    code = ("import sys; from chunkformer_tpu_torch.ops import kernels; "
            "kernels.BUILD_DIR = sys.argv[1]; from chunkformer_tpu_torch import native; "
            "import numpy as np; print(native.fbank(np.ones(16000, np.float32) * 100).shape)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "b")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all("(98, 80)" in o for o in outs), outs
    assert [f.name for f in (tmp_path / "b").iterdir()] == [
        os.path.basename(native.library_path())]
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( {")
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "c"))
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert list((tmp_path / "c").iterdir()) == []


# ------------------------------------------------------------------ C15

TINY = {
    "model": "asr_model", "encoder": "chunkformer",
    "encoder_conf": {"output_size": 64, "attention_heads": 4, "linear_units": 128,
                     "num_blocks": 2, "cnn_module_kernel": 15,
                     "cnn_module_norm": "layer_norm", "dropout_rate": 0.0,
                     "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0},
    "ctc_conf": {"ctc_blank_id": 0}, "output_dim": 64,
}
ARGS = (8, 16, 16, 4)  # c, L, R, a 4 s budget: several macro-segments over 20 s


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    root = tmp_path_factory.mktemp("c15")
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(3),
                                                     JaxConfig.from_dict(TINY)))
    table = {"<blank>": 0, **{f"t{i}": i for i in range(1, 64)}}
    return export_model_dir(str(root / "export"), TINY, params, table)


def test_bf16_dequantized_features_equal_jax(export):
    """The port's bf16 walk holds int8 and JAX's scale, and dequantizes to
    JAX's bf16 values bit for bit; its encoder outputs follow JAX's bf16
    default path (int8 transfer)."""
    feats = _features(1, 2003)
    upload = FeatureUpload(feats, 2100, "int8", torch.device("cpu"))
    q, scale = jnative.quantize_int8(feats)
    assert upload.buf.dtype == torch.int8 and upload.scale == scale
    assert not bool(upload.buf[2003:].any())
    got = dequantize(upload.buf[:2003], upload.scale, torch.bfloat16)
    want = np.asarray(jnp.asarray(q).astype(jnp.bfloat16)
                      * jnp.asarray(scale, jnp.float32).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))

    jm = JaxModel.from_pretrained(export, dtype=jnp.bfloat16)
    tm = ChunkFormerModel.from_pretrained(export, dtype=torch.bfloat16, device="cpu")
    enc = tm.endless_encode(feats, *ARGS)
    jenc = jm.endless_encode(feats, *ARGS)
    assert enc.shape == jenc.shape and enc.dtype == torch.float32
    np.testing.assert_allclose(enc.numpy(), jenc, atol=0.1, rtol=0)
    # the f32 transfer would have fed other inputs: the walk really took int8
    parts = tm._endless_segments(feats, *ARGS, lambda out, keep: out.reshape(-1, 64)[:keep],
                                 _transfer="f32")
    assert not torch.equal(torch.cat(parts).float(), enc)


def test_int8_forced_in_f32_tokens_equal_jax(export, monkeypatch):
    feats = _features(2, 2003)
    tm = ChunkFormerModel.from_pretrained(export, device="cpu")
    parts = tm._endless_segments(
        feats, *ARGS, lambda out, keep: tm.model.ctc.argmax(out).reshape(-1)[:keep],
        _transfer="int8")
    got = torch.cat(parts).numpy()
    monkeypatch.setenv("CHUNKFORMER_TRANSFER", "int8")
    want = JaxModel.from_pretrained(export).endless_encode_tokens(feats, *ARGS)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 200


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_and_device_features_give_the_same_tokens(export, dtype):
    """numpy, a CPU tensor and the model's own device (here the CPU) give
    one result, on every long-form entry."""
    feats = _features(3, 800)  # four macro-segments
    tm = ChunkFormerModel.from_pretrained(export, dtype=dtype, device="cpu")
    want = tm.endless_encode_tokens(torch.from_numpy(feats), *ARGS)
    np.testing.assert_array_equal(tm.endless_encode_tokens(feats, *ARGS), want)
    torch.testing.assert_close(tm.endless_encode(feats, *ARGS),
                               tm.endless_encode(torch.from_numpy(feats), *ARGS), atol=0, rtol=0)
