"""The port's decode slice against the JAX package, end to end on the CPU.

A random tiny JAX model is exported with ``chunkformer_tpu.export`` and loaded
by both packages' ``from_pretrained``; synthetic WAVs go through
``endless_decode`` (several macro-segments) and ``batch_decode``. At f32 the
port must give identical frame tokens, text and timestamps. Also: the
in-memory weight carry equals the export, the port imports nothing of JAX,
and the entry points never drift to the CPU.
"""

import ast
import contextlib
import glob
import os
import re

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.export import export_model_dir
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu_torch.api import ChunkFormerModel, endless_sizing
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import load_state_dict, state_dict_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "model": "asr_model",
    "encoder": "chunkformer",
    "encoder_conf": {
        "output_size": 64, "attention_heads": 4, "linear_units": 128,
        "num_blocks": 2, "cnn_module_kernel": 15, "cnn_module_norm": "layer_norm",
        "dropout_rate": 0.0, "positional_dropout_rate": 0.0,
        "attention_dropout_rate": 0.0,
    },
    "ctc_conf": {"ctc_blank_id": 0},
    "output_dim": 64,
    "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                                    "frame_length": 25, "dither": 0.0}},
}
C, L, R = 8, 16, 16
BUDGET = 4  # seconds: 1.92 s steps with 2.56 s lookahead -> 5 segments over 10 s


def _speechlike(rng, seconds, sr=16000):
    t = np.arange(int(seconds * sr)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t) ** 2
    tones = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) for f in rng.uniform(120, 3000, 5))
    x = env * tones * 3000 + rng.normal(scale=800, size=t.shape)
    return np.clip(x, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_port")
    cfg = JaxConfig.from_dict(TINY)
    rng = np.random.default_rng(0)
    cmvn = (rng.normal(10.0, 1.0, 80).astype(np.float32),
            rng.uniform(0.2, 0.5, 80).astype(np.float32))
    params = jax.tree.map(np.asarray, init_asr_model(jax.random.PRNGKey(0), cfg, cmvn))
    table = {"<blank>": 0, **{f"t{i}▁" if i % 5 == 0 else f"t{i}": i for i in range(1, 64)}}
    model_dir = export_model_dir(str(root / "export"), TINY, params, table)
    wavs = []
    for i, seconds in enumerate((10.0, 3.3, 6.1)):
        path = str(root / f"a{i}.wav")
        wavfile.write(path, 16000, _speechlike(rng, seconds))
        wavs.append(path)
    return model_dir, params, wavs


@pytest.fixture(scope="module")
def models(export):
    model_dir, _, _ = export
    return (JaxModel.from_pretrained(model_dir),
            ChunkFormerModel.from_pretrained(model_dir, device="cpu"))


@contextlib.contextmanager
def _no_vocab(*models):
    """Without a vocabulary both packages return frame-level CTC tokens."""
    saved = [m.char_dict for m in models]
    for m in models:
        m.char_dict = None
    try:
        yield
    finally:
        for m, cd in zip(models, saved):
            m.char_dict = cd


def test_endless_decode_matches_jax(export, models):
    """>= 3 macro-segments; identical timestamped text and frame tokens at f32."""
    _, _, wavs = export
    jm, tm = models
    trunc, rel_right, step_raw, *_ = endless_sizing(tm.config.encoder_conf, C, R, BUDGET)
    n_frames = tm.extract_features(wavs[0]).shape[0]
    assert -(-(n_frames - rel_right) // step_raw) + 1 >= 3
    kw = dict(chunk_size=C, left_context_size=L, right_context_size=R,
              total_batch_duration=BUDGET)
    want = jm.endless_decode(wavs[0], **kw)
    assert want and tm.endless_decode(wavs[0], **kw) == want
    with _no_vocab(jm, tm):
        want_tokens = jm.endless_decode(wavs[0], **kw)
        got_tokens = tm.endless_decode(wavs[0], **kw)
    np.testing.assert_array_equal(got_tokens, want_tokens)


def test_batch_decode_matches_jax(export, models):
    """Mixed-length files in one masked batch; identical text and frame tokens."""
    _, _, wavs = export
    jm, tm = models
    kw = dict(chunk_size=C, left_context_size=L, right_context_size=R)
    want = jm.batch_decode(wavs, **kw)
    assert len(want) == 3 and tm.batch_decode(wavs, **kw) == want
    with _no_vocab(jm, tm):
        want_tokens = jm.batch_decode(wavs, **kw)
        got_tokens = tm.batch_decode(wavs, **kw)
    for got, ref in zip(got_tokens, want_tokens, strict=True):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_endless_equals_batch_on_one_file(export, models):
    """Segmented decode with carried caches == single-shot masked batch."""
    _, _, wavs = export
    _, tm = models
    kw = dict(chunk_size=C, left_context_size=L, right_context_size=R)
    with _no_vocab(tm):
        endless = tm.endless_decode(wavs[0], total_batch_duration=BUDGET, **kw)
        single = tm.batch_decode(wavs[:1], **kw)[0]
    np.testing.assert_array_equal(endless, single)


def test_weight_carry_equals_export(export):
    model_dir, params, _ = export
    carried = state_dict_from_jax_params(params, ChunkFormerConfig.from_dict(TINY))
    exported = load_state_dict(os.path.join(model_dir, "pytorch_model.bin"))
    assert carried.keys() == exported.keys()
    for k, v in exported.items():
        assert torch.equal(carried[k], v), k


def test_entry_points_default_to_cuda(export, monkeypatch):
    """No card and no device="cpu": the constructor raises instead of using the CPU."""
    model_dir, _, _ = export
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChunkFormerModel.from_pretrained(model_dir)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    """The package, chip_smoke.py, bench_torch.py, the tool twins and the
    app twins import nothing of JAX or the JAX package; the recipe twins
    name no module of the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py")]
    for top_dir in ("chunkformer_tpu_torch", os.path.join("apps", "realtime-asr-torch"),
                    os.path.join("apps", "streamlit_torch")):
        for root, _, names in os.walk(os.path.join(REPO, top_dir)):
            files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    tools = glob.glob(os.path.join(REPO, "tools", "*_torch_*.py"))
    assert len(tools) >= 15 and len(files) > 10
    for path in files + tools:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "chunkformer_tpu", "flax", "optax"), (path, mod)
    recipes = glob.glob(os.path.join(REPO, "examples", "**", "run_torch.sh"), recursive=True)
    assert len(recipes) == 3
    for path in recipes:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert "chunkformer_tpu_torch." in text, path
        assert not re.search(r"\bchunkformer_tpu\.", text), path
        assert not re.search(r"\bjax\b", text), path
