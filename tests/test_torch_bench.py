"""``bench_torch.py``, the port's benchmark, against ``bench.py`` and the JAX
package on the CPU, at a tiny size: 2 blocks, 64 d, 4 heads, FFN 128,
vocabulary 64, (c, L, R) = (8, 16, 16), a 4 s budget (7 chunk rows a
macro-segment); the train model adds a bitransformer decoder 1 + 1.

- The FLOP counts equal ``bench.py``'s exactly (``==``), at the flagship
  decode and train configurations and at the tiny ones.
- The weights at seeds 0 and 1 equal the JAX bench's
  ``random_params_like(lambda k: init_asr_model(k, cfg), seed)`` after
  ``convert.state_dict_from_jax_params``, bit for bit.
- In f32, stage 1's tokens equal ``chunkformer_tpu``'s
  ``endless_encode_tokens`` on the same features; stage 2's tokens and
  carried caches (two calls chained) equal ``chunkformer_tpu/api.py``'s
  ``_endless_scan_fn`` on the same int8 buffer, on its XLA path (the JAX
  package's CPU default) and on its Pallas kernel in interpret mode: tokens
  identical, caches atol 1e-5.
- Stage 3's first-step loss equals the JAX ``make_train_step``'s at the
  same configuration, seeds and batch, at dropout 0 with the Pallas
  training attention in interpret mode, rtol 1e-5 (the conventions of
  ``tests/test_torch_train.py``).
- ``run(device="cpu", peak_tflops=...)`` prints three milestone lines, each
  extending the one before; ``run()`` with no card raises, and so does a
  card the peak table does not hold.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
import chunkformer_tpu.api as jax_api
from chunkformer_tpu.api import ChunkFormerModel as JaxModel
from chunkformer_tpu.config import ChunkFormerConfig as JaxConfig
from chunkformer_tpu.models.asr import init_asr_model
from chunkformer_tpu.nn.encoder import init_caches as jax_init_caches
from chunkformer_tpu.train.optim import build_optimizer as jax_build_optimizer
from chunkformer_tpu.train.train_step import create_train_state
from chunkformer_tpu.train.train_step import make_train_step as jax_make_train_step
from chunkformer_tpu.utils.params import random_params_like as jax_random_params_like
from chunkformer_tpu_torch.api import ChunkFormerModel
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.convert import state_dict_from_jax_params

CHUNK = (8, 16, 16)
BUDGET = 4
AUDIO_SECONDS = 12.0
TRAIN_SHAPE = (2, 160, 6)
ENC = {"output_size": 64, "attention_heads": 4, "linear_units": 128, "num_blocks": 2,
       "cnn_module_kernel": 15, "cnn_module_norm": "layer_norm", "dynamic_conv": True}
TINY_DECODE = {**bench_torch.DECODE, "encoder_conf": ENC, "output_dim": 64}
TINY_TRAIN = {**bench_torch.TRAIN,
              "encoder_conf": {**ENC, "gradient_checkpointing": True, "remat_policy": "dots"},
              "decoder_conf": {"attention_heads": 4, "linear_units": 128, "num_blocks": 1,
                               "r_num_blocks": 1},
              "output_dim": 64}


def _no_dropout(d):
    return {**d, "encoder_conf": {**d["encoder_conf"], "dropout_rate": 0.0,
                                  "positional_dropout_rate": 0.0,
                                  "attention_dropout_rate": 0.0},
            "decoder_conf": {**d["decoder_conf"], "dropout_rate": 0.0,
                             "positional_dropout_rate": 0.0}}


def _jax_params(d, seed):
    """The JAX bench's weights for ``d`` at ``seed`` (bench.py:147, 229)."""
    cfg = JaxConfig.from_dict(d)
    return jax.tree.map(np.asarray, jax_random_params_like(
        lambda k: init_asr_model(k, cfg), seed=seed))


@pytest.mark.parametrize("name,d,chunk", [
    ("flagship decode", bench_torch.DECODE, bench_torch.CHUNK),
    ("flagship train", bench_torch.TRAIN, bench_torch.CHUNK),
    ("tiny decode", TINY_DECODE, CHUNK), ("tiny train", TINY_TRAIN, CHUNK)])
def test_flop_counts_equal_bench_py(name, d, chunk):
    jcfg, cfg = JaxConfig.from_dict(d), ChunkFormerConfig.from_dict(d)
    got = bench_torch.encoder_flops_per_audio_second(cfg, *chunk, cfg.vocab_size)
    assert got > 0 and got == bench.encoder_flops_per_audio_second(jcfg, *chunk,
                                                                   jcfg.vocab_size)
    if d.get("decoder"):
        b, t, u = bench_torch.TRAIN_SHAPE
        enc_t = int(bench_torch.chunk_ops.calc_length(t))
        got = bench_torch.decoder_flops_per_step(cfg, b, u + 1, enc_t)
        assert got > 0 and got == bench.decoder_flops_per_step(jcfg, b, u + 1, enc_t)


@pytest.mark.parametrize("d,seed", [(TINY_DECODE, 0), (TINY_TRAIN, 1)])
def test_weights_equal_the_jax_bench(d, seed):
    cfg, model = bench_torch.random_model(d, seed)
    want = state_dict_from_jax_params(_jax_params(d, seed), cfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def decode_pair():
    """The tiny decode model in f32 in both packages, the JAX bench's weights."""
    cfg, net = bench_torch.random_model(TINY_DECODE, 0)
    model = ChunkFormerModel(cfg, net.state_dict(), dtype=torch.float32, device="cpu")
    feats = bench_torch.decode_features(AUDIO_SECONDS)
    return cfg, model, feats


def test_end_to_end_tokens_equal_jax(decode_pair):
    cfg, model, feats = decode_pair
    tokens, seconds = bench_torch.end_to_end(model, feats, CHUNK, BUDGET, reps=1)
    jm = JaxModel(JaxConfig.from_dict(TINY_DECODE), _jax_params(TINY_DECODE, 0), None,
                  jnp.float32)
    want = jm.endless_encode_tokens(feats, *CHUNK, total_batch_duration=BUDGET)
    assert len(seconds) == 1 and tokens.shape[0] > 0
    np.testing.assert_array_equal(tokens, want)


def test_profile_dir_writes_a_trace(decode_pair, tmp_path, capsys):
    _, model, feats = decode_pair
    bench_torch.end_to_end(model, feats, CHUNK, BUDGET, reps=1, profile_dir=str(tmp_path))
    with open(tmp_path / "bench_torch_e2e.json") as f:
        assert json.load(f)["traceEvents"]
    assert "busy share" in capsys.readouterr().err


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_device_walk_equals_the_jax_scan(decode_pair, path, monkeypatch):
    """Two device-walk calls chained through the caches, against two calls
    of the JAX scan program on the same int8 buffer at the same capacity."""
    cfg, model, feats = decode_pair
    buf, sizing = bench_torch.device_buffer(feats, cfg.encoder_conf, CHUNK, BUDGET)
    trunc, rel_right, step_raw, _, capacity = sizing
    assert buf.dtype == np.int8 and buf.shape[0] > step_raw + rel_right  # neither is last

    jm = JaxModel(JaxConfig.from_dict(TINY_DECODE), _jax_params(TINY_DECODE, 0), None,
                  jnp.float32)
    if path == "pallas":
        monkeypatch.setattr(jm, "_pallas_ok", lambda c: True)
        monkeypatch.setattr(jax_api, "encoder_parallel_chunk", functools.partial(
            jax_api.encoder_parallel_chunk, pallas_interpret=True))
    run = jm._endless_scan_fn(*CHUNK, capacity, trunc, rel_right,
                              bench_torch.DEVICE_SEGMENTS, mode="tokens")
    jatt, jcnn = jax_init_caches(jm.config.encoder_conf, CHUNK[1], dtype=jnp.float32)

    buf_t = torch.from_numpy(buf)
    att, cnn = model.model.encoder.init_caches(CHUNK[1], torch.float32, model.device)
    chunk_idx = model._meta(np.arange(capacity))
    for _ in range(2):
        tokens, att, cnn = bench_torch.device_call(model, buf_t, sizing, CHUNK, chunk_idx,
                                                   att, cnn)
        ys, keeps, jatt, jcnn, _, _ = run(
            jm.params, jnp.asarray(buf), jnp.asarray(bench_torch.DEVICE_SCALE, jnp.float32),
            jnp.asarray(buf.shape[0], jnp.int32), jatt, jcnn, jnp.asarray(0, jnp.int32),
            jnp.zeros((), jnp.int32))
        keeps = np.asarray(keeps)
        assert [t.shape[0] for t in tokens] == list(keeps) == [trunc, trunc]
        for got, want, keep in zip(tokens, np.asarray(ys), keeps):
            np.testing.assert_array_equal(got.numpy(), want[:keep])
        np.testing.assert_allclose(att.numpy(), np.asarray(jatt), atol=1e-5, rtol=0)
        np.testing.assert_allclose(cnn.numpy(), np.asarray(jcnn), atol=1e-5, rtol=0)
    assert np.abs(att.numpy()).max() > 0 and np.abs(cnn.numpy()).max() > 0


def test_train_stage_first_loss_equals_jax():
    d = _no_dropout(TINY_TRAIN)
    cfg, losses, seconds = bench_torch.train_stage(d, torch.device("cpu"), torch.float32,
                                                   CHUNK, steps=0, shape=TRAIN_SHAPE)
    assert len(losses) == 1 and seconds == []

    jcfg = JaxConfig.from_dict({**d, "encoder_conf": {**d["encoder_conf"],
                                                      "use_pallas_train": True,
                                                      "pallas_interpret": True}})
    params = _jax_params(d, 1)
    opt, _ = jax_build_optimizer("adamw", {"lr": 1e-3}, "warmuplr", {"warmup_steps": 25000})
    step = jax.jit(jax_make_train_step(jcfg, opt, chunk_cfg=CHUNK))
    feats, lens, targets, tlens = bench_torch.train_batch(cfg.vocab_size, TRAIN_SHAPE)
    _, metrics = step(create_train_state(params, opt), jnp.asarray(feats), jnp.asarray(lens),
                      jnp.asarray(targets, jnp.int32), jnp.asarray(tlens),
                      jax.random.PRNGKey(0))
    np.testing.assert_allclose(losses[0], float(metrics["loss"]), rtol=1e-5)


def test_run_prints_three_milestone_lines(capsys):
    torch.set_num_threads(1)
    result = bench_torch.run(
        device="cpu", dtype=torch.bfloat16, decode_conf=TINY_DECODE, train_conf=TINY_TRAIN,
        audio_seconds=AUDIO_SECONDS, budget=BUDGET, chunk=CHUNK, reps=2, device_reps=2,
        train_steps=2, train_shape=TRAIN_SHAPE, peak_tflops=1.0)
    captured = capsys.readouterr()
    lines = [json.loads(line) for line in captured.out.splitlines()]
    assert len(lines) == 3 and lines[-1] == result
    for before, after in zip(lines, lines[1:]):
        assert len(after) > len(before)
        assert {k: after[k] for k in before} == before
    first = lines[0]
    assert first["metric"] == "audio_seconds_per_second" and first["unit"] == "audio-s/s"
    assert first["device_kind"] == "cpu" and first["power_limit_w"] is None
    assert first["value_min"] <= first["value"] <= first["value_max"]
    assert result["device_step_audio_s_per_s_min"] <= result["device_step_audio_s_per_s"] \
        <= result["device_step_audio_s_per_s_max"]
    assert result["train_audio_s_per_s_min"] <= result["train_audio_s_per_s"] \
        <= result["train_audio_s_per_s_max"]
    assert 0 < result["mfu"] <= 1 and 0 < result["train_mfu"] <= 1
    assert np.isfinite(result["train_loss"])
    stages = [json.loads(line.split(bench_torch.LAUNCHES, 1)[1])
              for line in captured.err.splitlines() if bench_torch.LAUNCHES in line]
    assert [(s["stage"], s["calls"]) for s in stages] == [("e2e", 3), ("device", 3),
                                                          ("train", 3)]


def test_run_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run()
    with pytest.raises(ValueError, match="no dense bf16 peak"):
        bench_torch.run(device="cpu")  # no peak for "cpu" and none given
    with pytest.raises(ValueError, match="no dense bf16 peak"):
        bench_torch.peak_bf16_tflops("NVIDIA A100-SXM4-80GB")
    assert bench_torch.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert capsys.readouterr().out == ""
