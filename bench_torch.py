#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: ChunkFormer-large inference and
training throughput on one NVIDIA card (counterpart of ``bench.py``).

    python3 bench_torch.py [--dtype bf16|f32] [--profile_dir DIR]

Prints milestone JSON lines to stdout (progress and the kernels' launch
counts go to stderr); each line is a complete, parseable result and
strictly extends the previous one, so a run cut short still records
whatever finished:
  1. {"metric": "audio_seconds_per_second", "value": N, ...}      (end to end)
  2. + {"device_step_audio_s_per_s": N, "mfu": N, ...}          (device walk)
  3. + {"train_audio_s_per_s": N, "train_mfu": N, "train_loss": N} (train step)

The inference workload is ``bench.py``'s: 1792 s of features (normal
draws from ``default_rng(0)``, 10 ms frames) streamed through
ChunkFormer-large (512 d, 8 heads, 17 blocks, vocabulary 6992; random
weights from ``utils/params.py:random_params_like`` at seed 0, the JAX
bench's draws) at (c, L, R) = (64, 128, 128) with an 1800 s budget: two
macro-segments of 209 chunk rows with carried caches, then the CTC argmax.

- value: audio-seconds per wall-second of ``endless_encode_tokens`` on the
  host features (the int8 quantize with one global scale in bf16, the
  pinned upload, the walk and the tokens' download), the median of the
  timed reps after one warm-up, with ``value_min`` and ``value_max``;
  ``vs_baseline`` divides it by 1000 audio-s/s as ``bench.py`` does.
- device_step_audio_s_per_s: the walk's segment code alone
  (``ChunkFormerModel._endless_segment`` and the CTC argmax of
  ``_ctc_tokens``, what ``endless_encode_tokens`` runs a segment) over two
  macro-segments of an int8 buffer already on the card (the features
  times 16, clipped, at scale 1/16), the caches chained from rep to rep;
  no quantize, upload or download on the timed path. Median, min, max.
- mfu: ``bench.py``'s analytic FLOPs an audio-second (matrix products and
  convolutions of the encoder and the CTC head) times the device rate,
  over the card's dense bf16 peak (``PEAK_BF16_TFLOPS``; an unknown card
  raises unless ``peak_tflops`` is given).
- train_audio_s_per_s / train_mfu / train_loss: the flagship hybrid
  CTC/AED step of ``bench.py:149-177`` (gradient checkpointing with
  "dots", bitransformer decoder 3 + 3, weights at seed 1, adamw at lr 1e-3
  with warmuplr over 25000 steps, bf16 autocast with f32 parameters,
  dropout on from a seeded CPU generator, chunks (64, 128, 128)) on 32 x
  1600 frames and 48 labels from ``default_rng(2)``; train_mfu counts 3 x
  the forward FLOPs; train_loss is the last timed step's.

Every stage times whole calls, with the card synchronized before each clock
read. Nothing falls back: with no card and no ``device="cpu"`` the run
raises, and a failing stage ends it with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from chunkformer_tpu_torch.api import ChunkFormerModel, endless_sizing, resolve_device
from chunkformer_tpu_torch.config import ChunkFormerConfig
from chunkformer_tpu_torch.models.asr import ASRModel
from chunkformer_tpu_torch.ops import chunk as chunk_ops
from chunkformer_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from chunkformer_tpu_torch.train.optim import build_optimizer
from chunkformer_tpu_torch.train.train_step import make_train_step
from chunkformer_tpu_torch.utils.params import random_params_like

BASELINE_AUDIO_SECONDS_PER_S = 1000.0

# dense bf16 tensor-core peak by torch.cuda.get_device_name(); TFLOP/s
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,  # H100 SXM
}

DECODE = {  # ChunkFormer-large, bench.py:220-229
    "model": "asr_model",
    "encoder_conf": {
        "output_size": 512, "attention_heads": 8, "linear_units": 2048,
        "num_blocks": 17, "cnn_module_kernel": 15,
        "cnn_module_norm": "layer_norm", "dynamic_conv": True,
    },
    "output_dim": 6992,
}
TRAIN = {  # the flagship hybrid CTC/AED train step, bench.py:149-165
    "model": "asr_model",
    "encoder_conf": {
        "output_size": 512, "attention_heads": 8, "linear_units": 2048,
        "num_blocks": 17, "cnn_module_kernel": 15,
        "cnn_module_norm": "layer_norm", "dynamic_conv": True,
        "gradient_checkpointing": True, "remat_policy": "dots",
    },
    "decoder": "bitransformer",
    "decoder_conf": {"attention_heads": 8, "linear_units": 2048,
                     "num_blocks": 3, "r_num_blocks": 3},
    "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3,
                   "lsm_weight": 0.1},
    "output_dim": 6992,
}
CHUNK = (64, 128, 128)
BUDGET = 1800            # total_batch_duration (s)
AUDIO_SECONDS = 1792.0   # two macro-segments of the 1800 s budget
DEVICE_SEGMENTS = 2      # macro-segments a device-walk call
DEVICE_SCALE = 1.0 / 16  # the device walk's int8 buffer holds clip(feats * 16)
TRAIN_SHAPE = (32, 1600, 48)  # utterances, frames, labels: 512 audio-s a step
LAUNCHES = "launches "   # stderr prefix of a stage's launch counts (a JSON object)

T0 = time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench_torch +{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def encoder_flops_per_audio_second(cfg, c: int, left: int, right: int,
                                   vocab: int) -> float:
    """Analytic FLOPs (2x MACs) per audio-second of the masked-batch encoder
    and the CTC head, ``bench.py``'s count: matrix products and convolutions
    only (norms and elementwise passes are bandwidth, not FLOPs).

    10 ms raw frames -> 12.5 subsampled frames per audio-second; chunked
    attention reads a KV window of W = L + c + R per chunk of c outputs.
    """
    enc = cfg.encoder_conf
    d, ff, k = enc.output_size, enc.linear_units, enc.cnn_module_kernel
    w = left + c + right
    pos_len = left + 2 * c + right  # rel-pos table slice per chunk
    fps = 12.5

    per_frame_layer = (
        2 * (2 * d * ff * 2)                 # two macaron FFNs, 2 linears each
        + 4 * 2 * d * d                      # q,k,v,out projections
        + 2 * d * d * (pos_len / c)          # pos projection, amortized per frame
        + 2 * 2 * d * w                      # score matmuls (AC + BD)
        + 2 * d * w                          # attention @ V
        + 2 * d * (2 * d)                    # conv pointwise 1 (D -> 2D, GLU)
        + 2 * k * d                          # depthwise conv
        + 2 * d * d                          # conv pointwise 2
    )
    layers = enc.num_blocks * per_frame_layer * fps

    freq = enc.input_size  # 80 mels -> 40 -> 20 -> 10 through stride-2 convs
    sub = (
        2 * 9 * 1 * d * (fps * 4) * (freq // 2)      # conv0 3x3, 50 fps x 40
        + (2 * 9 * d + 2 * d * d) * (fps * 2) * (freq // 4)   # dw1 + pw1
        + (2 * 9 * d + 2 * d * d) * fps * (freq // 8)         # dw2 + pw2
        + 2 * (d * (freq // 8)) * d * fps            # out linear
    )
    ctc = 2 * d * vocab * fps
    return layers + sub + ctc


def decoder_flops_per_step(cfg, batch: int, u: int, enc_t: int) -> float:
    """Analytic forward FLOPs of the (bi)transformer attention decoder for
    one train step, ``bench.py``'s count: self-attention, cross-attention and
    FFN per layer plus the vocabulary projection, summed over the left and
    right decoders."""
    dc = cfg.decoder_conf
    d, ff, v = cfg.encoder_conf.output_size, dc.linear_units, cfg.vocab_size
    n_layers = dc.num_blocks + dc.r_num_blocks
    per_layer = (
        8 * d * d * u            # self-attn qkvo projections
        + 4 * u * u * d          # self-attn scores + context
        + 4 * d * d * u          # cross-attn q,o projections
        + 4 * d * d * enc_t      # cross-attn k,v projections over encoder out
        + 4 * u * enc_t * d      # cross-attn scores + context
        + 4 * d * ff * u         # FFN (two linears)
    )
    return batch * (n_layers * per_layer + 2 * d * v * u * 2)  # 2 vocab heads


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def peak_bf16_tflops(kind: str) -> float:
    """The card's dense bf16 peak; raises for a card the table does not hold."""
    if kind not in PEAK_BF16_TFLOPS:
        raise ValueError(f"no dense bf16 peak for {kind!r} in PEAK_BF16_TFLOPS; "
                         f"pass peak_tflops")
    return PEAK_BF16_TFLOPS[kind]


def power_limit_w(device: torch.device) -> Optional[float]:
    """``nvidia-smi``'s power limit of the card in watts; None off a card."""
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                          "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spread(values) -> Tuple[float, float, float]:
    return statistics.median(values), min(values), max(values)


def _stage_launches(stage: str, calls: int) -> None:
    """The kernels' launch counts since the stage's reset, on stderr."""
    counts = {k: v for k, v in launch_counts().items() if v}
    _log(LAUNCHES + json.dumps({"stage": stage, "calls": calls, "counts": counts}))


def random_model(conf: dict, seed: int) -> Tuple[ChunkFormerConfig, ASRModel]:
    """The ASR model of ``conf`` (no CMVN, as the JAX bench's
    ``init_asr_model``) with the JAX bench's random weights at ``seed``."""
    cfg = ChunkFormerConfig.from_dict(conf)
    return cfg, random_params_like(ASRModel(cfg, cmvn=False), seed=seed)


def decode_features(audio_seconds: float, n_mels: int = 80) -> np.ndarray:
    """Normal features [audio_seconds * 100, n_mels] from ``default_rng(0)``."""
    n_frames = int(audio_seconds * 100)
    return np.random.default_rng(0).normal(size=(n_frames, n_mels)).astype(np.float32)


def end_to_end(model: ChunkFormerModel, feats: np.ndarray, chunk, budget: int,
               reps: int, profile_dir: Optional[str] = None):
    """One warm-up, then ``reps`` timed ``endless_encode_tokens`` calls on
    host features, each ending in the tokens' copy to the host; with
    ``profile_dir``, under ``torch.profiler`` (a Chrome trace written there,
    the device events' time and busy share logged). Returns (the last
    call's tokens, seconds a call)."""
    c, left, right = chunk
    model.endless_encode_tokens(feats, c, left, right, budget)
    _sync(model.device)
    prof = contextlib.nullcontext()
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    seconds = []
    with prof:
        for _ in range(reps):
            t0 = time.perf_counter()
            tokens = model.endless_encode_tokens(feats, c, left, right, budget)
            seconds.append(time.perf_counter() - t0)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "bench_torch_e2e.json")
        prof.export_chrome_trace(path)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in device) * 1e-6
        _log(f"profile of the timed calls: {len(device)} device events (kernels, copies, "
             f"memsets), {busy:.4f} s of device time in {sum(seconds):.4f} s of wall (busy "
             f"share {busy / sum(seconds):.3f}); {path}")
    return tokens, seconds


def device_buffer(feats: np.ndarray, enc_cfg, chunk, budget: int,
                  n_seg: int = DEVICE_SEGMENTS):
    """``bench.py``'s device-walk buffer: ``n_seg`` macro-segments of
    ``clip(feats * 16)`` as int8 (zero past the features), long enough that
    neither segment is the last. Returns (buffer [frames, feat], the
    ``endless_sizing`` tuple)."""
    c, _, right = chunk
    sizing = endless_sizing(enc_cfg, c, right, budget)
    _, _, step_raw, _, capacity = sizing
    sub = enc_cfg.subsampling_rate
    size = (c - 1) * sub + chunk_ops.SUBSAMPLING_CONTEXT
    span = (capacity - 1) * (sub * c) + size
    buf_len = (n_seg - 1) * step_raw + span
    buf = np.clip(feats[:buf_len] * 16, -127, 127).astype(np.int8)
    if buf.shape[0] < buf_len:
        buf = np.concatenate([buf, np.zeros((buf_len - buf.shape[0], feats.shape[1]),
                                            np.int8)])
    return buf, sizing


@torch.inference_mode()
def device_call(model: ChunkFormerModel, buf: torch.Tensor, sizing, chunk,
                chunk_idx: torch.Tensor, att: torch.Tensor, cnn: torch.Tensor,
                n_seg: int = DEVICE_SEGMENTS):
    """One device-walk call: ``n_seg`` macro-segments of the int8 buffer on
    the device through the walk's own segment code, from raw frame 0 and
    kept offset 0, with the caches given. Returns (CTC tokens of each
    segment on the device, att, cnn)."""
    c, left, right = chunk
    step_raw = sizing[2]
    t_total = int(buf.shape[0])
    offset, tokens = 0, []
    for s in range(n_seg):
        out, keep, att, cnn = model._endless_segment(
            buf, DEVICE_SCALE, "int8", s * step_raw, t_total, c, left, right, sizing,
            chunk_idx, offset, att, cnn)
        tokens.append(model._ctc_tokens(out, keep))
        offset += keep
    return tokens, att, cnn


@torch.inference_mode()
def device_walk(model: ChunkFormerModel, buf: np.ndarray, sizing, chunk, reps: int):
    """One warm-up, then ``reps`` timed ``device_call``s chained through the
    caches on the buffer uploaded once. Returns seconds a call."""
    buf_dev = torch.from_numpy(buf).to(model.device)
    att, cnn = model.model.encoder.init_caches(chunk[1], model.dtype, model.device)
    chunk_idx = model._meta(np.arange(sizing[4]))
    _, att, cnn = device_call(model, buf_dev, sizing, chunk, chunk_idx, att, cnn)
    _sync(model.device)
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, att, cnn = device_call(model, buf_dev, sizing, chunk, chunk_idx, att, cnn)
        _sync(model.device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def train_batch(vocab: int, shape=TRAIN_SHAPE, seed: int = 2):
    """``bench.py``'s train batch as numpy: normal features [B, T, 80]
    (float32), full lengths, labels in [1, vocab - 2) [B, U], full lengths."""
    b, t, u = shape
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 80)).astype(np.float32)
    targets = rng.integers(1, vocab - 2, size=(b, u))
    return (feats, np.full((b,), t, np.int32), targets, np.full((b,), u, np.int32))


def train_stage(conf: dict, device: torch.device, dtype: torch.dtype, chunk, steps: int,
                shape=TRAIN_SHAPE):
    """One warm-up step, then ``steps`` timed steps of ``conf``'s model on
    ``train_batch``. In bf16 the step runs under autocast and the features
    are rounded to bf16, as the JAX bench feeds them. Returns (config,
    every step's loss, the warm-up's first, seconds a timed step)."""
    cfg, model = random_model(conf, seed=1)
    model = model.to(device)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3},
                                 "warmuplr", {"warmup_steps": 25000})
    autocast = torch.bfloat16 if dtype == torch.bfloat16 else None
    step = make_train_step(model, cfg, opt, sched, chunk_cfg=tuple(chunk), autocast=autocast)
    feats, lens, targets, tlens = (torch.from_numpy(a).to(device)
                                   for a in train_batch(cfg.vocab_size, shape))
    if autocast is not None:
        feats = feats.to(autocast).float()
    gen = torch.Generator().manual_seed(0)  # dropout draws
    losses, seconds = [], []
    for _ in range(steps + 1):
        _sync(device)
        t0 = time.perf_counter()
        metrics = step(feats, lens, targets, tlens, gen)
        losses.append(float(metrics["loss"]))
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return cfg, losses, seconds[1:]


def run(device=None, dtype: torch.dtype = torch.bfloat16, decode_conf: dict = DECODE,
        train_conf: dict = TRAIN, audio_seconds: float = AUDIO_SECONDS, budget: int = BUDGET,
        chunk=CHUNK, reps: int = 5, device_reps: int = 6, train_steps: int = 5,
        train_shape=TRAIN_SHAPE, peak_tflops: Optional[float] = None,
        profile_dir: Optional[str] = None) -> dict:
    """The three stages in ``bench.py``'s order, each printing its milestone
    line; returns the last. ``device`` is ``cuda`` unless named (no card and
    no device raises); ``peak_tflops`` overrides the card's table entry."""
    device = resolve_device(device)
    kind = device_kind(device)
    peak = (peak_bf16_tflops(kind) if peak_tflops is None else peak_tflops) * 1e12
    c, left, right = chunk
    _log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------- stage 1: end-to-end endless decode -------------------
    cfg, net = random_model(decode_conf, seed=0)
    model = ChunkFormerModel(cfg, net.state_dict(), dtype=dtype, device=device)
    del net
    feats = decode_features(audio_seconds, cfg.encoder_conf.input_size)
    reset_launch_counts()
    _log(f"e2e: warm-up, then {reps} reps of {audio_seconds:.0f} s")
    tokens, seconds = end_to_end(model, feats, chunk, budget, reps, profile_dir)
    _stage_launches("e2e", reps + 1)
    if tokens.shape[0] == 0:
        raise RuntimeError("the end-to-end walk returned no tokens")
    e2e, e2e_min, e2e_max = _spread([audio_seconds / s for s in seconds])
    result = {
        "metric": "audio_seconds_per_second",
        "value": round(e2e, 2),
        "value_min": round(e2e_min, 2),
        "value_max": round(e2e_max, 2),
        "unit": "audio-s/s",
        "vs_baseline": round(e2e / BASELINE_AUDIO_SECONDS_PER_S, 3),
        "device_kind": kind,
        "power_limit_w": power_limit_w(device),
        "dtype": str(dtype).replace("torch.", ""),
    }
    _emit(result)
    _log(f"e2e: {e2e:.1f} audio-s/s ({e2e_min:.1f}-{e2e_max:.1f})")

    # ---------------- stage 2: the device walk alone ------------------------
    buf, sizing = device_buffer(feats, cfg.encoder_conf, chunk, budget)
    del feats
    reset_launch_counts()
    seconds = device_walk(model, buf, sizing, chunk, device_reps)
    _stage_launches("device", device_reps + 1)
    seg_audio_s = DEVICE_SEGMENTS * sizing[2] / 100.0  # 10 ms raw frames
    dev_rate, dev_min, dev_max = _spread([seg_audio_s / s for s in seconds])
    flops_per_audio_s = encoder_flops_per_audio_second(cfg, c, left, right, cfg.vocab_size)
    mfu = flops_per_audio_s * dev_rate / peak
    result.update({
        "device_step_audio_s_per_s": round(dev_rate, 2),
        "device_step_audio_s_per_s_min": round(dev_min, 2),
        "device_step_audio_s_per_s_max": round(dev_max, 2),
        "mfu": round(mfu, 6),
        "flops_per_audio_s": round(flops_per_audio_s),
    })
    _emit(result)
    _log(f"device walk: {dev_rate:.1f} audio-s/s ({dev_min:.1f}-{dev_max:.1f}), "
         f"{sizing[4]} rows a segment, mfu {mfu:.4f}")

    # ---------------- stage 3: the train step -------------------------------
    # built only now, so that no train work lands inside stages 1-2
    del model, buf
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reset_launch_counts()
    _log(f"train: building the model, one warm-up step, then {train_steps} steps")
    train_cfg, losses, seconds = train_stage(train_conf, device, dtype, chunk, train_steps,
                                             train_shape)
    _stage_launches("train", train_steps + 1)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")
    b, t_frames, u = train_shape
    train_audio_s = b * t_frames * 0.01
    step_s = statistics.median(seconds)
    train_rate, train_min, train_max = _spread([train_audio_s / s for s in seconds])
    # fwd+bwd ~= 3x forward FLOPs ("dots" keeps the matrix products' outputs);
    # the decoder counted per step at the subsampled encoder length
    enc_t = int(chunk_ops.calc_length(t_frames))
    enc_fwd = encoder_flops_per_audio_second(train_cfg, c, left, right,
                                             train_cfg.vocab_size)
    dec_fwd = decoder_flops_per_step(train_cfg, b, u + 1, enc_t)
    train_mfu = 3.0 * (enc_fwd * train_audio_s + dec_fwd) / step_s / peak
    result.update({
        "train_audio_s_per_s": round(train_rate, 2),
        "train_audio_s_per_s_min": round(train_min, 2),
        "train_audio_s_per_s_max": round(train_max, 2),
        "train_mfu": round(train_mfu, 6),
        "train_loss": round(losses[-1], 4),
    })
    _emit(result)
    _log(f"train: {train_rate:.1f} audio-s/s ({train_min:.1f}-{train_max:.1f}), "
         f"{1e3 * step_s:.1f} ms a step, mfu {train_mfu:.4f}, losses "
         f"{[round(x, 4) for x in losses]}; total wall {time.perf_counter() - T0:.1f} s")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of the timed end-to-end calls here")
    args = ap.parse_args(argv)
    run(dtype={"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype],
        profile_dir=args.profile_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
