#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chunkformer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds; any failure ends the run with a
non-zero exit code and no result line:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``chunkformer_tpu_torch/csrc`` (nvcc, printing
   registers and shared memory per kernel);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (chunk attention in f32 and bf16, and at an odd N;
   fbank on 120 s of audio), with CUDA-event times;
4. the main path at ChunkFormer-large width (512 d, 8 heads, 17 blocks,
   vocab 6992, c = 64, L = R = 128) with random weights from a seed:
   ``endless_decode`` of 34 minutes of synthetic audio (3 macro-segments) and
   ``batch_decode`` of three files of mixed lengths, in bf16, with every
   kernel's launch count read around that run; then in f32 the
   endless-vs-single-shot token mismatch, and the card's encoder against the
   CPU's on a small input;
5. a ``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense FLOP/s
SEED = 0

LARGE = {  # ChunkFormer-large, as bench.py:220-227
    "model": "asr_model",
    "encoder_conf": {"output_size": 512, "attention_heads": 8, "linear_units": 2048,
                     "num_blocks": 17, "cnn_module_kernel": 15,
                     "cnn_module_norm": "layer_norm", "dynamic_conv": True},
    "output_dim": 6992,
    "dataset_conf": {"fbank_conf": {"num_mel_bins": 80, "frame_shift": 10,
                                    "frame_length": 25, "dither": 0.0}},
}
C, LEFT, RIGHT, BUDGET = 64, 128, 128, 1800
LONG_SECONDS = 2040.0     # 3 macro-segments of the 1800 s budget
BATCH_SECONDS = (17.3, 48.1, 95.7)


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() on the card by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def speechlike(rng: np.random.Generator, seconds: float, sr: int = 16000) -> np.ndarray:
    """int16 audio: amplitude-modulated tones over noise, with pauses."""
    n = int(seconds * sr)
    t = np.arange(n, dtype=np.float32) / sr
    x = np.zeros(n, np.float32)
    for f in rng.uniform(100.0, 3500.0, 5):
        x += np.sin(np.float32(2 * np.pi * f) * t + np.float32(rng.uniform(0, 6)))
    env = (np.sin(np.float32(2 * np.pi * 0.4) * t) > -0.3).astype(np.float32)
    x = env * x * 2500.0 + rng.normal(0.0, 300.0, n).astype(np.float32)
    return np.clip(x, -32768, 32767).astype(np.int16)


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {card}")
    return name, count, card


def phase_build():
    from chunkformer_tpu_torch.ops import kernels

    path = kernels.build()
    log(f"built {os.path.relpath(path)}")
    for line in kernels.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling entry" in line):
            log(f"  {line.strip()}")
    kernels.library()


def attention_inputs(n, dtype, offset, max_len, gen, dev):
    """Main-path-shaped chunk attention operands (row-major) on the card."""
    h, dk = LARGE["encoder_conf"]["attention_heads"], 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q, kv = rnd(n, C, h, dk), rnd(LEFT + n * C + RIGHT, h, 2 * dk)
    p, u, v = rnd(2 * C - 1 + LEFT + RIGHT, h, dk), rnd(h, dk), rnd(h, dk)
    meta = [torch.arange(n, dtype=torch.int32, device=dev),
            torch.full((n,), offset, dtype=torch.int32, device=dev),
            torch.full((n,), max_len, dtype=torch.int32, device=dev)]
    return [q, kv, p, u, v, *meta]


def attention_bound(args):
    """Least time on an H100 SXM: each operand read once, the output written
    once; operations counted over this data's valid keys (AC, BD and the
    context product, 2 FLOP per multiply-add)."""
    q, kv, p, u, v, ci, off, ml = args
    n, c, h, dk = q.shape
    w = LEFT + c + RIGHT
    item = q.element_size()
    nbytes = (2 * q.numel() + kv.numel() + p.numel() + u.numel() + v.numel()) * item \
        + 3 * n * 4
    ci, off, ml = ci.long(), off.long(), ml.long()
    lo = torch.clamp(LEFT - ci * c - off, min=0)
    hi = torch.clamp(ml - ci * c + LEFT, max=w)
    valid_keys = int(torch.clamp(hi - lo, min=0).sum())
    ops = valid_keys * c * h * dk * 2 * 3
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_PEAK[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fbank_bound(wave, n_frames):
    win, n_bins, n_mels = 400, 257, 80
    nbytes = wave.numel() * 4 + n_frames * n_mels * 4 + (2 * win * n_bins + win
                                                         + n_bins * n_mels) * 4
    ops = n_frames * (2 * 2 * win * n_bins + 3 * n_bins + 2 * n_bins * n_mels + 6 * win)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_PEAK[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(sizing, device):
    """Each kernel against its plain version at the main path's shapes."""
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
    from chunkformer_tpu_torch.ops.fbank import fbank, fbank_plain, num_frames

    trunc, rel_right, step_raw, seg_raw, capacity = sizing
    # a middle macro-segment: offset trunc, lookahead rows partly past max_len
    max_len = 1 + (seg_raw - 15) // 8
    gen = torch.Generator(device=device).manual_seed(SEED)
    results = {}
    cases = [("attention f32", capacity, torch.float32, 1e-5, 0.0),
             ("attention bf16", capacity, torch.bfloat16, 1e-2, 2.0 ** -7),
             ("attention f32 odd N=13", 13, torch.float32, 1e-5, 0.0)]
    for label, n, dtype, atol, rtol in cases:
        args = attention_inputs(n, dtype, trunc, min(max_len, n * C - 37), gen, device)
        kw = dict(chunk=C, left=LEFT, right=RIGHT)
        got = chunk_attention(*args, **kw)
        torch.cuda.synchronize()
        want = chunk_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs()
        tol = atol + rtol * want.float().abs()
        max_err = float(err.max())
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
        require(bool((err <= tol).all()),
                f"{label}: max |kernel - plain| {max_err:.3g} above atol {atol} rtol {rtol}")
        ms = cuda_ms(lambda: chunk_attention(*args, **kw), iters=20)
        plain_ms = cuda_ms(lambda: chunk_attention_plain(*args, **kw), iters=3, warmup=1)
        bound_ms, bound_by = attention_bound(args)
        results[label] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        log(f"{label}: N={n} H=8 c={C} dk=64 L=R={LEFT}: max|kernel-plain| {max_err:.3g} "
            f"(atol {atol}, rtol {rtol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}")

    rng = np.random.default_rng(SEED)
    wave = torch.from_numpy(speechlike(rng, 120.0).astype(np.float32)).to(device)
    got = fbank(wave)
    torch.cuda.synchronize()
    want = fbank_plain(wave)
    require(got.shape == want.shape == (num_frames(wave.numel()), 80),
            f"fbank shape {tuple(got.shape)}")
    err = (got - want).abs()
    max_err = float(err.max())
    require(bool(torch.isfinite(got).all()), "fbank: non-finite output")
    require(bool((err <= 2e-3 + 1e-3 * want.abs()).all()),
            f"fbank: max |kernel - plain| {max_err:.3g} above atol 2e-3 rtol 1e-3")
    ms = cuda_ms(lambda: fbank(wave), iters=20)
    plain_ms = cuda_ms(lambda: fbank_plain(wave), iters=5, warmup=1)
    bound_ms, bound_by = fbank_bound(wave, got.shape[0])
    results["fbank"] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    log(f"fbank: 120 s at 16 kHz ({got.shape[0]} frames): max|kernel-plain| {max_err:.3g} "
        f"(atol 2e-3, rtol 1e-3); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    return results


def write_wav(path, samples):
    from scipy.io import wavfile

    wavfile.write(path, 16000, samples)
    return path


def reset_counts():
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention
    from chunkformer_tpu_torch.ops.fbank import fbank

    chunk_attention.launches = 0
    fbank.launches = 0


def read_counts():
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention
    from chunkformer_tpu_torch.ops.fbank import fbank

    return {"chunk_attention": chunk_attention.launches, "fbank": fbank.launches}


def phase_main_path(tmp, card, device):
    from chunkformer_tpu_torch.api import ChunkFormerModel, endless_sizing
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.ops import chunk as chunk_ops
    from chunkformer_tpu_torch.ops.fbank import fbank, num_frames

    rng = np.random.default_rng(SEED)
    long_wav = write_wav(os.path.join(tmp, "long.wav"), speechlike(rng, LONG_SECONDS))
    batch_wavs = [write_wav(os.path.join(tmp, f"b{i}.wav"), speechlike(rng, s))
                  for i, s in enumerate(BATCH_SECONDS)]

    cfg = ChunkFormerConfig.from_dict(LARGE)
    n_layers = cfg.encoder_conf.num_blocks
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    del model
    # CMVN from the first minute of the long file's features
    from scipy.io import wavfile

    head = torch.from_numpy(wavfile.read(long_wav)[1][:16000 * 60].astype(np.float32))
    feats = fbank(head.to(device))
    sd["encoder.global_cmvn.mean"] = feats.mean(0).cpu()
    sd["encoder.global_cmvn.istd"] = (1.0 / feats.std(0).clamp_min(1e-3)).cpu()
    char_dict = {0: "<blank>", **{i: f"w{i}▁" if i % 7 == 0 else chr(0x4E00 + i)
                                  for i in range(1, cfg.vocab_size)}}

    t_total = num_frames(int(LONG_SECONDS * 16000))
    bf16 = ChunkFormerModel(cfg, sd, char_dict, dtype=torch.bfloat16, device=device)
    trunc, rel_right, step_raw, seg_raw, capacity = endless_sizing(cfg.encoder_conf, C, RIGHT,
                                                                   BUDGET)
    n_seg = len([s for s in range(0, t_total, step_raw)
                 if s == 0 or s - step_raw + rel_right < t_total])
    require(n_seg >= 3, f"only {n_seg} macro-segments")

    # ---- the main path in bf16: endless_decode, then batch_decode. A first
    # endless_decode pays cuBLAS/cuDNN set-up; it is timed apart as "cold".
    t0 = time.time()
    bf16.endless_decode(long_wav, C, LEFT, RIGHT, BUDGET)
    torch.cuda.synchronize()
    t_cold = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    segments = bf16.endless_decode(long_wav, C, LEFT, RIGHT, BUDGET)
    torch.cuda.synchronize()
    t_endless = time.time() - t0
    endless_counts = read_counts()
    t0 = time.time()
    texts = bf16.batch_decode(batch_wavs, C, LEFT, RIGHT, BUDGET)
    torch.cuda.synchronize()
    t_batch = time.time() - t0
    main_counts = read_counts()
    batch_counts = {k: main_counts[k] - endless_counts[k] for k in main_counts}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"endless_decode bf16: {LONG_SECONDS:.0f} s audio, {n_seg} macro-segments of "
        f"{capacity} chunk rows: {t_endless:.3f} s, {LONG_SECONDS / t_endless:.1f} audio-s/s "
        f"(cold first call {t_cold:.3f} s, {LONG_SECONDS / t_cold:.1f} audio-s/s); "
        f"{len(segments)} text segments, first {segments[0] if segments else None}; "
        f"launches {endless_counts}")
    log(f"batch_decode bf16: {len(batch_wavs)} files of {BATCH_SECONDS} s: {t_batch:.3f} s, "
        f"{sum(BATCH_SECONDS) / t_batch:.1f} audio-s/s; launches {batch_counts}")
    log(f"peak device memory {peak_gib:.2f} GiB; card {card}")
    require(endless_counts["chunk_attention"] == n_layers * n_seg,
            f"endless_decode launched chunk attention {endless_counts['chunk_attention']} "
            f"times, expected {n_layers} x {n_seg}")
    require(endless_counts["fbank"] >= 1, "endless_decode never launched the fbank kernel")
    require(batch_counts["chunk_attention"] == n_layers and batch_counts["fbank"] == 3,
            f"batch_decode launches {batch_counts}")
    require(len(texts) == 3 and all(isinstance(t, str) for t in texts), "batch_decode output")
    require(len(segments) > 0 and all(s["decode"] for s in segments), "endless_decode output")
    del bf16
    torch.cuda.empty_cache()

    # ---- f32: segmented == single-shot, and card == CPU on a small input
    f32 = ChunkFormerModel(cfg, sd, None, dtype=torch.float32, device=device)
    reset_counts()
    endless = f32.endless_decode(long_wav, C, LEFT, RIGHT, BUDGET)
    single = f32.batch_decode([long_wav], C, LEFT, RIGHT, BUDGET)[0]
    counts = read_counts()
    require(counts == {"chunk_attention": n_layers * (n_seg + 1), "fbank": 2},
            f"f32 launches {counts}")
    require(endless.shape == single.shape == (int(chunk_ops.calc_length(t_total)),),
            f"token counts {endless.shape} {single.shape}")
    require(bool(((endless >= 0) & (endless < cfg.vocab_size)).all()), "token ids out of range")
    mismatch = float(np.mean(endless != single))
    log(f"f32 endless vs single-shot batch on the same audio: {endless.size} frames, "
        f"token mismatch {mismatch:.5f} (limit 0.01); launches {counts}")
    require(mismatch <= 0.01, f"endless vs batch mismatch {mismatch} above 1%")

    small = f32.extract_features(batch_wavs[0])
    cpu = ChunkFormerModel(cfg, sd, None, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        outs = []
        for m in (f32, cpu):
            packed = chunk_ops.pack_chunks([small.to(m.device)], [small.shape[0]], C)
            att, cnn = m.model.encoder.init_caches(LEFT, torch.float32, m.device)
            out, _, _ = m.model.encoder.parallel_chunk(
                packed.xs, m._meta(packed.chunk_idx), m._meta(packed.offsets),
                m._meta(packed.max_lens), C, LEFT, RIGHT, att, cnn, 0)
            outs.append(out.cpu())
    enc_err = float((outs[0] - outs[1]).abs().max())
    log(f"encoder on the card vs on the CPU, f32, {small.shape[0]} frames: max abs diff "
        f"{enc_err:.3g} (limit 2e-3)")
    require(bool(torch.isfinite(outs[0]).all()) and enc_err <= 2e-3,
            f"card vs CPU encoder differ by {enc_err}")
    return main_counts, capacity


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from chunkformer_tpu_torch.api import endless_sizing  # fails outside a checkout
    from chunkformer_tpu_torch.config import ChunkFormerConfig

    # every f32 comparison runs in full f32: no TF32 in cuBLAS or cuDNN
    # (cuDNN convolutions default to TF32); bf16 work is not affected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t = time.time()
        name, count, card = phase_device()
        log(f"[phase device] {time.time() - t:.1f} s")

        t = time.time()
        phase_build()
        log(f"[phase build] {time.time() - t:.1f} s")

        t = time.time()
        sizing = endless_sizing(ChunkFormerConfig.from_dict(LARGE).encoder_conf, C, RIGHT,
                                BUDGET)
        results = phase_kernels(sizing, torch.device("cuda"))
        log(f"[phase kernels] {time.time() - t:.1f} s")

        t = time.time()
        launches, capacity = phase_main_path(tmp, card, torch.device("cuda"))
        log(f"[phase main path] {time.time() - t:.1f} s")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    att = results["attention bf16"]
    kernels = [
        {"name": "chunk_attention", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": launches["chunk_attention"], **att, "library_ms": None},
        {"name": "fbank", "route": "cuda", "source": "chunkformer_tpu_torch/csrc/fbank.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": launches["fbank"], **results["fbank"], "library_ms": None},
    ]
    log(f"kernels at the main path's shapes (attention: bf16, N={capacity}); card {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
