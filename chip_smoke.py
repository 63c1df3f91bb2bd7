#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chunkformer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds; any failure ends the run with a
non-zero exit code and no result line:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build the native host library (g++) and the CUDA kernels from
   ``chunkformer_tpu_torch/csrc`` (nvcc, printing registers and shared
   memory per kernel);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (chunk attention: the CUDA-core kernel in f32, at
   an odd N, in bf16 and at head_dim 32, the shape it is the route of; the
   tensor-core kernels in bf16 and in f32 (3xTF32) at N = 209, 13 and 1, on
   a middle, a first and a last macro-segment, in f32 also at dk = 128,
   c = 128 and head-major; fbank's FFT kernel and DFT kernel on 120 s and on
   the main path's 2040 s of audio), with CUDA-event times (each tensor-core
   kernel, the CUDA-core kernel and the plain version in turns on the same
   inputs, bf16 and f32; the FFT kernel, the DFT kernel and the plain
   version in turns, with ``torch.fft.rfft`` of the same windowed frames on
   a log line as the FFT stage's yardstick);
4. the main path at ChunkFormer-large width (512 d, 8 heads, 17 blocks,
   vocab 6992, c = 64, L = R = 128) with random weights from a seed:
   ``endless_decode`` of 34 minutes of synthetic audio (3 macro-segments) and
   ``batch_decode`` of three files of mixed lengths, in bf16, with every
   kernel's launch count read around that run (all attention on the
   tensor-core route, all features on the FFT kernel); then in f32 (the
   3xTF32 tensor-core kernel, its launches read around that run) the
   endless-vs-single-shot token mismatch,
   the tokens against the same f32 ``endless_decode`` with the CUDA-core
   kernel swapped in (no flip where the top-1/top-2 gap is 1e-3 or more),
   the tokens against the same decode from the DFT kernel's features (the
   same rule),
   the bf16-vs-f32 CTC token-flip rate of ``endless_decode``, held on frames
   that are not near ties and against the same bf16 model through the plain
   attention, and the card's encoder against the CPU's on a small input;
   then, in bf16 and f32, ``endless_encode_tokens`` of the same file's
   features on the card and from the host (fetched, written and read back
   by ``data/kaldi_io.py``, passed as numpy; int8 with one global scale in
   bf16), tokens equal to ``endless_decode``'s, the host library's int8
   tensor and scale equal to the card quantizer's, with the bytes
   uploaded, the pinned copy's time and each way's wall time;
5. the training attention kernels (forward and backward) against their plain
   versions at the flagship train shape (B = 32, 199 subsampled frames,
   c = 64, L = R = 128, H = 8, dk = 64), at dropout 0 and 0.1 (identical
   keep masks), in f32 and bf16, each on the tensor-core kernels (f32:
   3xTF32; backward run twice, bitwise equal) and on the CUDA-core kernels,
   timed in turns with the plain version on the same inputs; then B4 and
   B5 of each route on heads 4-7 of 8 with a head offset of 4, bitwise
   the full call's slice (a tensor-parallel rank's share), and the plain
   version on those heads;
6. the train path: three bf16 steps of the hybrid CTC/AED configuration of
   bench.py:149-177 (ChunkFormer-large encoder with gradient checkpointing,
   bitransformer decoder 3 + 3, vocab 6992, adamw) on 32 seeded synthetic
   utterances of 16 s, with the training attention's launch counts read
   around them (tensor-core kernels only); one f32 step through the
   tensor-core route (its kernels only) and one through the CUDA-core route,
   each against the same step through the plain attention; one bf16 step
   with dropout 0 through each route, each against the plain attention;
7. the search path: an export directory of ChunkFormer-large with the 3 + 3
   bitransformer decoder (random weights from a seed) that ``from_pretrained``
   loads; ``bin/recognize.py`` ``main(argv)`` with its five CTC/AED modes on
   8 files of 4-40 s in one batch at (64, 128, 128), beam 10, once as a
   warm-up, then in f32 and bf16, with wall times by mode and the kernels'
   launch counts (B4's forward in eval only, 17 an encode batch; the FFT
   fbank kernel once a file); the encoder against the plain attention, the
   R = 0 encode against the parallel-chunk route, the token and beam
   checks, B4's eval forward timed against its bound; ``bin/decode.py`` on
   one file and ``bin/alignment.py`` on two;
8. other geometries: the decode attention at chunks of 96, 48 and 72 on
   the tensor cores (partial query tiles) in f32 and bf16, held and timed
   beside the CUDA-core kernel and the plain version; the training kernels
   there (B4 and B5, partial 64-row query blocks and 64-frame key blocks)
   on the tensor cores in f32 and bf16, held beside the CUDA-core kernels
   and timed in turns with them and the plain version, the tensor cores
   required the fastest; the same at c = 1 (64 one-frame chunks an
   utterance, no route required the fastest), the f32 row maxima and
   denominators printed beside a float64 run of the plain version; a 120 s
   f32 ``endless_decode`` at c = 96 (tensor-core launches only) against the
   plain attention; the flagship
   train step at (96, 128, 128) in f32 and bf16 against the plain
   attention, tensor-core training launches only; an f32 encode of the
   search files at (96, 128, 128) (B4's eval forward on the tensor cores,
   timed); the FFT fbank at 50 ms with shifts of 160 and 161 samples, a 40
   ms shift, 25 ms at 44.1 kHz (2048 points), 160 mel bins, 15 ms at 8 kHz
   (128 points, the 256-point plan's strided bins) and 25 ms at 96 kHz
   (4096 points, the in-place plan), and the block plan at 50 ms at 96 kHz
   (8192 points), 100 ms at 96 kHz (16384) and 100 ms at 192 kHz (32768,
   its workspace), beside the DFT kernel where it takes the window, the
   plain version and, above 4096 points, ``torch.fft.rfft`` of the
   windowed frames;
9. the streaming path: an export of ChunkFormer-large (random weights from
   a seed); ``bin/stream.py`` on 60 s of audio at the realtime defaults
   (c, L, R) = (6, 50, 0) in f32 and bf16 after a warm-up, with the
   per-step latency p50/p95 and the RTF, one FFT fbank launch a step and no
   attention kernel (the streaming step's attention is plain PyTorch, as in
   ``chunkformer_tpu``); the FFT kernel on one step's window; f32
   ``streaming_step`` against ``encode`` at (6, 50, 0) (atol 2e-3); and
   ``recognize --simulate_streaming`` at (64, 128, 0) on the search files,
   file by file against ``encode`` (no flip where the gap is 1e-3 or more);
10. classification at the widths of
   ``examples/classification/conf/multi_task.yaml`` (256 d, 12 blocks,
   four tasks; random weights): ``bin/classify.py`` on the search files at
   full context in f32 and bf16; ``classify_audio`` at (128, 128, 128) with
   its wall time a file and 12 tensor-core B4 forward launches a file; the
   f32 logits against the plain attention (atol 2e-3, labels equal); B4
   timed at that shape;
11. the transducer at the widths of
   ``examples/asr/rnnt/conf/chunkformer-rnnt-small.yaml`` (256 d, 12 blocks,
   LSTM predictor 2 x 256, joint 512, decoder 3 + 3, vocab 6992; random
   weights, the joint shaped so that blank wins on part of the frames) as an
   export: ``endless_decode`` of 300 s at (64, 128, 128) with a 120 s budget
   in f32 and bf16 (f32 frame tokens equal to one greedy pass over
   ``endless_encode``'s output), ``batch_decode`` of the three batch files,
   ``bin/recognize.py`` with the three rnnt_* modes on the search files in
   f32 and bf16 (audio-s/s by mode); the k2 transducer train step at the
   flagship batch shape, 3 bf16 and 3 f32 steps (ms a step, peak memory,
   12 B4 and 12 B5 launches a step), one f32 step against the plain
   attention (loss 1e-5, gradients 1e-4 relative L2); B1, B2, B4 and B5
   timed at these paths' shapes;
12. the train CLI at the flagship width (the bench.py:149-177 model with the
   dataset_conf of ``examples/asr/ctc/conf/chunkformer-ctc-small.yaml`` at
   51200 frames a batch, chunks fixed at (64, 128, 128), f32) on 64
   synthetic WAVs of 4-16 s with a 6992-symbol char vocabulary and a CMVN
   file (features from the native host library's fbank, timed beside its
   numpy twin): ``bin/train.py`` ``main(argv)`` for two epochs (each step's
   time beside its host data time, audio-s/s, peak memory, 17 + 17
   tensor-core B4/B5 launches a step and no other attention kernel), a
   resume from epoch_0 (the saved step and Adam's state continue), one
   step with ``--distributed`` at world size 1 on NCCL, two steps each with
   ``--distributed --sharding fsdp``, ``tp`` and ``fsdp_tp`` at world size
   1 against a dp run of the same two steps (losses, gradient norms,
   parameters), and for the two-epoch run and the fsdp_tp run
   ``bin/average_model.py --num 2``, ``export_model_dir`` of the average
   (``from_pretrained`` bitwise equal) and a 120 s f32 ``endless_decode``
   of it equal to the in-memory average's tokens, with B1 and B2 launches;
13. the CTC recipe twin, ``examples/asr/ctc/run_torch.sh``, at its defaults
   (the card) with its own ``conf/chunkformer-ctc-small.yaml`` (256 d, 12
   blocks, 3 + 3 decoder) cut to two epochs and a log line a step, on the
   train CLI's synthetic WAVs, ``avg_num=2``: each stage's wall and exit
   code, stage 3's B4/B5 launches against the train CLI's rule for its
   steps and drawn chunks (no decode kernel), stage 6's ctc_greedy_search
   file equal to ``bin/recognize.py`` in-process on the same export;
14. one f32 step of the flagship model with a batch-norm conv module and
   the length-normalized loss under ``dp`` at world size 1 (NCCL, the
   world's group as data group) against the same step with no group:
   parameters within 1e-6, ``acc_att`` equal;
15. the app twins: ``apps/realtime-asr-torch``'s ``RealtimeASR.run`` on
   the streaming phase's 60 s file equal to ``bin/stream.py``'s
   transcript, and ``apps/streamlit_torch``'s ``transcribe_audio`` of the
   2040 s file equal to ``endless_decode``'s segments of the same export;
16. decode with the chunk rows split over a process group
   (``parallel/row_shard.py``) at world size 1 on NCCL in this process:
   ChunkFormer-large on a middle macro-segment of the 1800 s budget (209
   rows, trunc > 0) in bf16 and f32, ``parallel_chunk(group=...)`` with the
   gathered CTC tokens bitwise equal to ``group=None`` (tokens, outputs,
   both caches), 17 tensor-core B1 launches a call, both walls;
17. the five measurement-tool twins (``tools/ablate_torch_step.py``,
   ``ablate_torch_train_step.py``, ``bench_torch_endless_breakdown.py``,
   ``bench_torch_pipeline.py``, ``bench_torch_scaling.py`` under torchrun
   with one process) as subprocesses at their smallest arguments: exit 0
   and JSON naming the card;
18. the port's benchmark, ``bench_torch.py``, at its defaults
   (ChunkFormer-large in bf16, the flagship train step) as a subprocess:
   exit 0, three milestone JSON lines each extending the one before, mfu
   and train_mfu in (0, 1], a finite train_loss, and its launch counts:
   the bf16 tensor-core B1 only, 34 a decode call, in the end-to-end and
   device-walk stages, the bf16 tensor-core B4 and B5 only, 17 each a
   step, in the train stage;
19. a ``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12,  # dense FLOP/s
             "tf32": 495e12}  # tensor cores; f32 work split 3x as 3xTF32
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


def scaled_large(d_model: int = 512, num_blocks: int = 17) -> dict:
    """``LARGE`` at ``d_model`` (a head per 64 channels, FFN 4 x d_model) and
    ``num_blocks`` (the measurement tools' widths; the defaults are LARGE)."""
    enc = {**LARGE["encoder_conf"], "output_size": d_model,
           "attention_heads": max(d_model // 64, 1), "linear_units": 4 * d_model,
           "num_blocks": num_blocks}
    return {**LARGE, "encoder_conf": enc}


LONG_SECONDS = 2040.0     # 3 macro-segments of the 1800 s budget
BATCH_SECONDS = (17.3, 48.1, 95.7)

TRAIN = {  # the flagship hybrid CTC/AED train step of bench.py:149-177
    "model": "asr_model",
    "encoder_conf": {"output_size": 512, "attention_heads": 8, "linear_units": 2048,
                     "num_blocks": 17, "cnn_module_kernel": 15,
                     "cnn_module_norm": "layer_norm", "dynamic_conv": True,
                     "gradient_checkpointing": True, "remat_policy": "dots"},
    "decoder": "bitransformer",
    "decoder_conf": {"attention_heads": 8, "linear_units": 2048, "num_blocks": 3,
                     "r_num_blocks": 3},
    "model_conf": {"ctc_weight": 0.3, "reverse_weight": 0.3, "lsm_weight": 0.1},
    "output_dim": 6992,
}
TRAIN_BATCH, TRAIN_FRAMES, TRAIN_LABELS = 32, 1600, 48   # 32 x 16 s = 512 audio-s a step
TRAIN_STEPS = 3
GRAD_CLIP = 5.0


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of fn() on the card by CUDA events, after warm-up. The stream
    first spins for about 0.5 ms an iteration, so the host queues the calls
    ahead of the card and a slow host does not leave gaps between short
    kernels that the events would count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(iters * 1_000_000)
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


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card ``device`` names, or
    "cpu" (the measurement tools' label of their numbers)."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}"


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

    from chunkformer_tpu_torch import native

    t = time.time()
    log(f"built {os.path.relpath(native.build())} (host library, g++) in {time.time() - t:.1f} s")
    path = kernels.build()
    log(f"built {os.path.relpath(path)}")
    for line in kernels.build_log().splitlines():
        if ("ptxas info" in line and ("Used" in line or "Compiling entry" in line)) \
                or "warning" in line.lower():
            log(f"  {line.strip()}")
    kernels.library()


def attention_inputs(n, dtype, offset, max_len, gen, dev, c=C, dk=64):
    """Main-path-shaped chunk attention operands (row-major) on the card: n
    chunk rows of one macro-segment at decode offset ``offset``."""
    h = LARGE["encoder_conf"]["attention_heads"]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    q, kv = rnd(n, c, h, dk), rnd(LEFT + n * c + RIGHT, h, 2 * dk)
    p, u, v = rnd(2 * c - 1 + LEFT + RIGHT, h, dk), rnd(h, dk), rnd(h, dk)
    meta = [torch.arange(n, dtype=torch.int32, device=dev),
            torch.full((n,), offset, dtype=torch.int32, device=dev),
            torch.full((n,), max_len, dtype=torch.int32, device=dev)]
    return [q, kv, p, u, v, *meta]


def attention_bound(args, peak=None):
    """Least time on an H100 SXM: each operand read once, the output written
    once; operations counted over this data's valid keys (AC, BD and the
    context product, 2 FLOP per multiply-add) at the peak of the operands'
    dtype, or with ``peak="tf32"`` as the three TF32 passes of the split
    products at the TF32 tensor-core peak (f32-accurate work on the tensor
    cores)."""
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
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 3 * ops / H100_PEAK["tf32"] if peak == "tf32" else ops / H100_PEAK[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fbank_bound(wave, n_frames, n_mels=80, win=400, padded=512, sample_rate=16000):
    """Least time on an H100 SXM for the fbank function: the larger of its
    bytes (the waveform read once, the features written once, and the
    tables it needs counted in float32: twiddles and split factors, the
    window, the band table and its weights) over 3.35 TB/s, and its
    operations at 67 TFLOP/s (the f32 peak off the tensor cores, and the
    float64 peak on them: the same bound for both FFT plans),
    counted a frame as the real FFT's (5/2) padded log2(padded), the
    pre-processing (mean, its subtraction, preemphasis, window: 5 a sample),
    the power of the padded / 2 bins the mel bank weighs (3 each), the
    sparse mel product (2 a non-zero weight) and the log (1 a band)."""
    from chunkformer_tpu_torch.ops.fbank import band_table

    nnz = int(band_table(n_mels, padded, float(sample_rate))[1].sum())
    half = padded // 2
    nbytes = (wave.numel() + n_frames * n_mels) * 4 + (4 * half + win + 3 * n_mels + nnz) * 4
    ops = n_frames * (2.5 * padded * np.log2(padded) + 5 * win + 3 * half + 2 * nnz + n_mels)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_PEAK[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fbank_dft_bound(wave, n_frames):
    """The bound counted with the TPU kernel's algorithm (the DFT as a dense
    product with cos/sin tables and a dense mel product), printed beside
    ``fbank_bound`` so that records made with it stay comparable."""
    win, n_bins, n_mels = 400, 257, 80
    nbytes = wave.numel() * 4 + n_frames * n_mels * 4 + (2 * win * n_bins + win
                                                         + n_bins * n_mels) * 4
    ops = n_frames * (2 * 2 * win * n_bins + 3 * n_bins + 2 * n_bins * n_mels + 6 * win)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_PEAK[torch.float32]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(label, fn, args, atol, rtol):
    """fn(*args) against the plain version: finite, within atol + rtol |plain|;
    returns (output, max |error|)."""
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain

    kw = dict(chunk=args[0].shape[1], left=LEFT, right=RIGHT)
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    want = chunk_attention_plain(*args, **kw)
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    require(bool((err <= atol + rtol * want.float().abs()).all()),
            f"{label}: max |kernel - plain| {max_err:.3g} above atol {atol} rtol {rtol}")
    return got, max_err


def phase_kernels(sizing, device):
    """Each kernel against its plain version at the main path's shapes."""
    from chunkformer_tpu_torch.ops.chunk_attention import (chunk_attention,
                                                           chunk_attention_cuda_core,
                                                           chunk_attention_plain,
                                                           chunk_attention_tensor_core, route)

    trunc, rel_right, step_raw, seg_raw, capacity = sizing
    # a middle macro-segment: offset trunc, lookahead rows partly past max_len
    max_len = 1 + (seg_raw - 15) // 8
    gen = torch.Generator(device=device).manual_seed(SEED)
    kw = dict(chunk=C, left=LEFT, right=RIGHT)
    results = {}
    # the CUDA-core kernel: the route of the shapes the tensor cores do not
    # take (here head_dim 32), and the yardstick of both tensor-core kernels
    # on the main path's shapes
    cases = [("attention f32", capacity, torch.float32, 64, 1e-5, 0.0),
             ("attention bf16 CUDA cores", capacity, torch.bfloat16, 64, 1e-2, 2.0 ** -7),
             ("attention f32 odd N=13", 13, torch.float32, 64, 1e-5, 0.0),
             ("attention f32 head_dim 32", capacity, torch.float32, 32, 1e-5, 0.0)]
    for label, n, dtype, dk, atol, rtol in cases:
        args = attention_inputs(n, dtype, trunc, min(max_len, n * C - 37), gen, device, dk=dk)
        _, max_err = check_attention(label, chunk_attention_cuda_core, args, atol, rtol)
        want_route = "tensor_core" if dk in (64, 128) else "cuda_core"
        require(route(*args[:3]) == want_route, f"{label}: route {route(*args[:3])}")
        ms = cuda_ms(lambda: chunk_attention_cuda_core(*args, **kw), iters=20)
        plain_ms = cuda_ms(lambda: chunk_attention_plain(*args, **kw), iters=3, warmup=1)
        bound_ms, bound_by = attention_bound(args)
        results[label] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        log(f"{label}: N={n} H=8 c={C} dk={dk} L=R={LEFT}: max|kernel-plain| {max_err:.3g} "
            f"(atol {atol}, rtol {rtol}); CUDA-core kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms by {bound_by}; route of this shape: {want_route}")

    # the tensor-core kernels (the main path's route in bf16 and in f32):
    # a middle segment at N = 209, 13 and 1; a first one (offset 0: the
    # first rows' left context is invalid); a last one whose second half of
    # chunk rows lies past max_len (rows with no valid key give 0); in f32
    # also dk = 128, c = 128 and the head-major layout as views
    tc_cases = [("middle", capacity, trunc, min(max_len, capacity * C - 37), C, 64),
                ("middle", 13, trunc, 13 * C - 37, C, 64), ("middle", 1, trunc, C - 37, C, 64),
                ("first", capacity, 0, min(max_len, capacity * C - 37), C, 64),
                ("last", capacity, 2 * trunc, capacity * C // 2 - 7, C, 64)]
    f32_extra = [("middle", 40, trunc, 40 * C - 37, C, 128),
                 ("middle", 40, trunc, 40 * 2 * C - 37, 2 * C, 64),
                 ("last", 40, 2 * trunc, 40 * 2 * C // 2 - 7, 2 * C, 128),
                 ("head-major", capacity, trunc, min(max_len, capacity * C - 37), C, 64)]
    for dtype, extra in ((torch.bfloat16, []), (torch.float32, f32_extra)):
        f32 = dtype == torch.float32
        name, atol, rtol = ("f32", 1e-5, 0.0) if f32 else ("bf16", 1e-2, 2.0 ** -7)
        for segment, n, offset, seg_len, c, dk in tc_cases + extra:
            label = (f"attention {name} tensor cores{' (3xTF32)' if f32 else ''}, {segment} "
                     f"segment N={n}")
            args = attention_inputs(n, dtype, offset, seg_len, gen, device, c=c, dk=dk)
            if segment == "head-major":   # [N, H, c, dk], [H, T, 2dk], [H, P, dk] storage
                args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
                args[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)
                args[2] = args[2].transpose(0, 1).contiguous().transpose(0, 1)
            require(route(*args[:3]) == "tensor_core", f"{label}: not on the tensor-core route")
            launches = (chunk_attention.launches, chunk_attention.tc_launches)
            got, max_err = check_attention(label, chunk_attention, args, atol, rtol)
            require((chunk_attention.launches, chunk_attention.tc_launches)
                    == (launches[0], launches[1] + 1),
                    f"{label}: the tensor-core kernel did not run")
            rows = ""
            if segment == "last":
                start = torch.arange(n, device=device) * c     # the rows' valid key interval
                lo = (LEFT - start - offset).clamp(min=0)
                hi = (seg_len - start + LEFT).clamp(max=LEFT + c + RIGHT)
                past = hi <= lo
                require(bool(past.any()) and not bool(got[past].any()),
                        f"{label}: rows past max_len are not 0")
                rows = f"; {int(past.sum())} chunk rows past max_len are 0"
            msg = (f"{label}: H=8 c={c} dk={dk} L=R={LEFT}, offset {offset}, max_len "
                   f"{seg_len}: max|kernel-plain| {max_err:.3g} (atol {atol}, rtol {rtol}){rows}")
            if segment == "middle" and n == capacity:
                # in turns on the same inputs: tensor cores, CUDA cores, plain
                tc, cc, plain = [], [], []
                for _ in range(2):
                    tc.append(cuda_ms(lambda: chunk_attention_tensor_core(*args, **kw),
                                      iters=50))
                    cc.append(cuda_ms(lambda: chunk_attention_cuda_core(*args, **kw), iters=20))
                    plain.append(cuda_ms(lambda: chunk_attention_plain(*args, **kw), iters=3,
                                         warmup=1))
                bound_ms, bound_by = attention_bound(args, "tf32" if f32 else None)
                ms, cc_ms, plain_ms = (sum(x) / len(x) for x in (tc, cc, plain))
                results[f"attention {name} tensor cores"] = dict(max_abs_err=max_err, ms=ms,
                                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                                    bound_by=bound_by)
                msg += (f"; in turns (2 rounds): tensor cores {ms:.4f} ms "
                        f"({', '.join(f'{x:.4f}' for x in tc)}), CUDA cores {cc_ms:.4f} ms "
                        f"({', '.join(f'{x:.4f}' for x in cc)}), plain {plain_ms:.4f} ms; bound "
                        f"{bound_ms:.4f} ms by {bound_by}")
                if f32:
                    cc_bound, cc_by = attention_bound(args)
                    msg += (f" at the TF32 peak for the three split passes (the same work "
                            f"on the CUDA cores at the f32 peak: {cc_bound:.4f} ms by {cc_by})")
                msg += (f": tensor cores {cc_ms / ms:.1f}x faster than CUDA cores, "
                        f"{ms / bound_ms:.1f}x the bound")
                require(ms < cc_ms, f"{label}: the tensor-core kernel ({ms:.4f} ms) is not "
                        f"faster than the CUDA-core kernel ({cc_ms:.4f} ms)")
            log(msg)

    results.update(check_fbank(device))
    return results


def check_fbank(device):
    """Both fbank kernels against the plain version (float64 inside), held
    to atol 2e-3 + rtol 1e-3 |plain| on 120 s of ``speechlike`` audio from
    ``SEED``, the main path's own 2040 s file (the same draw
    at ``LONG_SECONDS``) and 120 s from ``SEED + 5``. Beside them, the same
    steps in float32 (a plain version with a float32 FFT) against the plain
    version, which is why the plain version computes in float64. On the
    first two the FFT kernel, the DFT kernel and the plain version are timed
    in turns on the same inputs (2 rounds), with ``torch.fft.rfft`` of the
    same float32 windowed frames as a yardstick for the FFT stage (a log line
    only); then both kernels at the lengths of ``batch_decode``'s files, for
    their sums over the main path's four launches. Returns the 2040 s numbers
    of each kernel."""
    from chunkformer_tpu_torch.ops.fbank import (_EPSILON, _PREEMPHASIS, fbank, fbank_dft,
                                                 fbank_fft, fbank_plain, mel_banks, num_frames,
                                                 povey_window)
    from chunkformer_tpu_torch.ops.fbank import route as fbank_route

    require(fbank_route() == "fft", f"16 kHz fbank routed to {fbank_route()}")
    window = torch.from_numpy(povey_window(400)).to(device)
    banks = torch.from_numpy(mel_banks(80, 512, 16000.0)).to(device)
    results = {}
    for seconds, seed, timed in ((120.0, SEED, True), (LONG_SECONDS, SEED, True),
                                 (120.0, SEED + 5, False)):
        wave = torch.from_numpy(speechlike(np.random.default_rng(seed), seconds)
                                .astype(np.float32)).to(device)
        n = num_frames(wave.numel())
        want = fbank_plain(wave)
        bar = 2e-3 + 1e-3 * want.abs()
        tag = f"{seconds:.0f} s of seed {seed}"
        errs = {}
        for name, fn in (("FFT", fbank_fft), ("DFT", fbank_dft)):
            got = fn(wave)
            torch.cuda.synchronize()
            require(got.shape == want.shape == (n, 80), f"fbank {name} shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"fbank {name}: non-finite output")
            err = (got - want).abs()
            errs[name] = float(err.max())
            require(bool((err <= bar).all()), f"fbank {name} kernel, {tag}: max |kernel - plain| "
                    f"{errs[name]:.3g} above atol 2e-3 rtol 1e-3")
        launches = (fbank.launches, fbank.fft_launches)
        routed = fbank(wave)
        require((fbank.launches, fbank.fft_launches) == (launches[0], launches[1] + 1),
                "fbank() did not launch the FFT kernel")
        # the plain steps in float32, and the FFT stage's yardstick on their frames
        frames = wave[: (n - 1) * 160 + 400].unfold(0, 400, 160)
        frames = frames - frames.mean(dim=1, keepdim=True)
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = (frames - _PREEMPHASIS * prev) * window
        f32 = torch.log(torch.clamp_min(
            torch.fft.rfft(frames, n=512, dim=1).abs().square() @ banks, _EPSILON))
        f32_err = (f32 - want).abs()
        del routed, f32, prev
        log(f"fbank: {tag} at 16 kHz ({n} frames): max|kernel-plain| FFT kernel "
            f"{errs['FFT']:.3g}, DFT kernel {errs['DFT']:.3g} (atol 2e-3, rtol 1e-3); the same "
            f"steps in float32 (a float32 FFT): {float(f32_err.max()):.3g}, "
            f"{int((f32_err > bar).sum())} of {f32_err.numel()} values past the bar")
        del want, bar, f32_err
        if not timed:
            del wave, frames
            continue
        long = seconds == LONG_SECONDS
        fft_t, dft_t, plain_t = [], [], []
        for _ in range(2):
            fft_t.append(cuda_ms(lambda: fbank_fft(wave), iters=10 if long else 50))
            dft_t.append(cuda_ms(lambda: fbank_dft(wave), iters=3 if long else 20))
            plain_t.append(cuda_ms(lambda: fbank_plain(wave), iters=2 if long else 5, warmup=1))
        ms, dft_ms, plain_ms = (sum(x) / len(x) for x in (fft_t, dft_t, plain_t))
        bound_ms, bound_by = fbank_bound(wave, n)
        old_bound, old_by = fbank_dft_bound(wave, n)
        rfft_ms = cuda_ms(lambda: torch.fft.rfft(frames, n=512, dim=1), iters=3 if long else 20)
        del frames
        log(f"  {tag}, in turns (2 rounds): FFT kernel {ms:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in fft_t)}), DFT kernel {dft_ms:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in dft_t)}), plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} (the TPU kernel's algorithm, a dense DFT product: "
            f"{old_bound:.4f} ms by {old_by}): FFT kernel {dft_ms / ms:.1f}x faster than the DFT "
            f"kernel, {ms / bound_ms:.1f}x the bound; yardstick, not a port: torch.fft.rfft of "
            f"the same float32 windowed frames, 512 points, {rfft_ms:.4f} ms")
        if long:
            require(ms < dft_ms, f"the FFT fbank kernel ({ms:.4f} ms) is not faster than the DFT "
                    f"kernel ({dft_ms:.4f} ms) at {seconds:.0f} s")
            results["fbank_fft"] = dict(max_abs_err=errs["FFT"], ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by)
            results["fbank"] = dict(max_abs_err=errs["DFT"], ms=dft_ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
            path = [(seconds, ms, dft_ms, bound_ms)]
        del wave
        torch.cuda.empty_cache()
    # the main path's other launches (batch_decode's files), for the kernels'
    # time over the path: sum of time and of time - bound over the 4 launches
    rng = np.random.default_rng(SEED + 6)
    for seconds in BATCH_SECONDS:
        wave = torch.from_numpy(speechlike(rng, seconds).astype(np.float32)).to(device)
        fft_t, dft_t = [], []
        for _ in range(2):
            fft_t.append(cuda_ms(lambda: fbank_fft(wave), iters=50))
            dft_t.append(cuda_ms(lambda: fbank_dft(wave), iters=20))
        path.append((seconds, sum(fft_t) / 2, sum(dft_t) / 2,
                     fbank_bound(wave, num_frames(wave.numel()))[0]))
    log("fbank over the main path's launches (" + ", ".join(f"{p[0]:g} s" for p in path)
        + "): FFT kernel " + ", ".join(f"{p[1]:.4f}" for p in path) + " ms, DFT kernel "
        + ", ".join(f"{p[2]:.4f}" for p in path) + " ms, bound "
        + ", ".join(f"{p[3]:.4f}" for p in path) + f" ms; sums: FFT kernel "
        f"{sum(p[1] for p in path):.4f} ms (time - bound {sum(p[1] - p[3] for p in path):.4f}), "
        f"DFT kernel {sum(p[2] for p in path):.4f} ms (time - bound "
        f"{sum(p[2] - p[3] for p in path):.4f})")
    return results


def write_wav(path, samples):
    from scipy.io import wavfile

    wavfile.write(path, 16000, samples)
    return path


# the decode kernels' and the training attention's launch counts, by the
# names of ops/kernels.py:launch_counts
DECODE_COUNTS = ("chunk_attention", "chunk_attention_tc", "fbank", "fbank_fft")
TRAIN_COUNTS = ("train_fwd", "train_bwd", "train_fwd_tc", "train_bwd_tc")


def reset_counts():
    from chunkformer_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts(*DECODE_COUNTS, "fbank_fft_block")


def read_counts(block_plan=False):
    """The decode kernels' counts by ``DECODE_COUNTS``. The fbank block
    plan's (``fbank_fft_block``, windows above 4096 points) is added where
    ``block_plan``; elsewhere it is required to be 0, as no path but
    ``other_fbank``'s block geometries launches it."""
    from chunkformer_tpu_torch.ops.kernels import launch_counts

    counts = launch_counts()
    if not block_plan:
        require(counts["fbank_fft_block"] == 0,
                f"the fbank block plan ran {counts['fbank_fft_block']} times")
    return {k: counts[k] for k in DECODE_COUNTS + (("fbank_fft_block",) if block_plan else ())}


def main_vocabulary(size):
    """The main path's {id: symbol} table."""
    return {0: "<blank>", **{i: f"w{i}▁" if i % 7 == 0 else chr(0x4E00 + i)
                             for i in range(1, size)}}


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
    char_dict = main_vocabulary(cfg.vocab_size)

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
    # bf16 attention goes through the tensor cores only
    require(endless_counts["chunk_attention_tc"] == n_layers * n_seg
            and endless_counts["chunk_attention"] == 0,
            f"endless_decode launched chunk attention {endless_counts}, expected "
            f"{n_layers} x {n_seg} on the tensor cores and none on the CUDA cores")
    # features through the FFT kernel only: one launch for the file, one a batch file
    require(endless_counts["fbank_fft"] == 1 and endless_counts["fbank"] == 0,
            f"endless_decode launched fbank {endless_counts}, expected the FFT kernel once")
    require(batch_counts["chunk_attention_tc"] == n_layers
            and batch_counts["chunk_attention"] == 0 and batch_counts["fbank_fft"] == 3
            and batch_counts["fbank"] == 0, f"batch_decode launches {batch_counts}")
    require(len(texts) == 3 and all(isinstance(t, str) for t in texts), "batch_decode output")
    require(len(segments) > 0 and all(s["decode"] for s in segments), "endless_decode output")
    # the bf16 frame tokens of the same endless_decode, for the flip rate below:
    # through the kernels, and through the plain attention (f32 inside) as the
    # baseline of the bf16 model's own flips
    feats = bf16.extract_features(long_wav)
    bf16_tokens = bf16.endless_encode_tokens(feats, C, LEFT, RIGHT, BUDGET)
    from chunkformer_tpu_torch.nn import attention as attention_module
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain

    routed = attention_module.chunk_attention
    attention_module.chunk_attention = chunk_attention_plain
    try:
        bf16_plain_tokens = bf16.endless_encode_tokens(feats, C, LEFT, RIGHT, BUDGET)
    finally:
        attention_module.chunk_attention = routed
    del bf16, feats
    torch.cuda.empty_cache()

    # ---- f32: segmented == single-shot, and card == CPU on a small input
    f32 = ChunkFormerModel(cfg, sd, None, dtype=torch.float32, device=device)
    # the single-shot run records each frame's f32 top-1/top-2 log-prob gap
    gaps = []
    argmax = f32.model.ctc.argmax

    def argmax_with_gap(out):
        top2 = torch.log_softmax(f32.model.ctc.ctc_lo(out).float(), -1).topk(2, dim=-1).values
        gaps.append((top2[..., 0] - top2[..., 1]).reshape(-1).cpu().numpy())
        return argmax(out)

    reset_counts()
    endless = f32.endless_decode(long_wav, C, LEFT, RIGHT, BUDGET)
    f32.model.ctc.argmax = argmax_with_gap
    single = f32.batch_decode([long_wav], C, LEFT, RIGHT, BUDGET)[0]
    f32.model.ctc.argmax = argmax
    counts = read_counts()
    # f32 attention at the main path's shapes goes through the tensor cores
    # (the 3xTF32 kernel) only
    require(counts == {"chunk_attention": 0, "chunk_attention_tc": n_layers * (n_seg + 1),
                       "fbank": 0, "fbank_fft": 2}, f"f32 launches {counts}")
    require(endless.shape == single.shape == bf16_tokens.shape
            == (int(chunk_ops.calc_length(t_total)),),
            f"token counts {endless.shape} {single.shape} {bf16_tokens.shape}")
    require(bool(((endless >= 0) & (endless < cfg.vocab_size)).all()), "token ids out of range")
    mismatch = float(np.mean(endless != single))
    log(f"f32 endless vs single-shot batch on the same audio: {endless.size} frames, "
        f"token mismatch {mismatch:.5f} (limit 0.01); launches {counts}")
    require(mismatch <= 0.01, f"endless vs batch mismatch {mismatch} above 1%")
    gap = np.concatenate(gaps)[:endless.size]

    # the same f32 endless_decode with the CUDA-core kernel swapped in for the
    # routed attention: the 3xTF32 kernel may move a token only where the f32
    # top-1/top-2 log-prob gap is below 1e-3
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_cuda_core

    feats = f32.extract_features(long_wav)
    routed = attention_module.chunk_attention
    attention_module.chunk_attention = chunk_attention_cuda_core
    reset_counts()
    try:
        cc_tokens = f32.endless_encode_tokens(feats, C, LEFT, RIGHT, BUDGET)
    finally:
        attention_module.chunk_attention = routed
    cc_counts = read_counts()
    require(cc_counts == {"chunk_attention": n_layers * n_seg, "chunk_attention_tc": 0,
                          "fbank": 0, "fbank_fft": 0}, f"f32 CUDA-core route launches {cc_counts}")
    require(cc_tokens.shape == endless.shape, f"token counts {cc_tokens.shape} {endless.shape}")
    route_flips = cc_tokens != endless
    clear_flips = int((route_flips & (gap >= 1e-3)).sum())
    log(f"f32 endless_decode CTC tokens, tensor-core route (3xTF32) vs CUDA-core route: "
        f"{int(route_flips.sum())} of {route_flips.size} frames differ, {clear_flips} of them "
        f"where the f32 top-1/top-2 log-prob gap is 1e-3 or more (limit 0); frames with a gap "
        f"below 1e-3: {int((gap < 1e-3).sum())}; CUDA-core route launches {cc_counts}")
    require(clear_flips == 0, f"{clear_flips} f32 tokens differ between the attention routes on "
            "frames whose top-1/top-2 gap is at least 1e-3")

    # the same f32 endless_decode from the DFT kernel's features: the FFT
    # kernel may move a token only where the f32 top-1/top-2 gap is below 1e-3
    from chunkformer_tpu_torch import api as api_module
    from chunkformer_tpu_torch.ops.fbank import fbank_dft

    routed_fbank = api_module.fbank
    api_module.fbank = fbank_dft
    reset_counts()
    try:
        dft_feats = f32.extract_features(long_wav)
        dft_tokens = f32.endless_encode_tokens(dft_feats, C, LEFT, RIGHT, BUDGET)
    finally:
        api_module.fbank = routed_fbank
    dft_counts = read_counts()
    require(dft_counts == {"chunk_attention": 0, "chunk_attention_tc": n_layers * n_seg,
                           "fbank": 1, "fbank_fft": 0}, f"f32 DFT-feature launches {dft_counts}")
    feat_err = float((dft_feats - feats).abs().max())
    fbank_flips = dft_tokens != endless
    clear_fbank_flips = int((fbank_flips & (gap >= 1e-3)).sum())
    log(f"f32 endless_decode CTC tokens, FFT-kernel features vs DFT-kernel features (max "
        f"|FFT - DFT| {feat_err:.3g} over {tuple(feats.shape)}): {int(fbank_flips.sum())} of "
        f"{fbank_flips.size} frames differ, {clear_fbank_flips} of them where the f32 "
        f"top-1/top-2 log-prob gap is 1e-3 or more (limit 0); launches {dft_counts}")
    require(dft_tokens.shape == endless.shape, f"token counts {dft_tokens.shape} {endless.shape}")
    require(clear_fbank_flips == 0, f"{clear_fbank_flips} f32 tokens differ between FFT and DFT "
            "features on frames whose top-1/top-2 gap is at least 1e-3")
    del feats, dft_feats

    # bf16 against f32 tokens of endless_decode, PARITY.md round 4's 1% bar;
    # the f32 reference runs its attention on the 3xTF32 tensor-core kernel.
    # Random weights leave near-tie frames (f32 top-1/top-2 log-prob gap below
    # 1e-2), where rounding the logits to bf16 decides the token; so the bar is
    # held on the other frames, and the whole rate is printed beside the same
    # bf16 model's rate through the plain attention (no kernel). A fault of the
    # kernels would flip confident frames, or rise above that baseline.
    near = gap < 1e-2
    flips = bf16_tokens != endless
    flips_plain = bf16_plain_tokens != endless
    flip_rate, plain_rate = float(np.mean(flips)), float(np.mean(flips_plain))
    clear_rate = float(np.mean(flips[~near]))
    log(f"bf16 vs f32 endless_decode CTC tokens (f32 attention on the 3xTF32 tensor-core "
        f"kernel), {flips.size} frames: through the kernels "
        f"{int(flips.sum())} flipped, rate {flip_rate:.5f}; through the plain attention "
        f"{int(flips_plain.sum())}, rate {plain_rate:.5f}. f32 top-1/top-2 log-prob gap below "
        f"1e-2 on {float(np.mean(near)):.5f} of frames, which hold {int((flips & near).sum())} "
        f"of the kernels' flips; on the other frames the rate is {clear_rate:.5f} (limit < "
        f"0.01); flips where the gap is 0.1 or more: {int((flips & (gap >= 0.1)).sum())}; "
        f"median gap {float(np.median(gap)):.4g}")
    require(clear_rate < 0.01, f"bf16 vs f32 token-flip rate {clear_rate} on frames that are "
            "not near ties is not below 1%")
    require(flip_rate <= plain_rate + 0.005, f"the kernels' bf16 flip rate {flip_rate} is more "
            f"than 0.005 above the plain attention's {plain_rate}")

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
    return main_counts, counts, capacity, (cfg, sd, long_wav)


def train_attention_inputs(dtype, gen, dev):
    """Operands of the training attention at the flagship train shape: B = 32
    utterances of 1600 frames (199 subsampled), n = 4 chunks of 64, L = R =
    128, H = 8, dk = 64; the stream's pad rows are zero as in the encoder."""
    from chunkformer_tpu_torch.nn.encoder import subsampled_lengths

    h, dk = TRAIN["encoder_conf"]["attention_heads"], 64
    lens = subsampled_lengths(torch.full((TRAIN_BATCH,), TRAIN_FRAMES, device=dev))
    n = -(-int(lens.max()) // C)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    kv = rnd(TRAIN_BATCH, LEFT + n * C + RIGHT, h, 2 * dk)
    kv[:, :LEFT] = 0
    kv[:, LEFT + n * C:] = 0
    return [rnd(TRAIN_BATCH, n * C, h, dk), kv, rnd(2 * C - 1 + LEFT + RIGHT, h, dk),
            rnd(h, dk), rnd(h, dk), lens]


def train_attention_bounds(args, backward: bool, peak=None, c=C, left=LEFT, right=RIGHT):
    """Least time on an H100 SXM. Bytes: each input read once over the rows
    the function needs, each output written once whole. Of utterance b the
    function needs the key stream's rows of frames [0, lens[b]) only (the L
    and R pad rows and the frames past the length enter no valid window) and
    the query rows below lens[b] of q, and in the backward of ctx, dctx, m
    and den; p, u, v and lens it reads whole. Outputs: forward ctx, m, den;
    backward dq, dkv, dp, du, dv, the gradients in the input dtype.
    Operations over this data's valid (query, key) pairs, 2 per multiply-add:
    the forward's three dk-long products (content, position, context), the
    backward's eight (recomputed content and position scores, dA, dq from
    both branches, dK, dV, dP), at the peak of the operands' dtype, or with
    ``peak="tf32"`` as the three TF32 passes of the split products at the
    TF32 tensor-core peak (f32-accurate work on the tensor cores)."""
    q, kv, p, u, v, lens = args
    b, tp, h, dk = q.shape
    item = q.element_size()
    frames = int(lens.clamp(max=tp).sum())          # valid (utterance, frame) rows
    row, stat_row = h * dk * item, h * 4            # one frame of q, ctx or dctx; of m or den
    params = (p.numel() + u.numel() + v.numel()) * item
    reads = frames * 3 * row + params + b * 4       # q rows, kv rows (k | v), p, u, v, lens
    writes = b * tp * row + 2 * b * tp * stat_row   # ctx, m, den
    if backward:                                    # + ctx, dctx, m, den rows in
        reads += frames * (2 * row + 2 * stat_row)
        writes = b * tp * row + kv.numel() * item + params   # dq, dkv, dp, du, dv
    pairs = 0
    for ln in lens.tolist():
        for ci in range(tp // c):
            rows = min(c, max(0, ln - ci * c))
            keys = max(0, min(left + c + right, ln - ci * c + left) - max(0, left - ci * c))
            pairs += rows * keys
    ops = pairs * h * dk * 2 * (8 if backward else 3)
    t_bytes = (reads + writes) / H100_BYTES_PER_S
    t_ops = 3 * ops / H100_PEAK["tf32"] if peak == "tf32" else ops / H100_PEAK[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def train_bwd_scratch_bytes(args, ctx, m, den, dctx, st, path):
    """Bytes one backward launch of ``path`` allocates beyond its outputs (dq,
    dkv, dp, du, dv), from the caching allocator's count of the bytes
    allocated during the call: its f32 partial buffers and delta [B, H, n*c]."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    key = "allocated_bytes.all.allocated"
    before = torch.cuda.memory_stats()[key]
    outs = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path=path)
    total = torch.cuda.memory_stats()[key] - before
    return total - sum(t.numel() * t.element_size() for t in outs)


def phase_train_kernels(device):
    """B4 (forward) and B5 (backward) against their plain versions at the
    flagship train shape, f32 and bf16 at p = 0 and 0.1, each on the
    tensor-core route (the main path's: bf16 kernels, or the 3xTF32 f32
    kernels) and on the CUDA-core route (the other shapes' route, and the
    tensor cores' yardstick), both held to the bars of the dtype. Forward:
    ctx f32 atol 1e-5 (bf16 atol 1e-2 + one bf16 ulp relative), m and den
    rtol 1e-5 (bf16 1e-2). Backward: the gradients of q, kv, p, u and v
    through the kernels against autograd through the plain forward, f32 atol
    1e-4 rtol 1e-5, bf16 relative L2 1e-2. At p = 0.1 a single keep-mask
    difference would move a context row by a whole weight, far above these
    bounds, so agreement means identical masks. The tensor-core backward runs
    twice, bitwise equal. Times are taken in turns on the same inputs
    (tensor cores, CUDA cores, plain)."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    results = {}
    seed = 20260
    path = "tensor_core"
    for dtype, drop in ((torch.float32, 0.0), (torch.bfloat16, 0.0), (torch.float32, 0.1),
                        (torch.bfloat16, 0.1)):
        label = f"train attention {'bf16' if dtype == torch.bfloat16 else 'f32'} p={drop}"
        bf16 = dtype == torch.bfloat16
        args = train_attention_inputs(dtype, gen, device)
        require(cat.route(*args[:3], C) == path,
                f"{label}: routed to {cat.route(*args[:3], C)}")
        st = (seed, C, LEFT, RIGHT, drop)
        want = cat.forward_plain(*args, *st)
        dctx = torch.randn(want[0].shape, generator=gen, device=device).to(dtype)
        leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
        want_g = torch.autograd.grad(cat.forward_plain(*leaves, args[5], *st)[0], leaves, dctx)
        # the CUDA-core kernels (the route of the other shapes) are held to the
        # same bars on the same inputs
        errs, fwd_out = {}, {}
        for route in (path, "cuda_core"):
            tag = f"{label} ({route.replace('_', '-')} route)"
            ctx, m, den = fwd_out[route] = cat.forward_kernel(*args, *st, path=route)
            torch.cuda.synchronize()
            fwd_err = float((ctx.float() - want[0].float()).abs().max())
            require(all(bool(torch.isfinite(t).all()) for t in (ctx, m, den)),
                    f"{tag}: non-finite forward output")
            tol = (1e-2 + 2.0 ** -7 * want[0].float().abs()) if bf16 else 1e-5
            require(bool(((ctx.float() - want[0].float()).abs() <= tol).all()),
                    f"{tag}: forward max |kernel - plain| {fwd_err:.3g}")
            for name, got_s, want_s in (("m", m, want[1]), ("den", den, want[2])):
                rel = float(((got_s - want_s).abs() / want_s.abs().clamp_min(1e-30)).max())
                require(rel <= (1e-2 if bf16 else 1e-5), f"{tag}: {name} relative error {rel:.3g}")

            leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
            entry = (cat.chunk_train_attention if route == path
                     else cat.chunk_train_attention_cuda_core)
            counts = read_train_counts()
            out = entry(*leaves, args[5], seed, chunk=C, left=LEFT, right=RIGHT, drop_rate=drop)
            got_g = torch.autograd.grad(out, leaves, dctx)
            torch.cuda.synchronize()
            moved = {k: v - counts[k] for k, v in read_train_counts().items()}
            key = "_tc" if route == "tensor_core" else ""
            require(moved == {"fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0,
                              f"fwd{key}": 1, f"bwd{key}": 1},
                    f"{tag}: launches {moved}, expected one forward and one backward")
            bwd_err, rels = 0.0, {}
            for name, a, e in zip(("q", "kv", "p", "u", "v"), got_g, want_g):
                require(bool(torch.isfinite(a).all()), f"{tag}: non-finite d{name}")
                err = (a.float() - e.float()).abs()
                bwd_err = max(bwd_err, float(err.max()))
                if bf16:
                    rel = float((a.float() - e.float()).norm() / e.float().norm())
                    rels[name] = rel
                    require(rel <= 1e-2, f"{tag}: d{name} relative L2 error {rel:.3g}")
                else:
                    require(bool((err <= 1e-4 + 1e-5 * e.float().abs()).all()),
                            f"{tag}: d{name} max |kernel - plain| {float(err.max()):.3g}")
            errs[route] = (fwd_err, bwd_err, rels)
            del out, got_g
        ctx, m, den = fwd_out[path]
        kept = (float(cat.window_keep_mask(seed, args[5], args[0].shape[1] // C, 8, C,
                                           LEFT + C + RIGHT, drop).float().mean())
                if drop else 1.0)
        # the tensor cores' bound: bf16 at its peak; f32 as three TF32 passes
        # (the same work at the f32 CUDA-core peak is the CUDA-core kernels' bound)
        bounds = {r: (train_attention_bounds(args, False, "tf32" if r == path and not bf16
                                             else None),
                      train_attention_bounds(args, True, "tf32" if r == path and not bf16
                                             else None))
                  for r in (path, "cuda_core")}
        scratch_mb = train_bwd_scratch_bytes(args, ctx, m, den, dctx, st, path) / 1e6
        require(scratch_mb <= 25.0,
                f"{label}: the tensor-core backward allocates {scratch_mb:.2f} MB of f32 "
                "partials and delta")
        msg = (f"{label}: B={TRAIN_BATCH} T'={args[0].shape[1]} H=8 c={C} dk=64 L=R={LEFT}, "
               f"keep share {kept:.4f}; " + "; ".join(
                   f"{r.replace('_', '-')} route forward max|kernel-plain| {e[0]:.3g}, "
                   f"backward max|kernel-plain| {e[1]:.3g}" + (", relative L2 " + ", ".join(
                       f"d{k} {x:.3g}" for k, x in e[2].items()) if e[2] else "")
                   for r, e in errs.items())
               + f"; f32 scratch of the tensor-core backward (partials and delta, allocator "
               f"count) {scratch_mb:.2f} MB")
        # determinism: the same backward twice, bitwise
        b1 = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path=path)
        b2 = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path=path)
        require(all(torch.equal(x, y) for x, y in zip(b1, b2)),
                f"{label}: two tensor-core backward runs differ")
        del b1, b2
        # in turns on the same inputs: tensor cores, CUDA cores, plain
        cc_ctx, cc_m, cc_den = fwd_out["cuda_core"]
        times = {k: [] for k in ("tc_f", "cc_f", "pl_f", "tc_b", "cc_b", "pl_b")}
        for _ in range(2):
            times["tc_f"].append(cuda_ms(lambda: cat.forward_kernel(
                *args, *st, path="tensor_core"), iters=20))
            times["cc_f"].append(cuda_ms(lambda: cat.forward_kernel(
                *args, *st, path="cuda_core"), iters=10))
            times["pl_f"].append(cuda_ms(lambda: cat.forward_plain(*args, *st), iters=3,
                                         warmup=1))
            times["tc_b"].append(cuda_ms(lambda: cat.backward_kernel(
                *args, ctx, m, den, dctx, *st, path="tensor_core"), iters=20))
            times["cc_b"].append(cuda_ms(lambda: cat.backward_kernel(
                *args, cc_ctx, cc_m, cc_den, dctx, *st, path="cuda_core"), iters=10))
            times["pl_b"].append(cuda_ms(lambda: cat.backward_plain(
                *args, m, den, dctx, *st), iters=3, warmup=1))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        results[label] = {
            r: {part: dict(max_abs_err=errs[r][i], ms=mean[f"{x}_{part[0]}"],
                           plain_ms=mean[f"pl_{part[0]}"], bound_ms=bounds[r][i][0],
                           bound_by=bounds[r][i][1])
                for i, part in enumerate(("fwd", "bwd"))}
            for r, x in ((path, "tc"), ("cuda_core", "cc"))}
        for i, (part, t, c) in enumerate((("forward", "tc_f", "cc_f"),
                                          ("backward", "tc_b", "cc_b"))):
            (bound, by), (cc_bound, cc_by) = bounds[path][i], bounds["cuda_core"][i]
            pl = "pl_" + t[-1]
            msg += (f"; {part} in turns (2 rounds): tensor cores {mean[t]:.4f} ms "
                    f"({', '.join(f'{x:.4f}' for x in times[t])}), CUDA cores "
                    f"{mean[c]:.4f} ms ({', '.join(f'{x:.4f}' for x in times[c])}), plain "
                    f"{mean[pl]:.4f} ms, bound {bound:.4f} ms by {by}"
                    + ("" if bf16 else f" at the TF32 peak for the three split passes (at the "
                       f"f32 CUDA-core peak: {cc_bound:.4f} ms by {cc_by})")
                    + f": tensor cores {mean[c] / mean[t]:.1f}x faster than CUDA cores, "
                    f"{mean[t] / bound:.1f}x the bound")
            require(mean[t] < mean[c], f"{label}: the tensor-core {part} ({mean[t]:.4f} ms) is "
                    f"not faster than the CUDA-core one ({mean[c]:.4f} ms)")
        cc_mb = train_bwd_scratch_bytes(args, cc_ctx, cc_m, cc_den, dctx, st, "cuda_core") / 1e6
        msg += (f"; f32 scratch of the CUDA-core backward {cc_mb:.2f} MB; tensor-core backward "
                "bitwise deterministic over two runs")
        log(msg)
        del args, ctx, m, den, want, dctx, want_g, leaves, fwd_out, cc_ctx, cc_m, cc_den
        torch.cuda.empty_cache()
    return results


def train_batch(cfg, device, seed):
    """Seeded synthetic features [B, 1600, 80] and targets [B, 48] on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, 80, generator=gen, device=device)
    lens = torch.full((TRAIN_BATCH,), TRAIN_FRAMES, dtype=torch.int32, device=device)
    targets = torch.randint(1, cfg.vocab_size - 2, (TRAIN_BATCH, TRAIN_LABELS), generator=gen,
                            device=device)
    tlens = torch.full((TRAIN_BATCH,), TRAIN_LABELS, dtype=torch.int32, device=device)
    return feats, lens, targets, tlens


def reset_train_counts():
    from chunkformer_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts(*TRAIN_COUNTS)


def read_train_counts():
    """The training attention's counts, keyed without the ``train_``."""
    from chunkformer_tpu_torch.ops.kernels import launch_counts

    counts = launch_counts()
    return {k[len("train_"):]: counts[k] for k in TRAIN_COUNTS}


def new_trainer(train_dict, device, autocast, chunk=None):
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step

    cfg = ChunkFormerConfig.from_dict(train_dict)
    model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(SEED)).to(device)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                 {"warmup_steps": 25000})
    step = make_train_step(model, cfg, opt, sched, chunk or (C, LEFT, RIGHT), autocast=autocast,
                           grad_clip=GRAD_CLIP)
    return cfg, model, step


def no_dropout(train_dict):
    """train_dict with every dropout of the encoder and decoder at 0."""
    return {**train_dict, "encoder_conf": {**train_dict["encoder_conf"], "dropout_rate": 0.0,
                                           "positional_dropout_rate": 0.0,
                                           "attention_dropout_rate": 0.0},
            "decoder_conf": {**train_dict["decoder_conf"], "dropout_rate": 0.0,
                             "positional_dropout_rate": 0.0}}


def rel_l2(a, b, names):
    """Relative L2 distance of the gradient dicts a and b over ``names``."""
    num = torch.sqrt(sum((a[n] - b[n]).square().sum() for n in names))
    return float(num / torch.sqrt(sum(b[n].square().sum() for n in names)))


def bf16_step_routes(train_dict, device, batch, n_layers, recompute,
                     routes=("tensor_core", "cuda_core"), chunk=None):
    """One bf16 step (autocast, dropout 0, seeded weights and batch) through
    each of ``routes``, the tensor-core route and the CUDA-core route (its
    baseline), and through the plain attention, at ``chunk`` ((c, L, R);
    the flagship's by default): the loss difference and the whole-gradient
    relative L2 of each route against the plain attention, each gated at
    1e-2 (the single-op bf16 bar). Returns them and each route's launch
    counts."""
    from chunkformer_tpu_torch.nn import attention as attention_module
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    runs = {}
    for route in (*routes, "plain"):
        _, model, step = new_trainer(no_dropout(train_dict), device, torch.bfloat16, chunk)
        if route == "plain":
            for layer in model.encoder.encoders:
                layer.self_attn.chunked_train = layer.self_attn.attention_chunked_train
        routed = attention_module.chunk_train_attention
        if route == "cuda_core":
            attention_module.chunk_train_attention = cat.chunk_train_attention_cuda_core
        reset_train_counts()
        try:
            m = step(*batch)
        finally:
            attention_module.chunk_train_attention = routed
        unclip = max(1.0, float(m["grad_norm"]) / GRAD_CLIP)   # .grad is clipped in place
        grads = {n: p.grad.detach().float() * unclip for n, p in model.named_parameters()}
        runs[route] = (float(m["loss"]), grads, read_train_counts())
        del model, step
        torch.cuda.empty_cache()
    loss_p, g_p, counts_p = runs["plain"]
    names = list(g_p)
    stats = {r: (abs(runs[r][0] - loss_p) / abs(loss_p), rel_l2(runs[r][1], g_p, names))
             for r in routes}
    log(f"train bf16 step (dropout 0, (c, L, R) = {chunk or (C, LEFT, RIGHT)}) against the "
        "same step through the plain attention: "
        + "; ".join(f"{r.replace('_', '-')} route loss {runs[r][0]:.8g} vs {loss_p:.8g}, "
                    f"relative difference {stats[r][0]:.3g}, whole-gradient relative L2 "
                    f"{stats[r][1]:.3g}, launches {runs[r][2]}" for r in stats)
        + " (limit 1e-2 for each route)")
    require(all(np.isfinite(runs[r][0]) for r in runs), "non-finite bf16 loss")
    for r, (_, rel) in stats.items():
        require(rel <= 1e-2, f"bf16 step on the {r} route: whole-gradient relative L2 "
                f"{rel:.3g} against the plain attention, above 1e-2")
    none = {"fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
    want = {"tensor_core": {**none, "fwd_tc": n_layers * recompute, "bwd_tc": n_layers},
            "cuda_core": {**none, "fwd": n_layers * recompute, "bwd": n_layers}}
    for r in routes:
        require(runs[r][2] == want[r], f"bf16 step on the {r} route launched {runs[r][2]}")
    require(counts_p == none, f"plain bf16 step launched {counts_p}")
    return stats, {r: runs[r][2] for r in routes}


def f32_step_routes(train_dict, device, batch, n_layers, recompute,
                    routes=("tensor_core", "cuda_core"), chunk=None):
    """One f32 step (TF32 off, dropout 0) through each of ``routes`` of the
    training attention, the tensor cores (the main path's, 3xTF32) and the
    CUDA cores, against the same step through the plain attention, at
    ``chunk`` ((c, L, R); the flagship's by default). Each route's
    sensitivity baseline is the plain route with its encoder output scaled by
    (1 + eps * z), z ~ N(0, 1) from a seed and eps that route's measured
    relative difference at the encoder output. Bars, each route: loss 1e-5;
    whole gradient and each of encoder, CTC head, decoder 1e-4 relative L2;
    each parameter within 1e-4, or, where the step's f32 sensitivity is
    larger, within 3x its own baseline difference + 1e-5, never above 1e-2.
    Launches: the tensor-core route's kernels only on each route. Returns
    the tensor-core route's launch counts."""
    from chunkformer_tpu_torch.nn import attention as attention_module
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    f32_dict = no_dropout(train_dict)
    runs, enc_out = {}, {}

    def run(route, eps=0.0):
        _, model, step = new_trainer(f32_dict, device, None, chunk)
        if route.startswith("plain"):
            for layer in model.encoder.encoders:
                layer.self_attn.chunked_train = layer.self_attn.attention_chunked_train
        forward_train = model.encoder.forward_train

        def watched(*a, **k):
            out, mask = forward_train(*a, **k)
            if eps:
                z = torch.randn(out.shape, generator=torch.Generator(device=out.device)
                                .manual_seed(SEED + 4), device=out.device)
                out = out * (1 + eps * z)
            enc_out[route] = out.detach().clone()
            return out, mask

        model.encoder.forward_train = watched
        routed = attention_module.chunk_train_attention
        if route == "cuda_core":
            attention_module.chunk_train_attention = cat.chunk_train_attention_cuda_core
        reset_train_counts()
        try:
            m = step(*batch)
        finally:
            attention_module.chunk_train_attention = routed
        unclip = max(1.0, float(m["grad_norm"]) / GRAD_CLIP)   # .grad is clipped in place
        grads = {n: p.grad.detach() * unclip for n, p in model.named_parameters()}
        runs[route] = (float(m["loss"]), grads, read_train_counts())
        del model, step
        if device.type == "cuda":
            torch.cuda.empty_cache()

    run("plain")
    loss_p, g_p, counts_p = runs["plain"]
    none = {"fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
    require(counts_p == none or device.type != "cuda", f"plain f32 step launched {counts_p}")
    groups = {g: [n for n in g_p if n.startswith(g + ".")] for g in ("encoder", "ctc", "decoder")}
    # per parameter, relative to its own gradient norm floored at 1e-6 of the
    # whole gradient's: the key biases' gradients are zero in exact arithmetic
    # (a shift shared by all keys of a softmax row), float noise on any route
    floor = 1e-6 * float(torch.sqrt(sum(g.square().sum() for g in g_p.values())))

    def per_param(a):
        return sorted(((float((a[n] - g_p[n]).norm()) / max(float(g_p[n].norm()), floor), n)
                       for n in g_p), reverse=True)

    for route in routes:
        name = route.replace("_", "-")
        run(route)
        eps = float((enc_out[route] - enc_out["plain"]).norm() / enc_out["plain"].norm())
        base_route = f"plain, perturbed as the {name} route"
        run(base_route, eps)
        loss_k, g_k, counts_k = runs[route]
        g_n = runs[base_route][1]
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        group_rel = {g: rel_l2(g_k, g_p, names) for g, names in groups.items()}
        whole_rel = rel_l2(g_k, g_p, list(g_p))
        worst_k, worst_n = per_param(g_k), per_param(g_n)
        base = {n: r for r, n in worst_n}
        over = [(r, n) for r, n in worst_k if r > 1e-4]
        unexplained = [(r, n, base[n]) for r, n in over if r > 3 * base[n] + 1e-5 or r > 1e-2]
        log(f"train f32 step at (c, L, R) = {chunk or (C, LEFT, RIGHT)}, {name} route vs plain "
            f"attention: loss {loss_k:.8g} vs "
            f"{loss_p:.8g}, relative difference {loss_rel:.3g} (limit 1e-5); encoder output "
            f"relative L2 difference {eps:.3g}; gradient relative L2 difference: whole "
            f"{whole_rel:.3g}, " + ", ".join(f"{g} {v:.3g}" for g, v in group_rel.items())
            + f" (limit 1e-4 each); per parameter worst {worst_k[0][0]:.3g} at {worst_k[0][1]}, "
            f"{len(over)} of {len(worst_k)} above 1e-4, each within 3x its baseline + 1e-5 and "
            f"1e-2; launches {counts_k} vs {counts_p}")
        log(f"  sensitivity baseline, plain route with its encoder output perturbed by relative "
            f"{eps:.3g}: gradient relative L2 difference whole {rel_l2(g_n, g_p, list(g_p)):.3g}, "
            f"per parameter worst {worst_n[0][0]:.3g} at {worst_n[0][1]}, "
            f"{sum(1 for r, _ in worst_n if r > 1e-4)} of {len(worst_n)} above 1e-4")
        for r, n in worst_k[:5]:
            log(f"  {name} route vs plain {r:.3g} (baseline {base[n]:.3g}) {n}")
        require(np.isfinite(loss_k) and loss_rel <= 1e-5,
                f"f32 loss on the {name} route differs by {loss_rel}")
        require(whole_rel <= 1e-4 and max(group_rel.values()) <= 1e-4,
                f"f32 gradients on the {name} route differ: whole {whole_rel}, groups {group_rel}")
        require(not unexplained, f"f32 gradients on the {name} route differ beyond 1e-4 and "
                "their baselines (difference, name, baseline): " + ", ".join(
                    f"{r:.3g} {n} {b:.3g}" for r, n, b in unexplained[:5]))
        if device.type == "cuda":
            key = "_tc" if route == "tensor_core" else ""
            want = {**none, f"fwd{key}": n_layers * recompute, f"bwd{key}": n_layers}
            require(counts_k == want, f"f32 step on the {name} route launched {counts_k}, "
                    f"expected {want}")
    return runs["tensor_core"][2]


def phase_train(card, device, train_dict=TRAIN):
    """The train path: TRAIN_STEPS bf16 steps of the flagship configuration
    (dropout on, from a seeded generator), with the training attention's
    launch counts read around them (tensor-core kernels only); then
    ``f32_step_routes`` (the f32 step through each route against the plain
    attention; the main path's route, the tensor cores, launched alone);
    then ``bf16_step_routes``.
    Returns the bf16 and the f32 launch counts, the bf16 step time and the
    peak memory."""
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention
    from chunkformer_tpu_torch.ops.fbank import fbank

    cfg, model, step = new_trainer(train_dict, device, torch.bfloat16)
    n_layers = cfg.encoder_conf.num_blocks
    recompute = 2 if cfg.encoder_conf.remat_policy == "nothing" else 1
    before = [p.detach().clone() for p in model.parameters()]
    batch = train_batch(cfg, device, SEED + 2)
    gen = torch.Generator().manual_seed(SEED + 3)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    decode_counts = (chunk_attention.launches, chunk_attention.tc_launches, fbank.launches,
                     fbank.fft_launches)
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        m = step(*batch, gen)
        m = {k: float(v) for k, v in m.items()}
        times.append(time.time() - t0)
        metrics.append(m)
    counts = read_train_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 if device.type == "cuda" else 0.0
    audio_s = TRAIN_BATCH * TRAIN_FRAMES / 100.0
    warm = times[1:] if len(times) > 1 else times
    step_s = sum(warm) / len(warm)
    for i, (t, m) in enumerate(zip(times, metrics)):
        log(f"train step {i + 1} bf16: {1e3 * t:.1f} ms, " + ", ".join(
            f"{k} {v:.5g}" for k, v in m.items()))
    log(f"train bf16 (B={TRAIN_BATCH} x {TRAIN_FRAMES} frames, U={TRAIN_LABELS}, "
        f"{n_layers} blocks, remat {cfg.encoder_conf.remat_policy}): {1e3 * step_s:.1f} ms a "
        f"step over steps 2-{TRAIN_STEPS}, {audio_s / step_s:.1f} train audio-s/s (first step "
        f"{1e3 * times[0]:.1f} ms); peak device memory {peak_gib:.2f} GiB; launches {counts}; "
        f"card {card}")
    for m in metrics:
        require(all(np.isfinite(m[k]) for k in ("loss", "loss_ctc", "loss_att", "grad_norm")),
                f"non-finite train metrics {m}")
    # adamw decays every parameter, so a move alone does not show a gradient
    no_grad = [name for name, p in model.named_parameters()
               if p.grad is None or not float(p.grad.float().norm()) > 0.0]
    require(not no_grad, f"parameters with no or zero gradient: {no_grad[:5]}")
    still = [name for (name, p), b in zip(model.named_parameters(), before)
             if torch.equal(p.detach(), b)]
    require(not still, f"parameters that did not move: {still[:5]}")
    if device.type == "cuda":
        # bf16 training attention goes through the tensor cores only
        want = {"fwd": 0, "bwd": 0, "fwd_tc": n_layers * TRAIN_STEPS * recompute,
                "bwd_tc": n_layers * TRAIN_STEPS}
        require(counts == want, f"train launches {counts}, expected {want}")
        require((chunk_attention.launches, chunk_attention.tc_launches, fbank.launches,
                 fbank.fft_launches) == decode_counts,
                "the train path launched a decode kernel")
    del model, step, before
    if device.type == "cuda":
        torch.cuda.empty_cache()

    counts_k = f32_step_routes(train_dict, device, batch, n_layers, recompute)
    bf16_step_routes(train_dict, device, batch, n_layers, recompute)
    return counts, counts_k, step_s, peak_gib


# ---- the search path: recognize at ChunkFormer-large width with the 3 + 3
# bitransformer decoder of the flagship train config
SEARCH = {**LARGE, "decoder": TRAIN["decoder"], "decoder_conf": TRAIN["decoder_conf"],
          "model_conf": TRAIN["model_conf"]}
SEARCH_SECONDS = (4.0, 9.5, 13.2, 17.8, 22.1, 27.4, 33.6, 40.0)
SEARCH_MODES = ("ctc_greedy_search", "ctc_prefix_beam_search",
                "ctc_prefix_beam_search_batched", "attention", "attention_rescoring")
BEAM, CTC_WEIGHT, REVERSE_WEIGHT = 10, 0.3, 0.3


class LogLines(logging.Handler):
    """Collects the messages the CLIs log (their wall-time line)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def wav_features(path, device):
    from scipy.io import wavfile

    from chunkformer_tpu_torch.ops.fbank import fbank

    return fbank(torch.from_numpy(wavfile.read(path)[1].astype(np.float32)).to(device))


def vocabulary(size):
    return ["<blank>"] + [chr(0x4E00 + i) for i in range(1, size)]


def save_export(model_dir, config, state_dict, feats, symbols=None, label_mapping=None):
    """A reference-format export directory: config.yaml (written as JSON,
    which YAML reads), pytorch_model.bin with CMVN stats from the features
    ``feats`` [T, 80], and vocab.txt and label_mapping.json where given."""
    sd = dict(state_dict)
    sd["encoder.global_cmvn.mean"] = feats.mean(0).cpu()
    sd["encoder.global_cmvn.istd"] = (1.0 / feats.std(0).clamp_min(1e-3)).cpu()
    os.makedirs(model_dir)
    torch.save(sd, os.path.join(model_dir, "pytorch_model.bin"))
    with open(os.path.join(model_dir, "config.yaml"), "w") as f:
        json.dump(config, f)
    if symbols:
        with open(os.path.join(model_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            f.writelines(f"{sym} {i}\n" for i, sym in enumerate(symbols))
    if label_mapping:
        with open(os.path.join(model_dir, "label_mapping.json"), "w") as f:
            json.dump(label_mapping, f)


def write_search_export(tmp, device):
    """A reference-format export directory of the search model (random
    weights from SEED + 7, CMVN from the features of the longest search
    file, a 6992-symbol vocabulary), the search files and their test list.
    config.yaml is written as JSON, which YAML reads."""
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_

    rng = np.random.default_rng(SEED + 7)
    wavs = [write_wav(os.path.join(tmp, f"search{i}.wav"), speechlike(rng, sec))
            for i, sec in enumerate(SEARCH_SECONDS)]
    cfg = ChunkFormerConfig.from_dict(SEARCH)
    sd = init_random_(ASRModel(cfg), torch.Generator().manual_seed(SEED + 7)).state_dict()
    model_dir = os.path.join(tmp, "search_export")
    symbols = vocabulary(cfg.vocab_size)
    save_export(model_dir, SEARCH, sd, wav_features(wavs[-1], device), symbols=symbols)
    test_list = os.path.join(tmp, "search.list")
    with open(test_list, "w", encoding="utf-8") as f:
        for i, wav in enumerate(wavs):
            ref = "".join(symbols[j] for j in rng.integers(1, min(400, len(symbols) - 1), 8))
            f.write(f"utt{i}\t{wav}\t{ref[:4]} {ref[4:]}\n")
    return model_dir, test_list, wavs


def run_recognize(model_dir, test_list, out_dir, dtype, grab, modes=SEARCH_MODES):
    """``bin/recognize.py`` main(argv) with ``modes`` (the five CTC/AED modes
    by default); returns (wall seconds of the call, its logged wall seconds
    by part, the kernels' launch counts, peak device memory in GiB)."""
    from chunkformer_tpu_torch.bin import recognize

    argv = ["--model_checkpoint", model_dir, "--test_data", test_list, "--result_dir", out_dir,
            "--modes", *modes, "--beam_size", str(BEAM), "--chunk_size", str(C),
            "--left_context_size", str(LEFT), "--right_context_size", str(RIGHT),
            "--ctc_weight", str(CTC_WEIGHT), "--reverse_weight", str(REVERSE_WEIGHT),
            "--dtype", dtype]
    grab.lines.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reset_train_counts()
    t0 = time.time()
    rc = recognize.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    require(rc == 0, f"recognize {dtype} returned {rc}")
    counts = {**read_counts(), **read_train_counts()}
    line = [x for x in grab.lines if x.startswith("wall seconds:")]
    require(len(line) == 1, f"recognize logged no wall-time line: {grab.lines[-3:]}")
    parts = {}
    for item in line[0][len("wall seconds: "):].replace(";", ",").split(", "):
        key, _, value = item.rpartition(" ")
        parts[key] = float(value)
    for mode in modes:
        with open(os.path.join(out_dir, f"{mode}.txt"), encoding="utf-8") as f:
            rows = f.read().splitlines()
        require(len(rows) == len(SEARCH_SECONDS) and all("\t" in r for r in rows),
                f"recognize {dtype} {mode}: {len(rows)} result lines")
        require(os.path.exists(os.path.join(out_dir, f"{mode}.wer")), f"no {mode}.wer")
    return wall, parts, counts, torch.cuda.max_memory_allocated() / 2 ** 30


def padded_batch(model, wavs):
    feats = [model.extract_features(w) for w in wavs]
    xs = torch.zeros((len(feats), max(f.shape[0] for f in feats), feats[0].shape[1]),
                     device=model.device)
    for i, f in enumerate(feats):
        xs[i, :f.shape[0]] = f
    return feats, xs, torch.tensor([f.shape[0] for f in feats], dtype=torch.int32)


class CaptureTrainAttention:
    """Swaps the encoder's training attention: records the operands of the
    first call (B4 at the encode batch's shape) and optionally computes it
    with the plain forward instead of the kernels."""

    def __init__(self, plain=False):
        self.plain, self.args = plain, None

    def __enter__(self):
        from chunkformer_tpu_torch.nn import attention as attention_module
        from chunkformer_tpu_torch.ops import chunk_attention_train as cat

        self.module, self.routed = attention_module, attention_module.chunk_train_attention

        def call(q, kv, p, u, v, lens, seed=0, *, chunk, left, right, drop_rate=0.0,
                 head_offset=0, heads_total=0):
            if self.args is None:
                self.args = [q, kv, p, u, v, lens]
            if self.plain:
                return cat.forward_plain(q, kv, p, u, v, lens, seed, chunk, left, right,
                                         drop_rate, head_offset, heads_total)[0]
            return self.routed(q, kv, p, u, v, lens, seed, chunk=chunk, left=left, right=right,
                               drop_rate=drop_rate, head_offset=head_offset,
                               heads_total=heads_total)

        attention_module.chunk_train_attention = call
        return self

    def __exit__(self, *exc):
        self.module.chunk_train_attention = self.routed


def frame_tokens_and_gap(model, out, lens):
    """Frame argmax tokens and f32 top-1/top-2 log-prob gaps over the valid frames."""
    logp = model.ctc_logprobs(out)
    top2 = logp.topk(2, dim=-1).values
    valid = torch.arange(out.shape[1], device=out.device)[None, :] < lens.to(out.device)[:, None]
    return (logp.argmax(-1)[valid].cpu().numpy(),
            (top2[..., 0] - top2[..., 1])[valid].cpu().numpy())


def time_eval_forward(label, args, dtype, card, ctx=(C, LEFT, RIGHT),
                      what="the recognize batch's shape"):
    """B4's forward kernel (tensor cores) at an encode batch's shape against
    the plain forward on the captured operands: max error and times in turns
    (2 rounds), bound as ``train_attention_bounds``."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    f32 = dtype == torch.float32
    c, left, right = ctx
    st = (0, c, left, right, 0.0)
    with torch.inference_mode():
        require(cat.route(*args[:3], c) == "tensor_core", f"{label}: not the tensor-core route")
        got = cat.forward_kernel(*args, *st, path="tensor_core")[0]
        want = cat.forward_plain(*args, *st)[0]
        err = float((got.float() - want.float()).abs().max())
        require(err <= (1e-5 if f32 else 1e-2 + 2.0 ** -7 * float(want.float().abs().max())),
                f"{label}: max |kernel - plain| {err:.3g}")
        ks, ps = [], []
        for _ in range(2):
            ks.append(cuda_ms(lambda: cat.forward_kernel(*args, *st, path="tensor_core"),
                              iters=50))
            ps.append(cuda_ms(lambda: cat.forward_plain(*args, *st), iters=5, warmup=1))
    ms, plain_ms = sum(ks) / 2, sum(ps) / 2
    bound_ms, bound_by = train_attention_bounds(args, False, "tf32" if f32 else None, c, left,
                                                right)
    q = args[0]
    log(f"{label}: B4 forward (eval) at {what}, B={q.shape[0]} x "
        f"{q.shape[1]} frames (lens {args[5].tolist()}), H={q.shape[2]}, dk={q.shape[3]}, "
        f"(c, L, R) = {ctx}: max|kernel-plain| {err:.3g}; in turns (2 rounds): kernel "
        f"{ms:.4f} ms ({', '.join(f'{x:.4f}' for x in ks)}), plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}, {ms / bound_ms:.1f}x; card {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_search(tmp, card, device):
    """The search path: ``bin/recognize.py`` at ChunkFormer-large width with
    the 3 + 3 decoder (an export ``from_pretrained`` loads), the five CTC/AED
    modes, beam 10, (c, L, R) = (64, 128, 128), ctc_weight 0.3,
    reverse_weight 0.3, on 8 files of 4-40 s in one batch; one warm-up call,
    then f32 and bf16, with launch counts and wall times. Then, on the same
    batch, the checks through the API: the kernels' f32 encoder outputs
    against the plain attention, the limited-context encode against the
    parallel-chunk decode route at R = 0, the token bars, the beam
    structure, B4's eval forward timed against its bound; last
    ``bin/decode.py`` on one file and ``bin/alignment.py`` on two. Returns
    (launch counts by dtype, B4 results by dtype, the f32 model, and the
    export directory, test list and files)."""
    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.bin import alignment, decode
    from chunkformer_tpu_torch.decode.batched_beam import (batched_beam_to_results,
                                                           ctc_prefix_beam_search_batched)
    from chunkformer_tpu_torch.decode.search import (attention_beam_search,
                                                     attention_beam_search_device,
                                                     attention_rescoring,
                                                     ctc_prefix_beam_search)
    from chunkformer_tpu_torch.ops import chunk as chunk_ops

    model_dir, test_list, wavs = write_search_export(tmp, device)
    audio_s = sum(SEARCH_SECONDS)
    grab = LogLines()
    logging.getLogger().addHandler(grab)
    logging.getLogger().setLevel(logging.INFO)
    n_layers = SEARCH["encoder_conf"]["num_blocks"]
    counts, timing = {}, {}
    try:
        t_warm = run_recognize(model_dir, test_list, os.path.join(tmp, "rec_warm"), "fp32",
                               grab)[0]
        for dtype in ("fp32", "bf16"):
            wall, parts, cnt, peak = run_recognize(model_dir, test_list,
                                                   os.path.join(tmp, f"rec_{dtype}"), dtype, grab)
            counts[dtype], timing[dtype] = cnt, (wall, parts, peak)
    finally:
        logging.getLogger().removeHandler(grab)
    for dtype in ("fp32", "bf16"):
        wall, parts, peak = timing[dtype]
        enc = parts["features and encode"]
        log(f"recognize {dtype}: {len(wavs)} files, {audio_s:.1f} s of audio in one batch, "
            f"beam {BEAM}: "
            f"main() {wall:.3f} s with the model load (warm-up call {t_warm:.3f} s); features "
            f"and encode {enc:.4f} s; by mode, features + encode + search: " + ", ".join(
                f"{m} {enc + parts[m]:.4f} s ({audio_s / (enc + parts[m]):.1f} audio-s/s)"
                for m in SEARCH_MODES)
            + f"; peak device memory {peak:.2f} GiB; launches {counts[dtype]}; card {card}")
        want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0,
                "fbank_fft": len(SEARCH_SECONDS), "fwd": 0, "bwd": 0, "fwd_tc": n_layers,
                "bwd_tc": 0}
        require(counts[dtype] == want, f"recognize {dtype} launches {counts[dtype]}, "
                f"expected {want}")

    f32 = ChunkFormerModel.from_pretrained(model_dir, device=device)
    bf16 = ChunkFormerModel.from_pretrained(model_dir, dtype=torch.bfloat16, device=device)
    cfg = f32.config
    feats, xs, lens = padded_batch(f32, wavs)
    with CaptureTrainAttention() as cap32:
        out, out_lens = f32.encode(xs, lens, C, LEFT, RIGHT)
    with CaptureTrainAttention(plain=True):
        out_plain, _ = f32.encode(xs, lens, C, LEFT, RIGHT)
    with CaptureTrainAttention() as cap16:
        out16, _ = bf16.encode(xs, lens, C, LEFT, RIGHT)
    with CaptureTrainAttention(plain=True):
        out16_plain, _ = bf16.encode(xs, lens, C, LEFT, RIGHT)
    valid = torch.arange(out.shape[1], device=device)[None, :] < out_lens[:, None]
    enc_err = float((out - out_plain).abs()[valid].max())
    log(f"f32 encode (64, 128, 128) through the kernels vs through the plain attention, "
        f"{int(valid.sum())} frames: max abs diff {enc_err:.3g} (limit 2e-3)")
    require(bool(torch.isfinite(out[valid]).all()) and enc_err <= 2e-3,
            f"f32 encoder outputs differ from the plain attention's by {enc_err}")

    # limited context at R = 0 against the decode route's parallel-chunk
    # encoder, file by file as tests/test_encoder_modes.py:54 holds it: in a
    # padded batch a shorter file's frames also see its padding (the conv
    # module's pointwise bias survives the pad mask, in chunkformer_tpu too)
    with torch.inference_mode():
        packed = chunk_ops.pack_chunks(feats, [f.shape[0] for f in feats], C)
        att, cnn = f32.model.encoder.init_caches(LEFT, torch.float32, device)
        pc, _, _ = f32.model.encoder.parallel_chunk(
            packed.xs, f32._meta(packed.chunk_idx), f32._meta(packed.offsets),
            f32._meta(packed.max_lens), C, LEFT, 0, att, cnn, 0)
    r0_err, row = 0.0, 0
    for i, (n, enc_len) in enumerate(zip(packed.n_chunks, packed.out_lens)):
        r0, r0_len = f32.encode(feats[i][None], [feats[i].shape[0]], C, LEFT, 0)
        require(int(r0_len[0]) == enc_len, f"file {i}: encode length {int(r0_len[0])} vs "
                f"{enc_len}")
        flat = pc[row:row + n].reshape(-1, pc.shape[-1])[:enc_len]
        r0_err = max(r0_err, float((flat - r0[0, :enc_len]).abs().max()))
        row += n
    log(f"f32 encode (64, 128, 0) of each file vs batch_decode's parallel-chunk encoder at "
        f"R = 0 on the same {len(wavs)} files: max abs diff {r0_err:.3g} (limit 2e-3)")
    require(r0_err <= 2e-3, f"limited-context encode vs parallel chunk at R=0: {r0_err}")

    # token bars: f32 kernels vs plain attention; bf16 vs f32. These random
    # weights give flat posteriors (median f32 top-1/top-2 gap about 0.07 on
    # these files), where the bf16 model itself, through the plain attention
    # or the decode route, flips more than 1% of the frames whose gap is at
    # least 1e-2 (the PARITY.md round-4 bar; printed). So the bar held is the
    # kernels' share, as on the main path: their bf16 flip rates, at gap >=
    # 1e-2 and over all frames, at most 0.005 above the same bf16 model's
    # through the plain attention; and no flip where the gap is 0.1 or more
    tok, gap = frame_tokens_and_gap(f32, out, out_lens)
    tok_plain, _ = frame_tokens_and_gap(f32, out_plain, out_lens)
    tok16, _ = frame_tokens_and_gap(bf16, out16, out_lens)
    tok16_plain, _ = frame_tokens_and_gap(bf16, out16_plain, out_lens)
    flips = tok != tok_plain
    clear = int((flips & (gap >= 1e-3)).sum())
    wide = gap >= 1e-2
    flips16, flips16_plain = tok16 != tok, tok16_plain != tok
    rate16, rate16_plain = float(np.mean(flips16[wide])), float(np.mean(flips16_plain[wide]))
    whole16, whole16_plain = float(np.mean(flips16)), float(np.mean(flips16_plain))
    confident = int((flips16 & (gap >= 0.1)).sum())
    log(f"ctc frame tokens, {tok.size} frames (median f32 top-1/top-2 gap "
        f"{float(np.median(gap)):.4g}): f32 kernels vs plain attention {int(flips.sum())} "
        f"differ, {clear} where the gap is 1e-3 or more (limit 0); bf16 vs f32 through the "
        f"kernels {int(flips16.sum())} differ (rate {whole16:.5f}), through the plain attention "
        f"{int(flips16_plain.sum())} ({whole16_plain:.5f}); where the gap is 1e-2 or more "
        f"({int(wide.sum())} frames): kernels {rate16:.5f}, plain attention {rate16_plain:.5f} "
        f"(PARITY.md round 4: < 0.01; held: kernels at most 0.005 above the plain attention); "
        f"flips where the gap is 0.1 or more: {confident} (limit 0)")
    require(clear == 0, f"{clear} f32 tokens flip against the plain attention at gap >= 1e-3")
    require(rate16 <= rate16_plain + 0.005 and whole16 <= whole16_plain + 0.005,
            f"bf16 vs f32 flip rates through the kernels ({rate16}, {whole16}) more than 0.005 "
            f"above the plain attention's ({rate16_plain}, {whole16_plain})")
    require(confident == 0, f"{confident} bf16 tokens flip where the f32 gap is 0.1 or more")

    # beam structure, f32
    logp = f32.ctc_logprobs(out)
    logp_host, lens_host = logp.cpu().numpy(), out_lens.cpu().numpy()
    # the batched prefix beam on the card against the same search on the
    # CPU (its own algorithm); against the host prefix beam (printed): the
    # two are one algorithm only where each frame's top 2 x beam tokens hold
    # blank and the beams' last tokens, which the batched search always
    # takes and the host search takes only then; these flat posteriors
    # seldom put blank there
    prefix = ctc_prefix_beam_search(logp_host, lens_host, BEAM)
    batched = batched_beam_to_results(*ctc_prefix_beam_search_batched(logp, out_lens, BEAM))
    batched_cpu = batched_beam_to_results(*ctc_prefix_beam_search_batched(
        logp.cpu(), out_lens.cpu(), BEAM))
    clear_b = [i for i, r in enumerate(batched_cpu)
               if r.nbest_scores[0] - r.nbest_scores[1] >= 1e-3]
    same_b = [i for i in clear_b if batched[i].tokens == batched_cpu[i].tokens]
    score_err = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(batched, batched_cpu))
    clear_h = [i for i, r in enumerate(prefix)
               if len(r.nbest_scores) < 2 or r.nbest_scores[0] - r.nbest_scores[1] >= 1e-3]
    same_h = [i for i in clear_h if batched[i].tokens == prefix[i].tokens]
    blank_top = float((logp.topk(2 * BEAM, dim=-1).indices == 0).any(-1)[valid].float().mean())
    log(f"batched prefix beam on the card vs on the CPU: top-1 equal on {len(same_b)} of the "
        f"{len(clear_b)} utterances whose two best scores differ by 1e-3 or more (of "
        f"{len(batched)}), largest relative top-1 score difference {score_err:.3g}; vs the host "
        f"prefix beam: top-1 equal on {len(same_h)} of {len(clear_h)} such utterances (blank "
        f"among a frame's top {2 * BEAM} tokens on {blank_top:.4f} of the frames)")
    require(same_b == clear_b, f"batched prefix beam, card vs CPU, top-1 differ on "
            f"{sorted(set(clear_b) - set(same_b))}")
    rescored = attention_rescoring(f32.model, cfg, prefix, out, lens_host, CTC_WEIGHT,
                                   REVERSE_WEIGHT)
    require(all(r.tokens in p.nbest for r, p in zip(rescored, prefix)),
            "attention_rescoring picked a hypothesis outside its prefix n-best")
    t0 = time.time()
    dev_beam = attention_beam_search_device(f32.model, cfg, out, valid, BEAM)
    t_dev = time.time() - t0
    t0 = time.time()
    host_beam = attention_beam_search(f32.model, cfg, out, valid, BEAM)
    t_host = time.time() - t0
    same = [d.tokens == h.tokens and abs(d.score - h.score) <= 1e-5 * abs(h.score)
            for d, h in zip(dev_beam, host_beam)]
    log(f"attention_beam_search_device vs attention_beam_search (host loop), f32: equal on "
        f"{sum(same)} of {len(same)} utterances; {t_dev:.3f} s vs {t_host:.3f} s; "
        f"attention_rescoring picked from the n-best on all {len(rescored)}; hypothesis "
        f"lengths {[len(d.tokens) for d in dev_beam]}")
    require(all(same), "attention_beam_search_device differs from attention_beam_search")

    b4 = {"fp32": time_eval_forward("f32", cap32.args, torch.float32, card),
          "bf16": time_eval_forward("bf16", cap16.args, torch.bfloat16, card)}
    del out_plain, out16, out16_plain, bf16, cap32, cap16, logp
    torch.cuda.empty_cache()

    # the other two CLIs
    printed = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = decode.main(["--model_checkpoint", model_dir, "--audio_file", wavs[-1]])
    lines = printed.getvalue().splitlines()
    dcounts = read_counts()
    require(rc == 0 and len(lines) >= 2, f"decode returned {rc} with {len(lines)} lines")
    require(dcounts["chunk_attention_tc"] == n_layers and dcounts["fbank_fft"] == 1
            and dcounts["chunk_attention"] == 0, f"decode launches {dcounts}")
    align_list = os.path.join(tmp, "align.list")
    with open(test_list, encoding="utf-8") as f:
        rows = f.read().splitlines()[:2]
    with open(align_list, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    align_dir = os.path.join(tmp, "align")
    rc = alignment.main(["--model_checkpoint", model_dir, "--input_file", align_list,
                         "--result_dir", align_dir])
    grids = sorted(os.listdir(align_dir)) if os.path.isdir(align_dir) else []
    require(rc == 0 and grids == ["utt0.TextGrid", "utt1.TextGrid"], f"alignment wrote {grids}")
    log(f"decode CLI on {SEARCH_SECONDS[-1]:.0f} s (bf16, c=64): {len(lines)} lines, "
        f"launches {dcounts}; alignment CLI on 2 files: {grids}; {time.time() - t0:.1f} s")
    return counts, b4, f32, (model_dir, test_list, wavs)


# ---- other geometries: chunks that 64 does not divide (C7), on the tensor
# cores, and the fbank geometries the FFT kernel took from the DFT kernel
C7_DECODE = [(96, 64), (48, 128), (72, 64)]   # (c, dk); c = 72 over an odd 13 rows
ENDLESS_C7 = (96, 120.0)                        # chunk, seconds of endless_decode
TRAIN_C7 = (96, LEFT, RIGHT)                    # the flagship train step and an encode here
FBANK_OTHER = [  # (name, fbank keywords, seconds of audio, DFT kernel held to the
    # bar): odd shifts, long shifts, 2048 points, then more mel bins, 128 and 4096
    # points (the DFT kernel's float32 sums miss the bar on a rare element of
    # tonal audio, C22: counted, printed)
    ("50 ms / 160", dict(frame_length=50.0, frame_shift=10.0), 120.0, True),
    ("50 ms / 161", dict(frame_length=50.0, frame_shift=10.0625), 120.0, True),
    ("25 ms / 40 ms shift", dict(frame_shift=40.0), 120.0, False),
    ("25 ms at 44.1 kHz (2048 points)", dict(sample_rate=44100), 120.0, False),
    ("160 bins at 25 ms / 16 kHz", dict(num_mel_bins=160), 120.0, False),
    ("15 ms at 8 kHz (128 points)", dict(frame_length=15.0, sample_rate=8000), 120.0, False),
    ("25 ms at 96 kHz (4096 points)", dict(sample_rate=96000), 120.0, False),
    # above 4096 points, the block plan (csrc/fbank_fft_block.cu): the frame's
    # buffer in shared memory up to 16384 points, in a workspace slot beyond
    ("50 ms at 96 kHz (8192 points)", dict(sample_rate=96000, frame_length=50.0), 120.0, False),
    ("100 ms at 96 kHz (16384 points)", dict(sample_rate=96000, frame_length=100.0), 120.0,
     False),
    ("100 ms at 192 kHz (32768 points)", dict(sample_rate=192000, frame_length=100.0), 30.0,
     False),
]


def other_attention(c, dk, n, trunc, gen, device, card):
    """Decode attention at chunk c, head dim dk, over n rows: the routed
    tensor-core kernel in f32 (3xTF32, atol 1e-5) and bf16 (atol 1e-2 plus
    one bf16 ulp) against the plain version, the CUDA-core kernel beside it
    at the same bars, timed in turns (tensor cores, CUDA cores, plain; 2
    rounds); the tensor-core kernel must be the fastest. Returns
    {dtype name: {"tc": result, "cc": result}}."""
    from chunkformer_tpu_torch.ops.chunk_attention import (chunk_attention,
                                                           chunk_attention_cuda_core,
                                                           chunk_attention_plain, route)

    kw = dict(chunk=c, left=LEFT, right=RIGHT)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        name, atol, rtol = ("f32", 1e-5, 0.0) if f32 else ("bf16", 1e-2, 2.0 ** -7)
        args = attention_inputs(n, dtype, trunc, n * c - 37, gen, device, c=c, dk=dk)
        require(route(*args[:3]) == "tensor_core", f"c={c} dk={dk} {name} not on the "
                f"tensor-core route")
        label = f"attention {name} tensor cores c={c} dk={dk} N={n}"
        launches = (chunk_attention.launches, chunk_attention.tc_launches)
        _, err = check_attention(label, chunk_attention, args, atol, rtol)
        require((chunk_attention.launches, chunk_attention.tc_launches)
                == (launches[0], launches[1] + 1), f"{label}: the tensor-core kernel did not run")
        _, cc_err = check_attention(f"attention {name} CUDA cores c={c} dk={dk}",
                                    chunk_attention_cuda_core, args, atol, rtol)
        tc, cc, plain = [], [], []
        for _ in range(2):
            tc.append(cuda_ms(lambda: chunk_attention(*args, **kw), iters=20))
            cc.append(cuda_ms(lambda: chunk_attention_cuda_core(*args, **kw), iters=5))
            plain.append(cuda_ms(lambda: chunk_attention_plain(*args, **kw), iters=3, warmup=1))
        ms, cc_ms, plain_ms = (sum(x) / 2 for x in (tc, cc, plain))
        bound_ms, bound_by = attention_bound(args, "tf32" if f32 else None)
        cc_bound, cc_by = attention_bound(args)
        out[name] = {"tc": dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by),
                     "cc": dict(max_abs_err=cc_err, ms=cc_ms, plain_ms=plain_ms,
                                bound_ms=cc_bound, bound_by=cc_by)}
        log(f"{label} (H=8, L=R={LEFT}, {-(-c // 64)} query tiles a chunk, the last "
            f"{c - 64 * (-(-c // 64) - 1)} rows): max|kernel-plain| {err:.3g} (atol {atol}, rtol "
            f"{rtol}), CUDA cores {cc_err:.3g}; in turns (2 rounds): tensor cores {ms:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in tc)}), CUDA cores {cc_ms:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in cc)}), plain {plain_ms:.4f} ms "
            f"({', '.join(f'{x:.4f}' for x in plain)}); bound {bound_ms:.4f} ms by {bound_by} "
            f"(CUDA cores: {cc_bound:.4f} ms by {cc_by}), {ms / bound_ms:.1f}x; card {card}")
        require(ms < plain_ms and ms < cc_ms, f"{label}: {ms:.4f} ms is not below the plain "
                f"version ({plain_ms:.4f}) and the CUDA-core kernel ({cc_ms:.4f})")
        del args
    return out


def other_fbank(device, card):
    """fbank at ``FBANK_OTHER``'s geometries: the routed call launches the
    FFT kernel of its plan once (counts reset around it: the warp plan's up
    to 4096 points, the block plan's above) and is within atol 2e-3 + rtol
    1e-3 of the plain version, with no element past the bar. The DFT kernel
    (no route's kernel), called directly where it takes the window (at most
    ``DFT_MAX_WIN`` samples, C23), is held to the same bar at 50 ms, where
    it always was; elsewhere its float32 DFT's elements past the bar are
    counted and printed (C22), as is its largest gap to the FFT kernel.
    Above 4096 points the FFT kernel is the block plan, whose grid and
    buffer place (shared memory, or a workspace and its bytes) are printed,
    with the time
    of ``torch.fft.rfft`` of the windowed float64 frames alone (no library
    call computes the whole function). The kernels and the plain version
    are timed in turns (2 rounds); the FFT kernel must be the fastest.
    Returns {name: {"fft": result, "dft": result or None, "launches":
    counts}}."""
    from chunkformer_tpu_torch.ops.fbank import (DFT_MAX_WIN, MAX_WARP_PLAN_POINTS, _geometry,
                                                 band_table, fbank, fbank_dft, fbank_fft,
                                                 fbank_plain, fft_block_grid, fft_block_in_shared,
                                                 fft_block_workspace_bytes, num_frames,
                                                 windowed_frames)
    from chunkformer_tpu_torch.ops.fbank import route as fbank_route

    out = {}
    for name, kw, seconds, dft_bar in FBANK_OTHER:
        sr = kw.get("sample_rate", 16000)
        win, shift, padded = _geometry(sr, kw.get("frame_length", 25.0),
                                       kw.get("frame_shift", 10.0))
        require(fbank_route(**kw) == "fft", f"fbank {name} routed to {fbank_route(**kw)}")
        wave = torch.from_numpy(speechlike(np.random.default_rng(SEED + 10), seconds, sr)
                                .astype(np.float32)).to(device)
        n = num_frames(wave.numel(), sr, kw.get("frame_length", 25.0),
                       kw.get("frame_shift", 10.0))
        block = padded > MAX_WARP_PLAN_POINTS
        want = fbank_plain(wave, **kw)
        reset_counts()
        got = {"fft": fbank(wave, **kw)}
        torch.cuda.synchronize()
        counts = read_counts(block_plan=True)
        require(counts == {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0,
                           "fbank_fft": int(not block), "fbank_fft_block": int(block)},
                f"fbank {name} launches {counts}")
        dft = win <= DFT_MAX_WIN
        if dft:
            got["dft"] = fbank_dft(wave, **kw)
            torch.cuda.synchronize()
        errs, over = {}, {}
        n_mels = kw.get("num_mel_bins", 80)
        for k, feats in got.items():
            err = (feats - want).abs()
            errs[k] = float(err.max())
            over[k] = int((err > 2e-3 + 1e-3 * want.abs()).sum())
            require(feats.shape == (n, n_mels) and bool(torch.isfinite(feats).all())
                    and (over[k] == 0 or (k == "dft" and not dft_bar)),
                    f"fbank {k} at {name}: max err {errs[k]:.3g}, {over[k]} past the bar")
        gap = f"{float((got['fft'] - got['dft']).abs().max()):.3g}" if dft else "-"
        times = {k: [] for k in ("fft", "dft", "plain", "rfft")
                 if (k != "dft" or dft) and (k != "rfft" or block)}
        frames = windowed_frames(wave, win, shift, n) if block else None
        for _ in range(2):
            times["fft"].append(cuda_ms(lambda: fbank_fft(wave, **kw), iters=10))
            if dft:
                times["dft"].append(cuda_ms(lambda: fbank_dft(wave, **kw), iters=3, warmup=1))
            times["plain"].append(cuda_ms(lambda: fbank_plain(wave, **kw), iters=3, warmup=1))
            if block:
                times["rfft"].append(cuda_ms(lambda: torch.fft.rfft(frames, n=padded, dim=1),
                                             iters=3, warmup=1))
        del frames
        ms = {k: sum(v) / 2 for k, v in times.items()}
        bound_ms, bound_by = fbank_bound(wave, n, n_mels, win=win, padded=padded, sample_rate=sr)
        plan = "warp plan"
        if block:
            blocks = fft_block_grid(padded, n, torch.cuda.get_device_properties(device)
                                    .multi_processor_count)
            plan = (f"block plan, {blocks} blocks, the frame's buffer in shared memory "
                    f"({8 * padded} bytes a block)" if fft_block_in_shared(padded) else
                    f"block plan, {blocks} blocks, a workspace of "
                    f"{fft_block_workspace_bytes(padded, blocks)} bytes (a slot a block)")
        out[name] = {k: (dict(max_abs_err=errs[k], ms=ms[k], plain_ms=ms["plain"],
                              bound_ms=bound_ms, bound_by=bound_by) if k in errs else None)
                     for k in ("fft", "dft")}
        out[name]["launches"] = counts
        nnz = int(band_table(n_mels, padded, float(sr))[1].sum())
        log(f"fbank {name}: {win} samples, shift {shift}, padded {padded}, {sr} Hz, {n_mels} bins, "
            f"{seconds:.0f} s ({n} frames, {nnz} mel weights); {plan}; routed fbank launches "
            f"{counts}; "
            f"max|kernel-plain| FFT {errs['fft']:.3g}, DFT "
            + (f"{errs['dft']:.3g} ({over['dft']} of {want.numel()} past the bar)" if dft
               else f"not run (it refuses windows above {DFT_MAX_WIN} samples)")
            + f", FFT-DFT {gap}; in turns (2 rounds): " + ", ".join(
                f"{k} {ms[k]:.4f} ms ({', '.join(f'{x:.4f}' for x in v)})"
                for k, v in times.items())
            + f"; bound {bound_ms:.4f} ms by {bound_by}, FFT {ms['fft'] / bound_ms:.1f}x; "
            f"card {card}")
        require(ms["fft"] < min(ms.get("dft", ms["plain"]), ms["plain"]),
                f"fbank {name}: the FFT kernel ({ms['fft']:.4f} ms) is not below the plain "
                f"version and the DFT kernel ({ms})")
        del wave, want, got
    return out


def statistics_against_float64(targs, c, outs):
    """Each forward's row max m and denominator den (p = 0) against the
    plain arithmetic in float64 on the same operands, over the rows with a
    valid key: max |m - m64| and max |den - den64| / den64, by name."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    _, m64, den64 = cat.forward_plain(*targs, 5, c, LEFT, RIGHT, 0.0, dtype=torch.float64)
    live = m64 > -1e28
    parts = []
    for name, (_, m, den) in outs.items():
        m_err = float((m.double() - m64)[live].abs().max())
        den_err = float(((den.double() - den64).abs() / den64)[live].max())
        parts.append(f"{name} max |m - m64| {m_err:.3g}, max |den - den64| / den64 "
                     f"{den_err:.3g}")
    near0 = int((m64[live].abs() < 0.05).sum())
    return (f"against float64 ({int(live.sum())} live rows, {near0} row maxima within 0.05 "
            f"of 0): " + "; ".join(parts))


def other_train_inputs(c, dk, dtype, gen, device, b=8, nch=4):
    """Training attention operands at chunk c, head dim dk: b utterances of
    nch chunks with ragged lengths down to 1 (the last), H = 8, L = R = 128;
    the stream's pad rows zero as in the encoder."""
    lens = torch.tensor([nch * c - 7 * i - (i * i) % 5 for i in range(b)][:-1] + [1],
                        dtype=torch.int32, device=device)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    args = [rnd(b, nch * c, 8, dk), rnd(b, LEFT + nch * c + RIGHT, 8, 2 * dk),
            rnd(2 * c - 1 + LEFT + RIGHT, 8, dk), rnd(8, dk), rnd(8, dk), lens]
    args[1][:, :LEFT] = 0
    args[1][:, LEFT + nch * c:] = 0
    return args


def other_train_attention(c, dk, gen, device, card, nch=4, fastest=True):
    """B4 and B5 at chunk c, head dim dk: B = 8 utterances of ``nch`` chunks
    with ragged lengths down to 1, H = 8, L = R = 128, p = 0.1. In f32 and in
    bf16 the routed tensor-core kernels (a partial 64-row query block where
    64 does not divide c, a partial 64-frame key block where it does not
    divide nch c) and the CUDA-core kernels against the plain version at the
    dtype's bars (f32: ctx atol 1e-5, m and den atol 1e-5 + rtol 1e-5 (C25),
    gradients atol 1e-4 + rtol 1e-5; bf16: ctx atol 1e-2 + one bf16 ulp, m
    and den rtol 1e-2, each gradient 1e-2 relative L2), each launch counted;
    in f32 each route's m and den and the plain version's beside the plain
    arithmetic in float64 at p = 0; timed in turns (tensor cores, CUDA
    cores, plain; 2 rounds); with ``fastest`` the tensor-core forward and
    backward must be faster than both. Returns {dtype name: {"tc": {"fwd":
    result, "bwd": result}, "cc": {...}}}."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    b, drop = 8, 0.1
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        name = "bf16" if bf16 else "f32"
        targs = other_train_inputs(c, dk, dtype, gen, device, b, nch)
        lens = targs[5]
        label = f"train attention {name} c={c} dk={dk}"
        require(cat.route(*targs[:3], c) == "tensor_core",
                f"{label}: routed to {cat.route(*targs[:3], c)}")
        st = (5, c, LEFT, RIGHT, drop)
        want = cat.forward_plain(*targs, *st)
        dctx = torch.randn(want[0].shape, generator=gen, device=device).to(dtype)
        leaves = [a.detach().clone().requires_grad_() for a in targs[:5]]
        ref = torch.autograd.grad(cat.forward_plain(*leaves, lens, *st)[0], leaves, dctx)
        errs, fwd_out = {}, {}
        for route in ("tensor_core", "cuda_core"):
            tag = f"{label} ({route.replace('_', '-')} route)"
            counts = read_train_counts()
            ctx, m, den = fwd_out[route] = cat.forward_kernel(*targs, *st, path=route)
            got = cat.backward_kernel(*targs, ctx, m, den, dctx, *st, path=route)
            torch.cuda.synchronize()
            key = "_tc" if route == "tensor_core" else ""
            moved = {k: v - counts[k] for k, v in read_train_counts().items()}
            require(moved == {"fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0, f"fwd{key}": 1,
                              f"bwd{key}": 1}, f"{tag}: launches {moved}")
            f_err = float((ctx.float() - want[0].float()).abs().max())
            tol = (1e-2 + 2.0 ** -7 * want[0].float().abs()) if bf16 else 1e-5
            require(bool(torch.isfinite(ctx).all())
                    and bool(((ctx.float() - want[0].float()).abs() <= tol).all()),
                    f"{tag}: forward max |kernel - plain| {f_err:.3g}")
            for sname, got_s, want_s in (("m", m, want[1]), ("den", den, want[2])):
                if bf16:
                    rel = float(((got_s - want_s).abs() / want_s.abs().clamp_min(1e-30)).max())
                    require(rel <= 1e-2, f"{tag}: {sname} relative error {rel:.3g}")
                else:
                    excess = float(((got_s - want_s).abs() - 1e-5 * want_s.abs()).max())
                    require(excess <= 1e-5, f"{tag}: {sname} atol excess {excess:.3g}")
            b_err, worst = 0.0, 0.0  # max |kernel - plain|; the bar's worst measure
            for gname, a, e in zip(("q", "kv", "p", "u", "v"), got, ref):
                require(bool(torch.isfinite(a).all()), f"{tag}: non-finite d{gname}")
                b_err = max(b_err, float((a.float() - e.float()).abs().max()))
                if bf16:
                    rel = float((a.float() - e.float()).norm() / e.float().norm())
                    worst = max(worst, rel)
                    require(rel <= 1e-2, f"{tag}: d{gname} relative L2 error {rel:.3g}")
                else:
                    excess = float(((a - e).abs() - 1e-5 * e.abs()).max())
                    worst = max(worst, excess)
                    require(excess <= 1e-4, f"{tag}: d{gname} atol excess {excess:.3g}")
            errs[route] = (f_err, b_err, worst)
            del got
        if not bf16:
            log(f"{label}: " + statistics_against_float64(targs, c, {
                "tensor cores": cat.forward_kernel(*targs, *st[:4], 0.0, path="tensor_core"),
                "CUDA cores": cat.forward_kernel(*targs, *st[:4], 0.0, path="cuda_core"),
                "plain f32": cat.forward_plain(*targs, *st[:4], 0.0)}))
        times = {k: [] for k in ("tc_f", "cc_f", "pl_f", "tc_b", "cc_b", "pl_b")}
        tc_out, cc_out = fwd_out["tensor_core"], fwd_out["cuda_core"]
        for _ in range(2):
            times["tc_f"].append(cuda_ms(lambda: cat.forward_kernel(
                *targs, *st, path="tensor_core"), iters=20))
            times["cc_f"].append(cuda_ms(lambda: cat.forward_kernel(
                *targs, *st, path="cuda_core"), iters=5))
            times["pl_f"].append(cuda_ms(lambda: cat.forward_plain(*targs, *st), iters=3,
                                         warmup=1))
            times["tc_b"].append(cuda_ms(lambda: cat.backward_kernel(
                *targs, *tc_out, dctx, *st, path="tensor_core"), iters=20))
            times["cc_b"].append(cuda_ms(lambda: cat.backward_kernel(
                *targs, *cc_out, dctx, *st, path="cuda_core"), iters=5))
            times["pl_b"].append(cuda_ms(lambda: cat.backward_plain(
                *targs, tc_out[1], tc_out[2], dctx, *st), iters=3, warmup=1))
        mean = {k: sum(v) / 2 for k, v in times.items()}
        res = {"tc": {}, "cc": {}}
        msg = (f"{label} B={b} x {nch * c} frames (lens {lens.tolist()}), H=8, L=R={LEFT}, "
               f"p={drop}, {-(-c // 64)} query blocks a chunk, {-(-nch * c // 64)} key blocks an "
               f"utterance: tensor cores forward max|kernel-plain| {errs['tensor_core'][0]:.3g}, "
               f"backward {errs['tensor_core'][1]:.3g} (worst "
               f"{'relative L2' if bf16 else 'atol excess over rtol 1e-5'} "
               f"{errs['tensor_core'][2]:.3g}); CUDA cores {errs['cuda_core'][0]:.3g}, "
               f"{errs['cuda_core'][1]:.3g} ({errs['cuda_core'][2]:.3g})")
        for i, part in enumerate(("fwd", "bwd")):
            x = part[0]
            for r, route in (("tc", "tensor_core"), ("cc", "cuda_core")):
                bound, by = train_attention_bounds(
                    targs, part == "bwd", "tf32" if r == "tc" and not bf16 else None, c=c)
                res[r][part] = dict(max_abs_err=errs[route][i], ms=mean[f"{r}_{x}"],
                                    plain_ms=mean[f"pl_{x}"], bound_ms=bound, bound_by=by)
            tc_r = res["tc"][part]
            msg += (f"; {'forward' if x == 'f' else 'backward'} in turns (2 rounds): tensor cores "
                    f"{mean[f'tc_{x}']:.4f} ms ({', '.join(f'{t:.4f}' for t in times[f'tc_{x}'])})"
                    f", CUDA cores {mean[f'cc_{x}']:.4f} ms "
                    f"({', '.join(f'{t:.4f}' for t in times[f'cc_{x}'])}), plain "
                    f"{mean[f'pl_{x}']:.4f} ms "
                    f"({', '.join(f'{t:.4f}' for t in times[f'pl_{x}'])}); bound "
                    f"{tc_r['bound_ms']:.4f} ms by {tc_r['bound_by']}, tensor cores "
                    f"{tc_r['ms'] / tc_r['bound_ms']:.1f}x")
        log(msg + f"; card {card}")
        for x, part in (("f", "forward"), ("b", "backward")):
            require(not fastest or mean[f"tc_{x}"] < min(mean[f"cc_{x}"], mean[f"pl_{x}"]),
                    f"{label}: the tensor-core {part} ({mean[f'tc_{x}']:.4f} ms) is not below "
                    f"the CUDA-core one ({mean[f'cc_{x}']:.4f}) and the plain version "
                    f"({mean[f'pl_{x}']:.4f})")
        out[name] = res
        del targs, want, dctx, leaves, ref, fwd_out, tc_out, cc_out
    return out


def train_step_at(chunk, card, device, train_dict=TRAIN):
    """The flagship CTC/AED step of ``train_dict`` at (c, L, R) = ``chunk``,
    dropout 0, on the seeded batch: one f32 step through the tensor-core
    route against the same step through the plain attention, at
    ``f32_step_routes``' bars (loss 1e-5, gradients 1e-4 relative L2, per
    parameter against its sensitivity baseline), and one bf16 step at
    ``bf16_step_routes``' bar (1e-2 whole-gradient relative L2); each
    launches the tensor-core training kernels only. Returns the f32 and bf16
    steps' launch counts."""
    from chunkformer_tpu_torch.config import ChunkFormerConfig

    cfg = ChunkFormerConfig.from_dict(train_dict)
    n_layers = cfg.encoder_conf.num_blocks
    recompute = 2 if cfg.encoder_conf.remat_policy == "nothing" else 1
    batch = train_batch(cfg, device, SEED + 2)
    t0 = time.time()
    f32_counts = f32_step_routes(train_dict, device, batch, n_layers, recompute,
                                 routes=("tensor_core",), chunk=chunk)
    bf16_counts = bf16_step_routes(train_dict, device, batch, n_layers, recompute,
                                   routes=("tensor_core",), chunk=chunk)[1]["tensor_core"]
    log(f"train step at (c, L, R) = {chunk} ({TRAIN_BATCH} x {TRAIN_FRAMES} frames, f32 and "
        f"bf16 against the plain attention): launches f32 {f32_counts}, bf16 {bf16_counts}; "
        f"{time.time() - t0:.1f} s with the plain steps and the baseline; card {card}")
    return f32_counts, bf16_counts


def encode_at(model, wavs, chunk, card):
    """A recognize-style f32 ``encode`` of the search files in one padded
    batch at (c, L, R) = ``chunk``: B4's forward in eval on the tensor cores
    only (one launch a layer), the encoder outputs within 2e-3 of the same
    encode through the plain attention on the valid frames, and B4 timed on
    the captured operands (``time_eval_forward``). Returns the launches and
    B4's result."""
    c, left, right = chunk
    n_layers = model.config.encoder_conf.num_blocks
    _, xs, lens = padded_batch(model, wavs)
    reset_train_counts()
    with CaptureTrainAttention() as cap:
        out, out_lens = model.encode(xs, lens, c, left, right)
    torch.cuda.synchronize()
    counts = read_train_counts()
    with CaptureTrainAttention(plain=True):
        out_plain, _ = model.encode(xs, lens, c, left, right)
    valid = torch.arange(out.shape[1], device=out.device)[None, :] < out_lens[:, None]
    err = float((out - out_plain).abs()[valid].max())
    log(f"f32 encode at (c, L, R) = {chunk} of the {len(wavs)} search files: launches {counts}; "
        f"through the kernels vs through the plain attention, {int(valid.sum())} frames: max "
        f"abs diff {err:.3g} (limit 2e-3)")
    require(counts == {"fwd": 0, "bwd": 0, "fwd_tc": n_layers, "bwd_tc": 0},
            f"encode at c={c} launches {counts}")
    require(bool(torch.isfinite(out[valid]).all()) and err <= 2e-3,
            f"encode at c={c}: the kernels' outputs differ from the plain attention's by {err}")
    b4 = time_eval_forward(f"encode f32 c={c}", cap.args, torch.float32, card, ctx=chunk,
                           what=f"the c = {c} encode batch's shape")
    return counts, b4


def phase_other_geometries(card, device, f32, wavs):
    """Decode attention at the C7 shapes on the tensor cores in f32 and bf16,
    held and timed beside the plain version and the CUDA-core kernel
    (``other_attention``); the training kernels at the same shapes on both
    routes in f32 and bf16 (``other_train_attention``: the tensor cores
    required the fastest); a 120 s f32 ``endless_decode`` at c = 96 on
    ChunkFormer-large, tensor-core attention launches only, against the same
    decode through the plain attention; the flagship train step at (96,
    128, 128) in f32 and bf16 (``train_step_at``) and an f32 encode of the
    search files ``wavs`` there (``encode_at``), tensor-core training
    kernels only; fbank at the geometries the FFT kernel took from the DFT
    kernel (``other_fbank``). Returns the results by shape and geometry, and
    the c = 96 decode's, train steps' and encode's launches."""
    from chunkformer_tpu_torch.api import endless_sizing
    from chunkformer_tpu_torch.nn import attention as attention_module
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_plain
    from chunkformer_tpu_torch.ops.fbank import fbank

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    enc = f32.config.encoder_conf
    results = {}
    for c, dk in C7_DECODE:
        n = 13 if c == 72 else endless_sizing(enc, c, RIGHT, BUDGET)[4]
        trunc = endless_sizing(enc, c, RIGHT, BUDGET)[0]
        results[(c, dk)] = other_attention(c, dk, n, trunc, gen, device, card)
        # the training kernels at the same (c, dk), both routes, f32 and bf16
        results[("train", c, dk)] = other_train_attention(c, dk, gen, device, card)
    # C25: the training kernels at c = 1 (a one-row query block a chunk), 64
    # chunks an utterance, both routes and dtypes; no route is required the
    # fastest there (the f32 tensor cores lose at small chunks, ROADMAP.md
    # section B item 9)
    results[("train", 1, 64)] = other_train_attention(1, 64, gen, device, card, nch=64,
                                                      fastest=False)

    # endless_decode of 120 s at c = 96 through the tensor-core kernel, against
    # the plain attention: no flip where the f32 top-1/top-2 gap is 1e-3 or more
    c, seconds = ENDLESS_C7
    wave = speechlike(np.random.default_rng(SEED + 9), seconds)
    feats = fbank(torch.from_numpy(wave.astype(np.float32)).to(device))
    d = enc.output_size
    reset_counts()
    t0 = time.time()
    out = f32.endless_encode(feats, c, LEFT, RIGHT, BUDGET)
    torch.cuda.synchronize()
    t_endless = time.time() - t0
    c96_counts = read_counts()
    n_seg = c96_counts["chunk_attention_tc"] // enc.num_blocks
    tokens, gap = frame_tokens_and_gap(f32, out[None], torch.tensor([out.shape[0]]))
    routed = attention_module.chunk_attention
    attention_module.chunk_attention = chunk_attention_plain
    try:
        plain_tokens = f32.endless_encode_tokens(feats, c, LEFT, RIGHT, BUDGET)
    finally:
        attention_module.chunk_attention = routed
    flips = tokens != plain_tokens
    clear = int((flips & (gap >= 1e-3)).sum())
    log(f"endless_decode f32 at c={c}, L=R={LEFT}, {seconds:.0f} s ({out.shape[0]} frames of "
        f"{d}): {t_endless:.3f} s, {seconds / t_endless:.1f} audio-s/s; launches {c96_counts}; "
        f"tokens vs the plain attention: {int(flips.sum())} differ, {clear} where the f32 "
        f"top-1/top-2 gap is 1e-3 or more (limit 0)")
    require(n_seg >= 1 and c96_counts == {"chunk_attention": 0,
                                          "chunk_attention_tc": enc.num_blocks * n_seg,
                                          "fbank": 0, "fbank_fft": 0},
            f"c={c} endless launches {c96_counts}")
    require(tokens.shape == plain_tokens.shape and clear == 0,
            f"c={c} endless tokens: {clear} flips at gap >= 1e-3")
    del out, feats

    c96_counts = {"decode": c96_counts}
    c96_counts["train f32"], c96_counts["train bf16"] = train_step_at(TRAIN_C7, card, device)
    c96_counts["encode"], results["encode c96"] = encode_at(f32, wavs, TRAIN_C7, card)
    results["fbank"] = other_fbank(device, card)
    return results, c96_counts


# ---- slice 9: the streaming path and multi-task classification
STREAM_SECONDS = 60.0
STREAM_CTX = (6, 50, 0)     # the realtime defaults (apps/realtime-asr/README.md:7-8)
SIM_CTX = (C, LEFT, 0)      # recognize --simulate_streaming
CLASSIFY = {  # the widths of examples/classification/conf/multi_task.yaml
    "model": "classification",
    "encoder_conf": {"output_size": 256, "attention_heads": 4, "linear_units": 2048,
                     "num_blocks": 12, "cnn_module_kernel": 15,
                     "cnn_module_norm": "layer_norm", "dynamic_conv": True},
    "model_conf": {"tasks": {"gender": 2, "emotion": 8, "dialect": 5, "age": 5}},
    "dataset_conf": LARGE["dataset_conf"],
}
CLASSIFY_LABELS = {"gender": ["male", "female"],
                   "emotion": ["neutral", "happy", "sad", "angry", "surprised", "fearful",
                               "disgusted", "contempt"],
                   "dialect": ["north", "central", "south", "highland", "other"],
                   "age": ["child", "teen", "adult", "middle", "senior"]}
CLASSIFY_CTX = (128, 128, 128)


class CaptureStreamingASR:
    """Swaps ``bin/stream.py``'s ``StreamingASR`` for a subclass that keeps
    the instances ``main`` makes (their tokens and step times)."""

    def __enter__(self):
        from chunkformer_tpu_torch.bin import stream

        self.module, self.cls, self.made = stream, stream.StreamingASR, []
        made = self.made

        class Kept(self.cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        stream.StreamingASR = Kept
        return self

    def __exit__(self, *exc):
        self.module.StreamingASR = self.cls


def run_stream(model_dir, wav, dtype):
    """``bin/stream.py`` main(argv) on a file at STREAM_CTX, its printing
    kept; returns (its StreamingASR, wall seconds of the call with the model
    load, the ``final:`` line, the kernels' launch counts)."""
    from chunkformer_tpu_torch.bin import stream

    c, left, right = STREAM_CTX
    printed = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    reset_train_counts()
    t0 = time.time()
    with CaptureStreamingASR() as cap, contextlib.redirect_stdout(printed):
        rc = stream.main(["--model_checkpoint", model_dir, "--audio_file", wav, "--dtype", dtype,
                          "--chunk_size", str(c), "--left_context_size", str(left),
                          "--right_context_size", str(right)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    final = [x for x in printed.getvalue().splitlines() if x.startswith("final:")]
    require(rc == 0 and len(cap.made) == 1 and len(final) == 1,
            f"stream {dtype} returned {rc} with {len(final)} final lines")
    return cap.made[0], wall, final[0], {**read_counts(), **read_train_counts()}


def time_fbank_window(label, wave, card, what="one step's window"):
    """The FFT fbank kernel against the plain version on ``wave`` (one
    streaming step's window by default): max error (atol 2e-3 + rtol 1e-3)
    and times in turns (2 rounds)."""
    from chunkformer_tpu_torch.ops.fbank import fbank_fft, fbank_plain, num_frames

    n = num_frames(wave.numel())
    got, want = fbank_fft(wave), fbank_plain(wave)
    err = (got - want).abs()
    require(got.shape == (n, 80) and bool((err <= 2e-3 + 1e-3 * want.abs()).all()),
            f"{label}: max |kernel - plain| {float(err.max()):.3g}")
    ks, ps = [], []
    for _ in range(2):
        ks.append(cuda_ms(lambda: fbank_fft(wave), iters=200))
        ps.append(cuda_ms(lambda: fbank_plain(wave), iters=50))
    ms, plain_ms = sum(ks) / 2, sum(ps) / 2
    bound_ms, bound_by = fbank_bound(wave, n)
    log(f"{label}: FFT fbank kernel on {what} ({wave.numel()} samples, {n} frames): "
        f"max|kernel-plain| {float(err.max()):.3g}; in turns (2 rounds): kernel {ms:.4f} ms "
        f"({', '.join(f'{x:.4f}' for x in ks)}), plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}, {ms / bound_ms:.1f}x; card {card}")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_streaming(tmp, card, device, search):
    """The streaming path at ChunkFormer-large width (an export of random
    weights from SEED + 11): ``bin/stream.py`` on 60 s of audio at the
    realtime defaults (c, L, R) = (6, 50, 0) after a warm-up, in f32 and
    bf16, with the per-step latency (each step ends with its tokens on the
    host), the RTF and one FFT fbank launch a step; the FFT kernel on one
    step's window against the plain version; ``streaming_step`` over the
    file's features against ``encode`` at (6, 50, 0) in f32 (atol 2e-3);
    then ``recognize --simulate_streaming`` at (64, 128, 0) on the search
    files, and file by file its f32 encoder against ``encode`` at
    (64, 128, 0): tokens equal where the top-1/top-2 gap is 1e-3 or more.
    Returns (the f32 run's fbank launches, the window's fbank results)."""
    import torch.nn.functional as F

    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.bin import recognize
    from chunkformer_tpu_torch.bin.recognize import _streaming_encode
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.ops.chunk import reverse_calc_length

    rng = np.random.default_rng(SEED + 11)
    samples = speechlike(rng, STREAM_SECONDS)
    wav = write_wav(os.path.join(tmp, "stream.wav"), samples)
    warm = write_wav(os.path.join(tmp, "stream_warm.wav"), speechlike(rng, 5.0))
    cfg = ChunkFormerConfig.from_dict(LARGE)
    sd = init_random_(ASRModel(cfg), torch.Generator().manual_seed(SEED + 11)).state_dict()
    model_dir = os.path.join(tmp, "stream_export")
    feats = wav_features(wav, device)
    save_export(model_dir, LARGE, sd, feats, symbols=vocabulary(cfg.vocab_size))
    del sd
    c, left, right = STREAM_CTX
    tokens, f32_fbank = {}, 0
    for dtype in ("fp32", "bf16"):
        warm_wall = run_stream(model_dir, warm, dtype)[1]
        asr, wall, final, counts = run_stream(model_dir, wav, dtype)
        steps = len(asr.step_seconds)
        need = asr.cache_samples + (asr.frames_in - 1) * 160 + 400
        want_steps = (len(samples) - need) // asr.step_samples + 1
        want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0, "fbank_fft": steps,
                "fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
        step_ms = np.asarray(asr.step_seconds) * 1e3
        rtf = float(sum(asr.step_seconds)) / STREAM_SECONDS
        log(f"stream {dtype}: {STREAM_SECONDS:.0f} s at (c, L, R) = {STREAM_CTX}, {steps} steps "
            f"of {asr.step_samples / 16000 * 1e3:.0f} ms of audio: step latency p50 "
            f"{np.percentile(step_ms, 50):.2f} ms, p95 {np.percentile(step_ms, 95):.2f} ms, max "
            f"{step_ms.max():.2f} ms (first {step_ms[0]:.2f} ms); RTF of the steps {rtf:.4f}; "
            f"main() {wall:.3f} s with the model load (warm-up call on 5 s: {warm_wall:.3f} s); "
            f"{len(asr.tokens)} tokens, {len(final) - len('final: ')} characters of text; "
            f"launches {counts}; card {card}")
        require(steps == want_steps and len(asr.tokens) == c * steps,
                f"stream {dtype}: {steps} steps, {len(asr.tokens)} tokens; expected {want_steps}")
        require(counts == want, f"stream {dtype} launches {counts}, expected {want}")
        tokens[dtype] = np.asarray(asr.tokens)
        if dtype == "fp32":
            f32_fbank = counts["fbank_fft"]
            window = torch.from_numpy(samples[:need].astype(np.float32)).to(device)
            fbank_window = time_fbank_window("stream", window, card)
    differ = int((tokens["bf16"] != tokens["fp32"]).sum())
    log(f"stream: bf16 vs f32 frame tokens differ on {differ} of {tokens['fp32'].size}")

    # streaming_step against encode at R = 0 on the same features (as
    # tests/test_encoder_modes.py:127), f32
    model = ChunkFormerModel.from_pretrained(model_dir, device=device)
    encoder = model.model.encoder
    size, stride = reverse_calc_length(c), 8 * c
    pad = (stride - ((feats.shape[0] - size) % stride)) % stride
    x = F.pad(feats, (0, 0, 0, pad))
    att, cnn = encoder.init_caches(left, torch.float32, device, batch=1)
    outs = []
    with torch.inference_mode():
        for s, i in enumerate(range(0, x.shape[0] - size + stride, stride)):
            out, att, cnn = encoder.streaming_step(x[None, i:i + size], att, cnn, c, left, 0,
                                                   s * c)
            outs.append(out[0])
    streamed = torch.cat(outs)
    full, full_len = model.encode(x[None], [x.shape[0]], c, left, 0)
    n = min(streamed.shape[0], int(full_len[0]))
    err = float((streamed[:n] - full[0, :n]).abs().max())
    log(f"f32 streaming_step over {len(outs)} steps vs encode at {STREAM_CTX} on the same "
        f"{feats.shape[0]} frames: {n} outputs, max abs diff {err:.3g} (limit 2e-3)")
    require(bool(torch.isfinite(streamed).all()) and err <= 2e-3,
            f"streamed encoder vs encode at R = 0: {err}")
    del model, encoder, streamed, full, att, cnn, x
    torch.cuda.empty_cache()

    # recognize --simulate_streaming on the search files
    search_dir, test_list, wavs = search
    sc, sl, sr = SIM_CTX
    out_dir = os.path.join(tmp, "rec_sim")
    torch.cuda.synchronize()
    reset_counts()
    reset_train_counts()
    t0 = time.time()
    rc = recognize.main(["--model_checkpoint", search_dir, "--test_data", test_list,
                         "--result_dir", out_dir, "--modes", "ctc_greedy_search",
                         "--simulate_streaming", "--chunk_size", str(sc), "--left_context_size",
                         str(sl), "--right_context_size", str(sr)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {**read_counts(), **read_train_counts()}
    with open(os.path.join(out_dir, "ctc_greedy_search.txt"), encoding="utf-8") as f:
        rows = f.read().splitlines()
    want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0, "fbank_fft": len(wavs),
            "fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
    require(rc == 0 and len(rows) == len(wavs), f"recognize --simulate_streaming returned {rc} "
            f"with {len(rows)} lines")
    require(counts == want, f"recognize --simulate_streaming launches {counts}, expected {want}")
    # file by file (a padded batch depends on its padding, ROADMAP C9). The
    # last step's window reads zero features past the file's end, which the
    # valid frames of its chunk see (conv and attention inside the chunk),
    # where encode masks them: before the last chunk the two must agree, and
    # over every frame with encode of the features padded as the steps read them
    sm = ChunkFormerModel.from_pretrained(search_dir, device=device)
    frames = clear = flips = last_frames = last_flips = 0
    head_err = pad_err = 0.0
    frames_in = reverse_calc_length(sc) + 8 * sr
    for path in wavs:
        f = sm.extract_features(path)
        lens = torch.tensor([f.shape[0]], dtype=torch.int32)
        so, so_len = _streaming_encode(sm, f[None], lens, sc, sl, sr)
        eo, eo_len = sm.encode(f[None], lens, sc, sl, sr)
        require(int(so_len[0]) == int(eo_len[0]), f"{path}: lengths {so_len} vs {eo_len}")
        k = int(eo_len[0])
        read = (max(1, -(-k // sc)) - 1) * 8 * sc + frames_in
        fp = F.pad(f, (0, 0, 0, max(0, read - f.shape[0])))[:read]
        po, _ = sm.encode(fp[None], [read], sc, sl, sr)
        pad_err = max(pad_err, float((so[0, :k] - po[0, :k]).abs().max()))
        last = (k - 1) // sc * sc                      # first frame of the last chunk
        if last:
            head_err = max(head_err, float((so[0, :last] - eo[0, :last]).abs().max()))
        tok_s, _ = frame_tokens_and_gap(sm, so, so_len)
        tok_e, gap = frame_tokens_and_gap(sm, eo, eo_len)
        differ = tok_s != tok_e
        frames += last
        flips += int(differ[:last].sum())
        clear += int((differ & (gap >= 1e-3))[:last].sum())
        last_frames += k - last
        last_flips += int(differ[last:].sum())
    log(f"recognize --simulate_streaming ctc_greedy_search at {SIM_CTX}, {len(wavs)} files "
        f"({sum(SEARCH_SECONDS):.1f} s) in one batch, f32: main() {wall:.3f} s with the model "
        f"load, launches {counts}; file by file, streamed encoder vs encode at {SIM_CTX}: max "
        f"abs diff {head_err:.3g} before each file's last chunk (limit 2e-3), {pad_err:.3g} on "
        f"every frame against encode of the features zero-padded as the steps read them (limit "
        f"2e-3); frame tokens against encode of the file: before the last chunk {flips} of "
        f"{frames} differ, {clear} where the gap is 1e-3 or more (limit 0); in the last chunks "
        f"{last_flips} of {last_frames} differ; card {card}")
    require(head_err <= 2e-3 and pad_err <= 2e-3 and clear == 0,
            f"simulated streaming vs encode: max diff {head_err} / {pad_err}, {clear} clear flips")
    del sm
    torch.cuda.empty_cache()
    return f32_fbank, fbank_window


def phase_classification(tmp, card, device, search):
    """Multi-task classification at the widths of
    examples/classification/conf/multi_task.yaml (random weights from
    SEED + 13, a label_mapping.json) on the search files (8 of 4-40 s):
    ``bin/classify.py`` at full context in f32 and bf16 after a warm-up (one
    FFT fbank launch a file, no attention kernel); ``classify_audio`` at
    (128, 128, 128), f32 and bf16, file by file with its wall time and 12
    tensor-core B4 forward launches a file (one a block), no B5; the f32
    logits against the same model through the plain attention (atol 2e-3,
    labels equal); B4 timed at the longest file's shape. Returns (B4
    launches by dtype, B4 results by dtype)."""
    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.bin import classify
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import init_random_
    from chunkformer_tpu_torch.models.classification import (ClassificationModel,
                                                             classify_forward)

    _, test_list, wavs = search
    cfg = ChunkFormerConfig.from_dict(CLASSIFY)
    n_layers = cfg.encoder_conf.num_blocks
    tasks = sorted(cfg.classification_conf["tasks"])
    sd = init_random_(ClassificationModel(cfg),
                      torch.Generator().manual_seed(SEED + 13)).state_dict()
    model_dir = os.path.join(tmp, "classify_export")
    save_export(model_dir, CLASSIFY, sd, wav_features(wavs[-1], device),
                label_mapping=CLASSIFY_LABELS)
    for dtype in ("fp32", "fp32", "bf16"):   # the first call is the warm-up
        out = os.path.join(tmp, f"classify_{dtype}.tsv")
        torch.cuda.synchronize()
        reset_counts()
        reset_train_counts()
        t0 = time.time()
        rc = classify.main(["--model_checkpoint", model_dir, "--test_data", test_list,
                            "--output_file", out, "--dtype", dtype])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {**read_counts(), **read_train_counts()}
        with open(out, encoding="utf-8") as f:
            rows = f.read().splitlines()
        want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0,
                "fbank_fft": len(wavs), "fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
        require(rc == 0 and rows[0] == "key\t" + "\t".join(tasks) and len(rows) == len(wavs) + 1
                and all(r.split("\t")[i + 1] in CLASSIFY_LABELS[t] for r in rows[1:]
                        for i, t in enumerate(tasks)), f"classify {dtype}: rc {rc}, {rows[:2]}")
        require(counts == want, f"classify {dtype} launches {counts}, expected {want}")
        log(f"classify CLI {dtype}, full context: {len(wavs)} files ({sum(SEARCH_SECONDS):.1f} s)"
            f" in {wall:.3f} s with the model load, {wall / len(wavs):.3f} s a file; launches "
            f"{counts}; card {card}")

    launches, b4 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model = ChunkFormerModel.from_pretrained(model_dir, dtype=dtype, device=device)
        tag = "f32" if dtype == torch.float32 else "bf16"
        model.classify_audio(wavs[0], *CLASSIFY_CTX)   # warm-up
        secs, total = [], 0
        for path in wavs:
            torch.cuda.synchronize()
            reset_counts()
            reset_train_counts()
            t0 = time.time()
            preds = model.classify_audio(path, *CLASSIFY_CTX)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            counts = {**read_counts(), **read_train_counts()}
            want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0, "fbank_fft": 1,
                    "fwd": 0, "bwd": 0, "fwd_tc": n_layers, "bwd_tc": 0}
            require(counts == want, f"classify_audio {tag} launches {counts}, expected {want}")
            require(sorted(preds) == tasks and all(0.0 <= p["prob"] <= 1.0 for p in
                                                   preds.values()), f"classify_audio {preds}")
            total += counts["fwd_tc"]
        launches[tag] = total
        log(f"classify_audio {tag} at {CLASSIFY_CTX}: wall a file "
            + ", ".join(f"{s:g} s {1e3 * t:.2f} ms" for s, t in zip(SEARCH_SECONDS, secs))
            + f"; {total} tensor-core B4 forward launches ({n_layers} a file), no B5")

        # the kernels' logits against the plain attention, file by file
        with CaptureTrainAttention() as cap:
            feats = model.extract_features(wavs[-1])
            with torch.inference_mode():
                classify_forward(model.model, feats[None].to(dtype),
                                 torch.tensor([feats.shape[0]], device=device), *CLASSIFY_CTX)
        b4[tag] = time_eval_forward(tag, cap.args, dtype, card, CLASSIFY_CTX,
                                    f"classify_audio's shape ({SEARCH_SECONDS[-1]:.0f} s)")
        if dtype != torch.float32:
            continue
        err, differ = 0.0, 0
        for path in wavs:
            feats = model.extract_features(path)
            lens = torch.tensor([feats.shape[0]], device=device)
            with torch.inference_mode():
                got = classify_forward(model.model, feats[None], lens, *CLASSIFY_CTX)
                with CaptureTrainAttention(plain=True):
                    want = classify_forward(model.model, feats[None], lens, *CLASSIFY_CTX)
            for t in tasks:
                err = max(err, float((got[t] - want[t]).abs().max()))
                differ += int(got[t].argmax() != want[t].argmax())
        log(f"classify f32 logits at {CLASSIFY_CTX} through the kernels vs the plain attention, "
            f"{len(wavs)} files x {len(tasks)} tasks: max abs diff {err:.3g} (limit 2e-3), "
            f"labels differ on {differ} (limit 0)")
        require(err <= 2e-3 and differ == 0, f"classify logits vs plain: {err}, {differ} labels")
    return launches, b4


# ---- the transducer: the widths of chunkformer-rnnt-small.yaml
RNNT_CONF = "examples/asr/rnnt/conf/chunkformer-rnnt-small.yaml"
RNNT_SECONDS = 300.0     # endless_decode at a 120 s budget: 5 macro-segments
RNNT_BUDGET = 120
RNNT_MODES = ("rnnt_greedy_search", "rnnt_beam_search", "rnnt_beam_attn_rescoring")


def rnnt_config():
    """examples/asr/rnnt/conf/chunkformer-rnnt-small.yaml with the smoke's
    6992-symbol vocabulary (the config's units.txt and BPE model are not in
    the repository) and the decode configs' fbank settings (dither 0)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), RNNT_CONF)) as f:
        d = yaml.safe_load(f)
    return {**d, "output_dim": LARGE["output_dim"], "dataset_conf": LARGE["dataset_conf"]}


def rnnt_no_dropout(d):
    """The transducer config with every dropout at 0."""
    return {**d, "encoder_conf": {**d["encoder_conf"], "dropout_rate": 0.0,
                                  "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0},
            "decoder_conf": {**d["decoder_conf"], "dropout_rate": 0.0,
                             "positional_dropout_rate": 0.0},
            "predictor_conf": {**d["predictor_conf"], "embed_dropout": 0.0}}


def shape_joint(model, enc):
    """Makes the random joint stop on some frames: its encoder projection
    scaled by 4 and centred on the mean frame of ``enc`` [T, D] (a random
    encoder's frames differ little), its output layer scaled by 3, and the
    blank logit raised by the median margin of the best token over blank at
    the first predictor step. A random predictor does not learn to stop after
    an emission: on the 300 s file about a fifth of the frames emit blank
    only and most of the others loop to the 8-symbol cap, about 6 tokens a
    frame where speech has about 0.3 (PERF.md). A bias that aims at that rate
    sits on an edge: the frames' margins are so alike that the rate jumps
    between none and the cap on the encoder's rounding."""
    from chunkformer_tpu_torch.models.transducer import joint_forward, predictor_init_state

    with torch.no_grad():
        j = model.joint
        j.enc_ffn.weight.mul_(4.0)
        j.enc_ffn.bias.copy_(-(enc.mean(0) @ j.enc_ffn.weight.T))
        j.ffn_out.weight.mul_(3.0)
        state = predictor_init_state(model.predictor.cfg, 1, enc.dtype, enc.device)
        pred, _ = model.predictor.step(torch.zeros(1, dtype=torch.long, device=enc.device),
                                       state)
        logits = joint_forward(j, enc[None], pred[None])[0, :, 0]
        j.ffn_out.bias[0] += (logits[:, 1:].amax(-1) - logits[:, 0]).median()


class CaptureDecodeAttention:
    """Records the operands of the ``index``-th decode attention call."""

    def __init__(self, index):
        self.index, self.calls, self.args = index, 0, None

    def __enter__(self):
        from chunkformer_tpu_torch.nn import attention as attention_module

        self.module, self.routed = attention_module, attention_module.chunk_attention

        def call(*args, **kw):
            if self.calls == self.index:
                self.args = [a.clone() for a in args]
            self.calls += 1
            return self.routed(*args, **kw)

        attention_module.chunk_attention = call
        return self

    def __exit__(self, *exc):
        self.module.chunk_attention = self.routed


def time_decode_attention(label, args, card):
    """B1's tensor-core kernel against the plain version on captured
    operands: max error (f32 atol 1e-5; bf16 1e-2 + one ulp relative) and
    times in turns (2 rounds), bound as ``attention_bound``."""
    from chunkformer_tpu_torch.ops.chunk_attention import (chunk_attention_plain,
                                                           chunk_attention_tensor_core, route)

    f32 = args[0].dtype == torch.float32
    kw = dict(chunk=args[0].shape[1], left=LEFT, right=RIGHT)
    require(route(*args[:3]) == "tensor_core", f"{label}: not the tensor-core route")
    _, err = check_attention(label, chunk_attention_tensor_core, args,
                             *((1e-5, 0.0) if f32 else (1e-2, 2.0 ** -7)))
    ks, ps = [], []
    for _ in range(2):
        ks.append(cuda_ms(lambda: chunk_attention_tensor_core(*args, **kw), iters=50))
        ps.append(cuda_ms(lambda: chunk_attention_plain(*args, **kw), iters=5, warmup=1))
    ms, plain_ms = sum(ks) / 2, sum(ps) / 2
    bound_ms, bound_by = attention_bound(args, "tf32" if f32 else None)
    n, c, h, dk = args[0].shape
    log(f"{label}: B1 on the tensor cores at N={n} H={h} c={c} dk={dk} L=R={LEFT}: "
        f"max|kernel-plain| {err:.3g}; in turns (2 rounds): kernel {ms:.4f} ms "
        f"({', '.join(f'{x:.4f}' for x in ks)}), plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}, {ms / bound_ms:.1f}x; card {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def time_train_attention(label, args, card, seed=20261):
    """B4 (forward) and B5 (backward) on the tensor cores against their plain
    versions on captured operands at p = 0: forward ctx f32 atol 1e-5 (bf16
    1e-2 + one ulp relative), backward gradients f32 atol 1e-4 + rtol 1e-5,
    bf16 each of dq, dkv, dp, du, dv within 1e-2 relative L2 of the plain
    version. Times in turns (2 rounds), bounds as ``train_attention_bounds``.
    Returns {"fwd": ..., "bwd": ...}."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    args = [a.detach() for a in args]
    f32 = args[0].dtype == torch.float32
    st = (seed, C, LEFT, RIGHT, 0.0)
    require(cat.route(*args[:3], C) == "tensor_core", f"{label}: not the tensor-core route")
    ctx, m, den = cat.forward_kernel(*args, *st, path="tensor_core")
    want = cat.forward_plain(*args, *st)
    fwd_err = float((ctx.float() - want[0].float()).abs().max())
    tol = 1e-5 if f32 else 1e-2 + 2.0 ** -7 * want[0].float().abs()
    require(bool(((ctx.float() - want[0].float()).abs() <= tol).all()),
            f"{label}: forward max |kernel - plain| {fwd_err:.3g}")
    dctx = torch.randn(ctx.shape, generator=torch.Generator(device=ctx.device).manual_seed(seed),
                       device=ctx.device).to(ctx.dtype)
    got = cat.backward_kernel(*args, ctx, m, den, dctx, *st, path="tensor_core")
    plain = cat.backward_plain(*args, want[1], want[2], dctx, *st)
    bwd_err, rels = 0.0, {}
    for name, a, e in zip(("q", "kv", "p", "u", "v"), got, plain):
        err = (a.float() - e.float()).abs()
        bwd_err = max(bwd_err, float(err.max()))
        if f32:
            require(bool((err <= 1e-4 + 1e-5 * e.float().abs()).all()),
                    f"{label}: d{name} max |kernel - plain| {float(err.max()):.3g}")
            continue
        rels[name] = float((a.float() - e.float()).norm() / e.float().norm())
        require(rels[name] <= 1e-2, f"{label}: d{name} relative L2 error {rels[name]:.3g}")
    times = {k: [] for k in ("kf", "pf", "kb", "pb")}
    for _ in range(2):
        times["kf"].append(cuda_ms(lambda: cat.forward_kernel(*args, *st, path="tensor_core"),
                                   iters=20))
        times["pf"].append(cuda_ms(lambda: cat.forward_plain(*args, *st), iters=3, warmup=1))
        times["kb"].append(cuda_ms(lambda: cat.backward_kernel(
            *args, ctx, m, den, dctx, *st, path="tensor_core"), iters=20))
        times["pb"].append(cuda_ms(lambda: cat.backward_plain(*args, m, den, dctx, *st),
                                   iters=3, warmup=1))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    out = {}
    b, tp, h, dk = args[0].shape
    msg = f"{label}: B={b} T'={tp} H={h} c={C} dk={dk} L=R={LEFT}"
    if rels:
        msg += "; backward relative L2 vs plain (limit 1e-2) " + ", ".join(
            f"d{k} {r:.3g}" for k, r in rels.items())
    for part, k, p, err, backward in (("fwd", "kf", "pf", fwd_err, False),
                                      ("bwd", "kb", "pb", bwd_err, True)):
        bound_ms, bound_by = train_attention_bounds(args, backward, None if not f32 else "tf32")
        out[part] = dict(max_abs_err=err, ms=mean[k], plain_ms=mean[p], bound_ms=bound_ms,
                         bound_by=bound_by)
        msg += (f"; {'forward' if part == 'fwd' else 'backward'} max|kernel-plain| {err:.3g}, "
                f"in turns (2 rounds) kernel {mean[k]:.4f} ms "
                f"({', '.join(f'{x:.4f}' for x in times[k])}), plain {mean[p]:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}, {mean[k] / bound_ms:.1f}x")
    log(msg + f"; card {card}")
    return out


def rnnt_trainer(cfg_dict, device, autocast, seed):
    """A TransducerModel with weights from ``seed`` and its
    make_train_step(loss_fn=transducer_model_loss) at (64, 128, 128): adamw,
    warmuplr, clip 5."""
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import init_random_
    from chunkformer_tpu_torch.models.transducer import TransducerModel
    from chunkformer_tpu_torch.train.losses import transducer_model_loss
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step

    cfg = ChunkFormerConfig.from_dict(cfg_dict)
    model = init_random_(TransducerModel(cfg), torch.Generator().manual_seed(seed)).to(device)
    opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3}, "warmuplr",
                                 {"warmup_steps": 25000})
    return cfg, model, make_train_step(model, cfg, opt, sched, (C, LEFT, RIGHT),
                                       autocast=autocast, grad_clip=GRAD_CLIP,
                                       loss_fn=transducer_model_loss)


def phase_transducer(tmp, card, device, search):
    """The transducer at the widths of chunkformer-rnnt-small.yaml (256 d, 4
    heads, 12 blocks; LSTM predictor 2 x 256; joint 512; decoder 3 + 3;
    vocab 6992; random weights from SEED + 17, the joint shaped by
    ``shape_joint``) as an export ``from_pretrained`` loads:
    ``endless_decode`` of a 300 s file at (64, 128, 128) with a 120 s budget
    (5 macro-segments: the predictor carry crosses 4 boundaries) in f32 and
    bf16, its f32 frame tokens equal to one greedy pass over
    ``endless_encode``'s whole output from a fresh carry; ``batch_decode``
    of the three batch files; ``bin/recognize.py`` with the three rnnt_*
    modes (beam 10) on the search files, once as a warm-up, then f32 and
    bf16, audio-s/s by mode from its log; B1, B2 and B4 (eval) timed at these
    paths' shapes. Then the k2 transducer train step at the flagship batch
    shape (32 x 1600 frames, 48 labels, (64, 128, 128)): 3 bf16 steps
    (autocast) and 3 f32 steps with dropout on, ms a step, peak memory and
    12 B4 and 12 B5 launches a step; one f32 step (dropout 0) against the
    same step through the plain attention: loss 1e-5, gradients 1e-4
    relative L2, whole and by module; one bf16 step likewise, loss and whole
    gradient 1e-2; B4 and B5 timed at this shape.
    Returns (launches by kernel entry, timing results by kernel entry)."""
    from chunkformer_tpu_torch.api import ChunkFormerModel, endless_sizing
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import init_random_
    from chunkformer_tpu_torch.models.transducer import (TransducerModel,
                                                         transducer_greedy_search)
    from chunkformer_tpu_torch.ops.fbank import fbank, num_frames
    from chunkformer_tpu_torch.train import losses

    cfg_dict = rnnt_config()
    cfg = ChunkFormerConfig.from_dict(cfg_dict)
    n_layers = cfg.encoder_conf.num_blocks
    rng = np.random.default_rng(SEED + 17)
    long_wav = write_wav(os.path.join(tmp, "rnnt_long.wav"), speechlike(rng, RNNT_SECONDS))
    batch_wavs = [write_wav(os.path.join(tmp, f"rnnt_b{i}.wav"), speechlike(rng, sec))
                  for i, sec in enumerate(BATCH_SECONDS)]
    _, test_list, search_wavs = search

    # the export: CMVN from the long file's first minute, the joint shaped on it
    from scipy.io import wavfile

    head = fbank(torch.from_numpy(wavfile.read(long_wav)[1][:16000 * 60].astype(np.float32))
                 .to(device))
    model = init_random_(TransducerModel(cfg),
                         torch.Generator().manual_seed(SEED + 17)).to(device)
    with torch.no_grad():
        model.encoder.global_cmvn.mean.copy_(head.mean(0))
        model.encoder.global_cmvn.istd.copy_(1.0 / head.std(0).clamp_min(1e-3))
        enc, _ = model.encoder.forward_train(head[None], torch.tensor([head.shape[0]],
                                                                      device=device),
                                             0, 0, 0, train=False)
    shape_joint(model, enc[0])
    model_dir = os.path.join(tmp, "rnnt_export")
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    save_export(model_dir, cfg_dict, sd, head, symbols=vocabulary(cfg.vocab_size))
    del model, enc
    log(f"transducer export: {RNNT_CONF} widths, vocab {cfg.vocab_size}, "
        f"{sum(v.numel() for v in sd.values())} values; predictor "
        f"{cfg.predictor_conf.predictor_type} {cfg.predictor_conf.num_layers} x "
        f"{cfg.predictor_conf.hidden_size}, joint {cfg.joint_conf.join_dim}")

    models = {"f32": ChunkFormerModel.from_pretrained(model_dir, device=device),
              "bf16": ChunkFormerModel.from_pretrained(model_dir, dtype=torch.bfloat16,
                                                       device=device)}
    require(all(m.is_transducer and m.model.simple_am_proj is not None
                and m.model.ctc is not None and m.model.decoder is not None
                for m in models.values()),
            "the transducer export did not load with all its heads")
    ctx = (C, LEFT, RIGHT)
    trunc, rel_right, step_raw, _, capacity = endless_sizing(cfg.encoder_conf, C, RIGHT,
                                                             RNNT_BUDGET)
    t_feats = num_frames(int(RNNT_SECONDS * 16000))
    starts = list(range(0, t_feats, step_raw))     # as api.py's _endless_segments walks them
    n_seg = next((i + 1 for i, st in enumerate(starts) if st + rel_right >= t_feats),
                 len(starts))
    require(n_seg >= 3,
            f"the {RNNT_SECONDS:.0f} s file has {n_seg} macro-segments at {RNNT_BUDGET} s")
    models["f32"].endless_decode(batch_wavs[0], *ctx,
                                 total_batch_duration=RNNT_BUDGET)   # warm-up
    launches, results, frames_by = {}, {}, {}
    for tag, m in models.items():
        reset_counts()
        reset_train_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        segments = m.endless_decode(long_wav, *ctx, total_batch_duration=RNNT_BUDGET)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {**read_counts(), **read_train_counts()}
        want = {"chunk_attention": 0, "chunk_attention_tc": n_layers * n_seg,
                "fbank": 0, "fbank_fft": 1, "fwd": 0, "bwd": 0, "fwd_tc": 0,
                "bwd_tc": 0}
        require(counts == want, f"transducer endless_decode {tag} launches {counts}, "
                f"expected {want}")
        launches[f"endless {tag}"] = counts
        feats = m.extract_features(long_wav)
        torch.cuda.synchronize()
        t0 = time.time()
        enc = m.endless_encode(feats, *ctx, RNNT_BUDGET)
        torch.cuda.synchronize()
        enc_s = time.time() - t0
        t0 = time.time()
        frames = m.endless_rnnt_tokens(feats, *ctx, RNNT_BUDGET)
        torch.cuda.synchronize()
        rnnt_s = time.time() - t0
        frames_by[tag] = frames
        emitted = (frames != 0).sum(1)
        steps = np.minimum(emitted + 1, 8)
        blank_share = float((emitted == 0).mean())
        n_tokens = int(emitted.sum())
        log(f"transducer endless_decode {tag} of {RNNT_SECONDS:.0f} s at {ctx}, budget "
            f"{RNNT_BUDGET} s "
            f"({n_seg} macro-segments of {trunc} frames, capacity {capacity}): {wall:.3f} s, "
            f"{RNNT_SECONDS / wall:.1f} audio-s/s; endless_encode alone {enc_s:.3f} s, "
            f"endless_rnnt_tokens {rnnt_s:.3f} s, so the greedy search about "
            f"{rnnt_s - enc_s:.3f} s for {frames.shape[0]} frames, {int(steps.sum())} emit steps "
            f"(a host sync each but a frame's 8th), {1e3 * (rnnt_s - enc_s) / steps.sum():.3f} ms "
            f"a step; {n_tokens / frames.shape[0]:.4f} tokens a frame, blank-only frames "
            f"{blank_share:.4f}, frames by symbols emitted "
            f"{np.bincount(emitted, minlength=9).tolist()}, {n_tokens} tokens in "
            f"{len(segments)} segments; launches {counts}; card {card}")
        require(0.0 < blank_share < 1.0 and n_tokens > 0,
                f"{tag}: blank-only frame share {blank_share}")
        if tag == "f32":
            # the fused carry against one pass over the whole encoder output
            with torch.inference_mode():
                whole = transducer_greedy_search(m.model, m.config, enc[None], [enc.shape[0]], 8)
            same = np.array_equal(frames, whole[0].cpu().numpy())
            log(f"transducer f32: endless_decode's tokens with the predictor carry across "
                f"{n_seg - 1} segment boundaries vs one greedy pass over endless_encode's "
                f"{enc.shape[0]} frames from a fresh carry: "
                f"{'equal' if same else 'DIFFERENT'}")
            require(same, "the segmented transducer greedy differs from the whole-file pass")
        del enc
    diff = int((frames_by["f32"] != frames_by["bf16"]).any(1).sum())
    log(f"transducer endless bf16 vs f32: frame tokens differ on {diff} of "
        f"{frames_by['f32'].shape[0]} frames (random weights)")

    for tag, m in models.items():
        m.batch_decode(batch_wavs[:1], *ctx)   # warm-up
        reset_counts()
        reset_train_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        texts = m.batch_decode(batch_wavs, *ctx)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {**read_counts(), **read_train_counts()}
        want = {"chunk_attention": 0, "chunk_attention_tc": n_layers,
                "fbank": 0, "fbank_fft": len(batch_wavs), "fwd": 0, "bwd": 0,
                "fwd_tc": 0, "bwd_tc": 0}
        require(counts == want and len(texts) == len(batch_wavs) and any(texts),
                f"transducer batch_decode {tag}: launches {counts}, expected {want}; "
                f"{len(texts)} texts")
        launches[f"batch {tag}"] = counts
        log(f"transducer batch_decode {tag} of {sum(BATCH_SECONDS):.1f} s in 3 files at {ctx}: "
            f"{wall:.3f} s, {sum(BATCH_SECONDS) / wall:.1f} audio-s/s; "
            f"{[len(t) for t in texts]} characters; launches {counts}; card {card}")

    grab = LogLines()
    logging.getLogger().addHandler(grab)
    logging.getLogger().setLevel(logging.INFO)
    audio_s = sum(wavfile.read(w)[1].size / 16000.0 for w in search_wavs)
    try:
        run_recognize(model_dir, test_list, os.path.join(tmp, "rnnt_rec_warm"), "fp32", grab,
                      RNNT_MODES)
        for dtype in ("fp32", "bf16"):
            wall, parts, counts, peak = run_recognize(
                model_dir, test_list, os.path.join(tmp, f"rnnt_rec_{dtype}"), dtype, grab,
                RNNT_MODES)
            want = {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0,
                    "fbank_fft": len(search_wavs), "fwd": 0, "bwd": 0,
                    "fwd_tc": n_layers, "bwd_tc": 0}
            require(counts == want, f"transducer recognize {dtype} launches {counts}, "
                    f"expected {want}")
            launches[f"recognize {dtype}"] = counts
            enc_s = parts["features and encode"]
            log(f"transducer recognize {dtype}: {len(search_wavs)} files in one batch at {ctx}, "
                f"beam {BEAM}: main() {wall:.3f} s with the model load; features and encode "
                f"{enc_s:.4f} s; by mode, features + encode + search: " + ", ".join(
                    f"{m} {enc_s + parts[m]:.4f} s ({audio_s / (enc_s + parts[m]):.1f} "
                    f"audio-s/s)" for m in RNNT_MODES)
                + f"; peak device memory {peak:.2f} GiB; launches {counts}; card {card}")
    finally:
        logging.getLogger().removeHandler(grab)

    wave = torch.from_numpy(wavfile.read(long_wav)[1].astype(np.float32)).to(device)
    results["fbank"] = time_fbank_window("transducer", wave, card,
                                         f"the {RNNT_SECONDS:.0f} s file")
    for tag, m in models.items():
        feats = m.extract_features(long_wav)
        with CaptureDecodeAttention(n_layers) as cap:   # the second segment's first layer
            m.endless_encode(feats, *ctx, RNNT_BUDGET)
        results[f"B1 {tag}"] = time_decode_attention(
            f"transducer endless {tag}, a middle segment", cap.args, card)
        feats_b, xs, lens = padded_batch(m, search_wavs)
        with CaptureTrainAttention() as cap:
            m.encode(xs, lens, *ctx)
        results[f"B4 eval {tag}"] = time_eval_forward(
            f"transducer {tag}", cap.args, torch.float32 if tag == "f32" else torch.bfloat16,
            card, ctx, "the transducer's recognize batch")
    del models

    # the k2 transducer train step
    b, t_frames, u_labels = TRAIN_BATCH, TRAIN_FRAMES, TRAIN_LABELS

    def batch_on(seed_):
        g = torch.Generator(device=device).manual_seed(seed_)
        return (torch.randn(b, t_frames, 80, generator=g, device=device),
                torch.full((b,), t_frames, dtype=torch.int32, device=device),
                torch.randint(1, cfg.vocab_size - 2, (b, u_labels), generator=g, device=device),
                torch.full((b,), u_labels, dtype=torch.int32, device=device))

    batch = batch_on(SEED + 19)
    for tag, autocast in (("bf16", torch.bfloat16), ("f32", None)):
        _, model, step = rnnt_trainer(cfg_dict, device, autocast, SEED + 18)
        gen = torch.Generator().manual_seed(SEED + 20)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        reset_train_counts()
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            with (CaptureTrainAttention() if i == 0 else contextlib.nullcontext()) as cap:
                m = {k: float(v) for k, v in step(*batch, gen).items()}
            times.append(time.time() - t0)
            metrics.append(m)
            if i == 0:
                args = cap.args
        counts = read_train_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        warm = times[1:]
        step_s = sum(warm) / len(warm)
        for i, (t, m) in enumerate(zip(times, metrics)):
            log(f"transducer train step {i + 1} {tag}: {1e3 * t:.1f} ms, " + ", ".join(
                f"{k} {v:.5g}" for k, v in m.items()))
            require(all(np.isfinite(v) for v in m.values()), f"non-finite metrics {m}")
        want = {"fwd": 0, "bwd": 0, "fwd_tc": n_layers * TRAIN_STEPS,
                "bwd_tc": n_layers * TRAIN_STEPS}
        require(counts == want, f"transducer train {tag} launches {counts}, expected {want}")
        launches[f"train {tag}"] = counts
        log(f"transducer train {tag} (k2: smoothed + pruned, prune_range "
            f"{cfg.model_conf.prune_range}; B={b} x {t_frames} frames, U={u_labels}, {ctx}): "
            f"{1e3 * step_s:.1f} ms a step over steps 2-{TRAIN_STEPS}, "
            f"{b * t_frames / 100.0 / step_s:.1f} train audio-s/s (first step "
            f"{1e3 * times[0]:.1f} ms); peak device memory {peak:.2f} GiB; launches {counts}; "
            f"card {card}")
        del model, step
        results[f"train {tag}"] = time_train_attention(
            f"transducer train {tag}", args, card)
        del args

    # one step (dropout 0) through the kernels and through the plain attention,
    # f32 (loss 1e-5; gradients 1e-4 relative L2, whole and by module) and
    # bf16 (loss and whole gradient 1e-2, the single-op bf16 bar)
    record = losses.rnnt_prune_bounds
    none = {"fwd": 0, "bwd": 0, "fwd_tc": 0, "bwd_tc": 0}
    for tag, autocast, loss_bar, grad_bar in (("f32", None, 1e-5, 1e-4),
                                              ("bf16", torch.bfloat16, 1e-2, 1e-2)):
        runs = {}
        for route in ("kernels", "plain"):
            _, model, step = rnnt_trainer(rnnt_no_dropout(cfg_dict), device, autocast, SEED + 18)
            if route == "plain":
                for layer in model.encoder.encoders:
                    layer.self_attn.chunked_train = layer.self_attn.attention_chunked_train
            bounds = []
            losses.rnnt_prune_bounds = lambda *a, **k: bounds.append(record(*a, **k)) or bounds[-1]
            reset_train_counts()
            try:
                m = step(*batch)
            finally:
                losses.rnnt_prune_bounds = record
            unclip = max(1.0, float(m["grad_norm"]) / GRAD_CLIP)
            runs[route] = (float(m["loss"]), {n: p.grad.detach().float() * unclip
                                              for n, p in model.named_parameters()},
                           read_train_counts(), bounds[0])
            del model, step
        (loss_k, g_k, counts_k, b_k), (loss_p, g_p, counts_p, b_p) = runs["kernels"], runs["plain"]
        groups = {g: [n for n in g_p if n.startswith(g + ".")]
                  for g in ("encoder", "predictor", "joint", "ctc", "decoder", "simple_am_proj",
                            "simple_lm_proj")}
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        whole = rel_l2(g_k, g_p, list(g_p))
        group_rel = {g: rel_l2(g_k, g_p, names) for g, names in groups.items()}
        # per parameter, relative to its own gradient norm floored at 1e-6 of the
        # whole gradient's (the key biases' gradients are zero in exact arithmetic)
        floor = 1e-6 * float(torch.sqrt(sum(g.square().sum() for g in g_p.values())))
        worst = max((float((g_k[n] - g_p[n]).norm()) / max(float(g_p[n].norm()), floor), n)
                    for n in g_p)
        log(f"transducer train {tag} step (dropout 0) through the kernels vs the plain "
            f"attention: loss {loss_k:.8g} vs {loss_p:.8g}, relative difference {loss_rel:.3g} "
            f"(limit {loss_bar:g}); prune-band starts differing {int((b_k != b_p).sum())} of "
            f"{b_k.numel()}; gradient relative L2 difference whole {whole:.3g} (limit "
            f"{grad_bar:g}), by module " + ", ".join(f"{g} {v:.3g}" for g, v in group_rel.items())
            + (" (limit 1e-4 each)" if tag == "f32" else "")
            + f"; worst parameter {worst[0]:.3g} at {worst[1]}; launches {counts_k} vs "
            f"{counts_p}")
        require(np.isfinite(loss_k) and loss_rel <= loss_bar,
                f"transducer {tag} loss differs by {loss_rel}")
        require(whole <= grad_bar and (tag != "f32" or max(group_rel.values()) <= grad_bar),
                f"transducer {tag} gradients differ: whole {whole}, by module {group_rel}")
        require(counts_p == none, f"the plain {tag} step launched {counts_p}")
        require(counts_k == {**none, "fwd_tc": n_layers, "bwd_tc": n_layers},
                f"the {tag} step launched {counts_k}")
    return launches, results


# ---- the train CLI: bin/train.py main(argv) at the flagship width on
# synthetic data, a resume, one step through DDP, bin/average_model.py, the
# export of the average and its decode
CLI_FILES, CLI_DEV_FILES, CLI_SECONDS, CLI_DECODE_SECONDS = 64, 8, (4.0, 16.0), 120.0
CLI_CONFIG = {
    **{k: v for k, v in TRAIN.items() if k != "output_dim"},
    "encoder_conf": {**TRAIN["encoder_conf"], "dynamic_chunk_sizes": [C],
                     "dynamic_left_context_sizes": [LEFT],
                     "dynamic_right_context_sizes": [RIGHT]},
    "tokenizer": "char",
    # examples/asr/ctc/conf/chunkformer-ctc-small.yaml:59-89, at the flagship's
    # 32 x 1600 frames a batch
    "dataset_conf": {
        "filter_conf": {"max_length": 40960, "min_length": 0, "token_max_length": 400,
                        "token_min_length": 1},
        "resample_conf": {"resample_rate": 16000},
        "speed_perturb": True,
        "fbank_conf": {"num_mel_bins": 80, "frame_shift": 10, "frame_length": 25,
                       "dither": 1.0},
        "spec_aug": True,
        "spec_aug_conf": {"num_t_mask": 2, "num_f_mask": 2, "max_t": 50, "max_f": 10},
        "shuffle": True, "shuffle_conf": {"shuffle_size": 1000},
        "sort": True, "sort_conf": {"sort_size": 500},
        "batch_conf": {"batch_type": "dynamic", "max_frames_in_batch": 51200}},
    "grad_clip": GRAD_CLIP, "accum_grad": 1, "max_epoch": 2, "log_interval": 1,
    "optim": "adamw", "optim_conf": {"lr": 1e-3},
    "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 25000},
}


def write_train_data(root):
    """64 WAVs of 4-16 s (seeded tones and noise) with random texts over a
    char vocabulary of 6992 symbols, train.list and dev.list (8 of the files)
    as key<TAB>wav<TAB>txt, units.txt, and a JSON CMVN file computed from the
    files' fbank. Returns the config dict for bin/train.py."""
    from chunkformer_tpu_torch.data.processor import compute_fbank_numpy

    rng = np.random.default_rng(SEED + 41)
    symbols = (["<blank>", "<unk>", "▁"] + [chr(0x4E00 + i) for i in range(6988)]
               + ["<sos/eos>"])
    with open(os.path.join(root, "units.txt"), "w", encoding="utf-8") as f:
        f.writelines(f"{sym} {i}\n" for i, sym in enumerate(symbols))
    lines, stats = [], [np.zeros(80), np.zeros(80), 0]
    for i in range(CLI_FILES):
        seconds = float(rng.uniform(*CLI_SECONDS))
        wav = write_wav(os.path.join(root, f"utt{i:02d}.wav"), speechlike(rng, seconds))
        text = "".join(symbols[j] for j in rng.integers(3, 6991, size=int(3 * seconds)))
        lines.append(f"utt{i:02d}\t{wav}\t{text}\n")
        if i < 16:
            from scipy.io import wavfile

            feat = compute_fbank_numpy(wavfile.read(wav)[1].astype(np.float32)).astype(
                np.float64)
            stats = [stats[0] + feat.sum(0), stats[1] + (feat ** 2).sum(0),
                     stats[2] + len(feat)]
    with open(os.path.join(root, "train.list"), "w", encoding="utf-8") as f:
        f.writelines(lines)
    with open(os.path.join(root, "dev.list"), "w", encoding="utf-8") as f:
        f.writelines(lines[:CLI_DEV_FILES])
    with open(os.path.join(root, "global_cmvn"), "w") as f:
        json.dump({"mean_stat": stats[0].tolist(), "var_stat": stats[1].tolist(),
                   "frame_num": stats[2]}, f)
    return {**CLI_CONFIG,
            "tokenizer_conf": {"symbol_table_path": os.path.join(root, "units.txt"),
                               "split_with_space": False},
            "cmvn": "global_cmvn",
            "cmvn_conf": {"cmvn_file": os.path.join(root, "global_cmvn"), "is_json_cmvn": True}}


def run_train_cli(argv, label, card):
    """bin/train.py's ``run(argv)`` (``main``'s body) with the training
    attention's and the decode kernels' counts read around it; prints each
    step's time beside its host data time. Returns (executor, train counts,
    peak GiB)."""
    from chunkformer_tpu_torch.bin import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    reset_counts()
    t0 = time.time()
    ex = train.run(argv + ["--device", "cuda"])
    wall = time.time() - t0
    counts, decode = read_train_counts(), read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(ex.timings)
    for i, (data_s, step_s, frames) in enumerate(ex.timings):
        log(f"{label} step {i + 1}: {1e3 * step_s:.1f} ms on the card, host data "
            f"{1e3 * data_s:.1f} ms (fbank, speed perturb, spec_aug, batching), "
            f"{frames / 100.0:.1f} audio-s, {frames / 100.0 / (data_s + step_s):.1f} train "
            f"audio-s/s with the data")
    warm = ex.timings[1:] or ex.timings
    step_ms = 1e3 * sum(t[1] for t in warm) / len(warm)
    data_s = sum(t[0] for t in ex.timings)
    busy_s = sum(t[1] for t in ex.timings)
    audio_s = sum(t[2] for t in ex.timings) / 100.0
    log(f"{label}: {steps} steps in {wall:.1f} s of CLI (CV, checkpoints and set-up "
        f"included); step {step_ms:.1f} ms (mean of steps 2-{steps}, or step 1 alone); over "
        f"all steps {busy_s:.2f} s of steps and {data_s:.2f} s of host data (the sort buffer "
        f"holds a whole epoch, so an epoch's first batch waits for all its files), "
        f"{audio_s:.1f} audio-s, {audio_s / (busy_s + data_s):.1f} train audio-s/s with the "
        f"data, {audio_s / busy_s:.1f} without; peak device memory {peak:.2f} GiB; B4/B5 "
        f"launches {counts}; card {card}")
    n_layers = ex.cfg.encoder_conf.num_blocks
    want = {"fwd": 0, "bwd": 0, "fwd_tc": n_layers * steps, "bwd_tc": n_layers * steps}
    require(counts == want, f"{label}: train attention launches {counts}, expected {want}")
    require(not any(decode.values()), f"{label}: a decode kernel launched: {decode}")
    return ex, counts, peak


def phase_train_cli(tmp, card):
    """The train CLI at the flagship width (bench.py:149-177 with the
    dataset_conf of chunkformer-ctc-small.yaml at 51200 frames a batch,
    dynamic chunks fixed at (64, 128, 128), f32) on ``write_train_data``:
    two epochs; a resume from epoch_0; one step through DDP at world size 1
    on NCCL (the one card: larger worlds are not tested here); the sharding
    modes at world size 1 against a dp run (``sharded_train_cli``); for the
    two-epoch run and the fsdp_tp run, ``check_average_export``. The
    features come from the native host library's fbank (dither on), timed
    beside its numpy twin on the train files. Returns the launch counts of
    the dp train runs, of the decode of their average, of the sharded runs
    and of the decode of the fsdp_tp average."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.train.checkpoint import list_checkpoints, load_checkpoint

    root = os.path.join(tmp, "train_cli")
    os.makedirs(root)
    config = write_train_data(root)
    host_fbank_times(root)
    conf_path = os.path.join(root, "conf.yaml")
    with open(conf_path, "w") as f:
        json.dump(config, f)
    exp = os.path.join(root, "exp")
    argv = ["--config", conf_path, "--train_data", os.path.join(root, "train.list"),
            "--cv_data", os.path.join(root, "dev.list"), "--model_dir", exp]

    ex, counts, peak = run_train_cli(argv, "train CLI", card)
    steps0 = ex.step
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    require(len(lines) == steps0 and all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
                                         for x in lines), f"train CLI metrics {lines}")
    tags = [c["tag"] for c in list_checkpoints(exp)]
    require(tags == ["epoch_0", "epoch_1"], f"train CLI checkpoints {tags}")
    info0 = load_checkpoint(exp, "epoch_0")[3]
    losses = ", ".join(f"{x['loss']:.4g}" for x in lines)
    log(f"train CLI: {steps0} steps over 2 epochs, losses {losses}; checkpoints {tags}, "
        f"epoch_0 at step {info0['step']} cv_loss {info0['cv_loss']:.4g}")

    rex, rcounts, _ = run_train_cli(argv + ["--checkpoint", "epoch_0"], "train CLI resumed",
                                    card)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        resumed = [json.loads(x) for x in f][steps0:]
    _, opt1, sched1, info1 = load_checkpoint(exp, "epoch_1")
    adam_steps = {int(st["step"]) for st in opt1["state"].values()}
    require(resumed and resumed[0]["step"] == info0["step"] + 1 and resumed[0]["epoch"] == 1
            and rex.step == steps0 and info1["step"] == steps0
            and sched1["last_epoch"] == steps0 and adam_steps == {steps0},
            f"resume: first step {resumed[:1]}, last step {rex.step} (want {steps0}), "
            f"adam steps {adam_steps}")
    log(f"train CLI resumed from epoch_0 (step {info0['step']}): epoch 1 from step "
        f"{resumed[0]['step']} to {rex.step}, adam's step count {adam_steps} continued from "
        f"the saved state")
    del opt1

    with world_of_one():
        dex, dcounts, _ = run_train_cli(
            argv[:-1] + [os.path.join(root, "ddp"), "--distributed", "--override_config",
                         "max_epoch 1", "--override_config", "dataset_conf.epoch_steps 1"],
            "train CLI --distributed", card)
        require(dist.is_initialized() and dist.get_world_size() == 1
                and dist.get_backend() == "nccl" and dex.parallel.loss_fn is not dex.loss_fn
                and dex.step == 1, "the DDP run did not step once through DDP on nccl")
        log("train CLI --distributed: one step through DistributedDataParallel on nccl "
            "at world size 1 (one card: larger worlds are not tested here)")
    del dex
    shard_counts, fsdp_tp_exp = sharded_train_cli(argv, root, card)
    total = {k: counts[k] + rcounts[k] + dcounts[k] for k in counts}
    decode_counts = check_average_export(exp, config, root, "export", card)
    decode_counts_sharded = check_average_export(fsdp_tp_exp, config, root, "export_fsdp_tp",
                                                 card)
    return total, decode_counts, shard_counts, decode_counts_sharded


def sharded_train_cli(argv, root, card):
    """bin/train.py --distributed at world size 1 on NCCL with --sharding
    fsdp, tp and fsdp_tp (mesh (1, 1): DTensor parameters, FSDP's hooks,
    the tensor-parallel operators and the kernels on the rank's heads),
    two steps each (one an epoch) on the data and seed of a plain dp run
    of the same two steps: losses within rtol 1e-5, gradient norms within
    1e-4 and parameters within 1e-5 of the dp run's, 17 + 17 tensor-core B4/B5 launches a step
    (``run_train_cli``). Returns the sharded runs' launch counts and the
    fsdp_tp run's model_dir."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.train.checkpoint import load_checkpoint

    def two_steps(name, *extra):
        out = os.path.join(root, name)
        return argv[:-1] + [out, "--override_config", "dataset_conf.epoch_steps 1",
                            *extra], out

    ref_argv, ref_dir = two_steps("dp_ref")
    ref, _, _ = run_train_cli(ref_argv, "train CLI dp, two steps", card)
    del ref
    with open(os.path.join(ref_dir, "metrics.jsonl")) as f:
        want_metrics = [json.loads(x) for x in f]
    want = load_checkpoint(ref_dir, "epoch_1")[0]
    total = None
    for mode in ("fsdp", "tp", "fsdp_tp"):
        mode_argv, mode_dir = two_steps(mode, "--distributed", "--sharding", mode)
        with world_of_one():
            sex, counts, _ = run_train_cli(mode_argv, f"train CLI --sharding {mode}", card)
            require(dist.get_backend() == "nccl" and sex.dp.mode == mode
                    and sex.dp.mesh is not None and sex.step == 2,
                    f"--sharding {mode}: not two steps on a nccl mesh")
            sharded = any(hasattr(p, "device_mesh") for p in sex.model.parameters())
            require(sharded == (mode != "tp"), f"--sharding {mode}: DTensor parameters "
                    f"{sharded}")
            tp_modules = sum(getattr(m, "tp", None) is not None for m in sex.model.modules())
            require((tp_modules > 0) == (mode != "fsdp"),
                    f"--sharding {mode}: {tp_modules} tensor-parallel modules")
        del sex
        torch.cuda.empty_cache()
        with open(os.path.join(mode_dir, "metrics.jsonl")) as f:
            got_metrics = [json.loads(x) for x in f]
        def rel(keys):
            return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                       for g, w in zip(got_metrics, want_metrics) for k in keys)

        loss_err, norm_err = rel(("loss", "loss_ctc", "loss_att")), rel(("grad_norm",))
        got = load_checkpoint(mode_dir, "epoch_1")[0]
        require(got.keys() == want.keys(), f"--sharding {mode}: checkpoint keys differ")
        param_err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
        log(f"train CLI --sharding {mode} (world size 1, nccl): losses within rtol "
            f"{loss_err:.3g} of the dp run's (limit 1e-5), gradient norms within "
            f"{norm_err:.3g} (limit 1e-4, the gradients' bar), parameters after two steps "
            f"within {param_err:.3g} (limit 1e-5); launches {counts}; card {card}")
        require(len(got_metrics) == len(want_metrics) == 2 and loss_err <= 1e-5
                and norm_err <= 1e-4 and param_err <= 1e-5,
                f"--sharding {mode} differs from dp: losses {loss_err}, gradient norms "
                f"{norm_err}, parameters {param_err}")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
        del got
    return total, mode_dir


@contextlib.contextmanager
def world_of_one():
    """torchrun's environment for a world of one process (a free local port),
    the process group destroyed and the environment restored after."""
    import socket

    import torch.distributed as dist

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost"}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        env["MASTER_PORT"] = str(sock.getsockname()[1])
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_fbank_times(root):
    """The native host library's fbank (the train CLI's features) against its
    numpy twin on the train files at the CLI's dither 1.0, in host seconds;
    the twin within 2e-3 of the library at dither 0 on 5 s of Gaussian noise
    (the bar of tests/test_native.py; on the train files' tones and pauses
    the quietest bands differ more, printed)."""
    from scipy.io import wavfile

    from chunkformer_tpu_torch import native
    from chunkformer_tpu_torch.data.processor import compute_fbank_numpy

    waves = [wavfile.read(os.path.join(root, f"utt{i:02d}.wav"))[1].astype(np.float32)
             for i in range(CLI_FILES)]
    audio_s = sum(len(w) for w in waves) / 16000.0
    t = time.perf_counter()
    feats = [native.fbank(w, dither=1.0, seed=i) for i, w in enumerate(waves)]
    t_native = time.perf_counter() - t
    rng = np.random.default_rng(SEED)
    t = time.perf_counter()
    for w in waves:
        compute_fbank_numpy(w, dither=1.0, rng=rng)
    t_numpy = time.perf_counter() - t
    noise = (np.random.default_rng(SEED).normal(size=16000 * 5) * 3000).astype(np.float32)
    err = float(np.abs(native.fbank(noise) - compute_fbank_numpy(noise)).max())
    err_file = float(np.abs(native.fbank(waves[0]) - compute_fbank_numpy(waves[0])).max())
    log(f"host fbank on the {CLI_FILES} train files ({audio_s:.1f} audio-s, dither 1.0, "
        f"{os.cpu_count()} host cores): native library {t_native:.3f} s "
        f"({audio_s / t_native:.0f} audio-s/s), numpy twin {t_numpy:.3f} s "
        f"({audio_s / t_numpy:.0f} audio-s/s); twin vs library at dither 0, max abs diff "
        f"{err:.3g} on 5 s of noise (limit 2e-3), {err_file:.3g} on the first train file")
    require(all(np.isfinite(f).all() for f in feats) and err <= 2e-3,
            f"native fbank: twin differs by {err}")


def phase_upload(card, device, cfg, sd, long_wav):
    """The long-form entries from host features at ChunkFormer-large width,
    bf16 (int8 crossing with one global scale) and f32: ``endless_decode`` of
    the 2040 s file (features on the card, quantized there in bf16), then
    ``endless_encode_tokens`` from the same features fetched to the host,
    written with ``data/kaldi_io.py:write_ark`` and read back as numpy; its
    tokens must equal endless_decode's exactly, and the host quantizer's int8
    tensor and scale the card's bit for bit. Prints the bytes each way
    uploads, the host-to-device copy time, wall times and audio-s/s.
    Returns the launch counts of the host-feature runs."""
    from chunkformer_tpu_torch.api import ChunkFormerModel, quantize_int8, quantize_int8_tensor
    from chunkformer_tpu_torch.data import kaldi_io

    n_layers = cfg.encoder_conf.num_blocks
    counts = {}
    tmp = os.path.dirname(long_wav)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        model = ChunkFormerModel(cfg, sd, None, dtype=dtype, device=device)
        model.endless_decode(long_wav, C, LEFT, RIGHT, BUDGET)  # warm-up

        def timed(fn, *args):
            """(result, wall seconds of three calls, median first)"""
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(*args, C, LEFT, RIGHT, BUDGET)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
            return out, [sorted(walls)[1]] + walls

        want, t_decode = timed(model.endless_decode, long_wav)
        feats = model.extract_features(long_wav)
        on_card, t_card = timed(model.endless_encode_tokens, feats)
        card_bytes = model.bytes_uploaded

        t0 = time.time()
        host = feats.cpu().numpy()
        t_fetch = time.time() - t0
        ark = os.path.join(tmp, f"feats_{tag}.ark")
        kaldi_io.write_ark(ark, [("long", host)])
        (key, host_read), = list(kaldi_io.read_ark(ark))
        require(key == "long" and np.array_equal(host_read, host),
                "kaldi_io did not read back the features it wrote")
        os.remove(ark)
        reset_counts()
        from_host = model.endless_encode_tokens(host_read, C, LEFT, RIGHT, BUDGET)
        counts[tag] = read_counts()
        _, t_host = timed(model.endless_encode_tokens, host_read)
        host_bytes = model.bytes_uploaded
        n_seg = counts[tag]["chunk_attention_tc"] // n_layers
        require(counts[tag]["chunk_attention_tc"] == n_layers * n_seg and n_seg >= 3
                and counts[tag]["chunk_attention"] == 0 and counts[tag]["fbank_fft"] == 0,
                f"{tag} host-feature launches {counts[tag]}")
        same = (np.array_equal(on_card, want) and np.array_equal(from_host, want))
        log(f"{tag} long-form tokens from features on the card and from the host (kaldi ark "
            f"read back as numpy) equal endless_decode's: {same} ({want.size} frames)")
        require(same, f"{tag}: tokens differ between the ways in")

        q_card, s_card = quantize_int8_tensor(feats)
        q_host, s_host = quantize_int8(host_read)
        require(s_card == s_host and np.array_equal(q_card.cpu().numpy(), q_host),
                f"int8: the card's quantizer differs from the host library's "
                f"(scales {s_card} {s_host})")
        staged = torch.from_numpy(q_host if tag == "bf16" else host_read).pin_memory()
        dst = torch.empty(staged.shape, dtype=staged.dtype, device=device)
        copy_ms = cuda_ms(lambda: dst.copy_(staged, non_blocking=True), iters=5)
        want_bytes = host.shape[0] * host.shape[1] * (1 if tag == "bf16" else 4)
        require(host_bytes == want_bytes and card_bytes == 0,
                f"{tag}: uploaded {host_bytes} bytes from the host (want {want_bytes}), "
                f"{card_bytes} from card features (want 0)")
        log(f"{tag} upload: {host_bytes / 1e6:.1f} MB of "
            f"{'int8 (scale ' + format(s_host, '.6g') + ')' if tag == 'bf16' else 'f32'} "
            f"for {tuple(host.shape)} features (f32 would be {host.size * 4 / 1e6:.1f} MB); "
            f"host-to-device copy of them from pinned memory {copy_ms:.3f} ms "
            f"({host_bytes / copy_ms / 1e6:.1f} GB/s); fetching the features to the host "
            f"{1e3 * t_fetch:.1f} ms; card quantizer and host library: int8 and scale equal")
        def wall(ts):
            return (f"{ts[0]:.3f} s, {LONG_SECONDS / ts[0]:.1f} audio-s/s (median of "
                    f"{', '.join(f'{t:.3f}' for t in ts[1:])} s)")

        log(f"{tag} wall, {LONG_SECONDS:.0f} s: endless_decode (wav, features on the card) "
            f"{wall(t_decode)}; endless_encode_tokens from features on the card "
            f"{wall(t_card)}; from host features {wall(t_host)} (quantize, pin, copies "
            f"overlapped with compute); launches {counts[tag]}; card {card}")
        del model, feats, staged, dst
        torch.cuda.empty_cache()
    return counts


def phase_local_heads(card, device):
    """B4 and B5 of each training route on heads 4-7 of 8 alone with
    head_offset 4 (a tensor-parallel rank's share), at dropout 0.1: every
    output bit for bit heads 4-7 of the call on all 8 heads (bf16 and f32 on
    the tensor cores at the flagship train shape, f32 on the CUDA cores at
    c = 8, dk = 32); the plain version on the same heads within 1e-6 of its
    full call, its dropout masks equal."""
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    st = (77, C, LEFT, RIGHT, 0.1)
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    cases = [("tensor_core", torch.bfloat16, None), ("tensor_core", torch.float32, None),
             ("cuda_core", torch.float32, (3, 3, 8, 16, 8, 32))]
    for path, dtype, small in cases:
        if small is None:
            args = train_attention_inputs(dtype, gen, device)
            stt = st
        else:
            b, n, c, left, right, dk = small
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=device).to(dtype)

            args = [rnd(b, n * c, 8, dk), rnd(b, left + n * c + right, 8, 2 * dk),
                    rnd(2 * c - 1 + left + right, 8, dk), rnd(8, dk), rnd(8, dk),
                    torch.tensor([n * c - 3, n * c - 9, c + 2], dtype=torch.int32,
                                 device=device)]
            stt = (77, c, left, right, 0.1)
        ctx, m, den = cat.forward_kernel(*args, *stt, path=path)
        dctx = torch.randn(ctx.shape, generator=gen, device=device).to(dtype)
        full = cat.backward_kernel(*args, ctx, m, den, dctx, *stt, path=path)
        q, kv, p, u, v, lens = args
        loc = [t[..., 4:8, :].contiguous() for t in (q, kv, p)] + [
            u[4:8].contiguous(), v[4:8].contiguous(), lens]
        lctx, lm, lden = cat.forward_kernel(*loc, *stt, path=path, head_offset=4,
                                            heads_total=8)
        part = cat.backward_kernel(*loc, lctx, lm, lden, dctx[:, :, 4:8].contiguous(), *stt,
                                   path=path, head_offset=4, heads_total=8)
        torch.cuda.synchronize()
        same = [torch.equal(lctx, ctx[:, :, 4:8]), torch.equal(lm, m[:, 4:8]),
                torch.equal(lden, den[:, 4:8])]
        same += [torch.equal(a, e[..., 4:8, :]) for a, e in zip(part, full)]
        log(f"B4/B5 {path} {str(dtype).split('.')[-1]} on heads 4-7 with head_offset 4 vs heads "
            f"4-7 of the full call, dropout 0.1, B = {q.shape[0]}, c = {stt[1]}: ctx, m, den, "
            f"dq, dkv, dp, du, dv bitwise equal {same}")
        require(all(same), f"{path} {dtype}: the local-head call is not the full call's slice")
        if small is not None or dtype == torch.float32:
            pf = cat.forward_plain(*args, *stt)
            pl = cat.forward_plain(*loc, *stt, head_offset=4, heads_total=8)
            err = max(float((a.float() - e[..., 4:8, :].float() if a.dim() == 4
                             else a - e[:, 4:8]).abs().max()) for a, e in zip(pl, pf))
            n_keep = stt[1]
            keep = cat.window_keep_mask(77, lens, q.shape[1] // n_keep, 8, n_keep,
                                        stt[2] + n_keep + stt[3], 0.1)
            lkeep = cat.window_keep_mask(77, lens, q.shape[1] // n_keep, 4, n_keep,
                                         stt[2] + n_keep + stt[3], 0.1, 4, 8)
            log(f"plain version ({path} shape) on heads 4-7: within {err:.3g} of the full "
                f"call's slice (limit 1e-6), dropout masks equal "
                f"{torch.equal(lkeep, keep[:, :, 4:8])}")
            require(err <= 1e-6 and torch.equal(lkeep, keep[:, :, 4:8]),
                    f"plain version on local heads: {err}")
        del args, loc, full, part
    torch.cuda.empty_cache()
    log(f"local heads: card {card}")


def check_average_export(exp, config, root, name, card):
    """bin/average_model.py --num 2 over ``exp``'s epochs, export_model_dir of
    the average, which from_pretrained loads bitwise, and a 120 s f32
    endless_decode of it equal to the in-memory average's. Returns the
    decode's launch counts."""
    from chunkformer_tpu_torch.api import ChunkFormerModel, read_symbol_table
    from chunkformer_tpu_torch.bin import average_model
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.export import export_model_dir
    from chunkformer_tpu_torch.train.checkpoint import load_checkpoint

    require(average_model.main(["--src_path", exp, "--num", "2"]) == 0, "average_model failed")
    avg = load_checkpoint(exp, "avg")[0]
    e0, e1 = load_checkpoint(exp, "epoch_0")[0], load_checkpoint(exp, "epoch_1")[0]
    k = "encoder.encoders.0.self_attn.linear_q.weight"
    require(torch.equal(avg[k], ((e0[k].double() + e1[k].double()) / 2).float()),
            "the average is not the mean of epoch_0 and epoch_1")
    del e0, e1

    with open(os.path.join(exp, "train.yaml")) as f:
        import yaml

        raw = yaml.safe_load(f)
    table = read_symbol_table(config["tokenizer_conf"]["symbol_table_path"])
    out = export_model_dir(os.path.join(root, name), raw, avg, table)
    device = torch.device("cuda")
    served = ChunkFormerModel.from_pretrained(out, dtype=torch.float32, device=device)
    got = served.model.state_dict()
    require(got.keys() == avg.keys() and all(torch.equal(got[k].cpu(), avg[k]) for k in avg),
            "from_pretrained of the export is not bitwise the averaged checkpoint")
    memory = ChunkFormerModel(ChunkFormerConfig.from_dict(raw), avg, None, torch.float32,
                              device)
    served.char_dict = None
    wav = write_wav(os.path.join(root, "decode.wav"),
                    speechlike(np.random.default_rng(SEED + 43), CLI_DECODE_SECONDS))
    kw = dict(chunk_size=C, left_context_size=LEFT, right_context_size=RIGHT,
              total_batch_duration=BUDGET)
    reset_counts()
    tokens = served.endless_decode(wav, **kw)
    decode_counts = read_counts()
    want = memory.endless_decode(wav, **kw)
    require(len(tokens) > 0 and np.array_equal(np.asarray(tokens), np.asarray(want)),
            "the export's tokens differ from the in-memory average's")
    require(decode_counts["chunk_attention_tc"] > 0 and decode_counts["fbank_fft"] > 0
            and decode_counts["chunk_attention"] == 0 and decode_counts["fbank"] == 0,
            f"export decode launches {decode_counts}")
    log(f"export of {os.path.basename(exp)}'s average (bin/average_model.py --num 2): "
        f"from_pretrained bitwise equal "
        f"to the checkpoint; {CLI_DECODE_SECONDS:.0f} s f32 endless_decode at ({C}, {LEFT}, {RIGHT}): "
        f"{len(tokens)} frame tokens ({len(set(np.asarray(tokens).tolist()))} distinct), "
        f"equal to the in-memory average's; launches {decode_counts}; card {card}")
    del served, memory, avg
    torch.cuda.empty_cache()
    return decode_counts


# ---- since PR 16: the CTC recipe twin on the card, the data-parallel
# statistics at world size 1, and the app twins
REPO = os.path.dirname(os.path.abspath(__file__))
RECIPE = os.path.join(REPO, "examples", "asr", "ctc", "run_torch.sh")
RECIPE_CONF = os.path.join(REPO, "examples", "asr", "ctc", "conf", "chunkformer-ctc-small.yaml")
# the recipe's cuts: two epochs (stage 4 averages both), every step logged
# (each step's drawn chunk in stage 3's log)
RECIPE_CUTS = {"max_epoch": 2, "log_interval": 1}
RECIPE_STAGES = ("tsv -> data lists", "global CMVN", "vocabulary", "train", "average",
                 "export", "recognize")
APP_MODULES = ("config", "utils", "transcription", "ui_components", "audio_processing", "app",
               "stream_asr", "audio_capture")


def phase_recipe(tmp, card, device="cuda"):
    """``examples/asr/ctc/run_torch.sh`` at its defaults (``device`` cuda)
    with its own ``conf/chunkformer-ctc-small.yaml`` (256 d, 12 blocks, 3 +
    3 decoder, accum_grad 4, dynamic chunks) cut by RECIPE_CUTS, avg_num=2,
    on the train CLI's synthetic WAVs (``write_train_data``) as its
    train.tsv; one stage a call, each stage's wall and exit code; stage 3's
    kernel launch counts (its last log line) against the train CLI's rule
    for its steps: B4 and B5 on the tensor cores once a layer a
    micro-batch whose drawn chunk is above 0, no other training attention
    and no decode kernel (the features come from the host); stage 6's
    ctc_greedy_search file equal to ``bin/recognize.py`` run in-process on
    the same export and list. Returns stage 3's launch counts."""
    import re

    import yaml

    from chunkformer_tpu_torch.bin import recognize

    if device == "cuda":  # the recipe's processes need the card's memory
        torch.cuda.empty_cache()
    root = os.path.join(tmp, "recipe")
    os.makedirs(os.path.join(root, "data"))
    os.makedirs(os.path.join(root, "bin"))
    write_train_data(root)
    with open(os.path.join(root, "train.list"), encoding="utf-8") as f:
        rows = [line for line in f if line.strip()]
    with open(os.path.join(root, "train.tsv"), "w", encoding="utf-8") as f:
        f.writelines(["key\twav\ttxt\n"] + rows)
    with open(RECIPE_CONF) as f:
        conf = {**yaml.safe_load(f), **RECIPE_CUTS}
    conf_path = os.path.join(root, "conf.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    # the recipe calls `python`: this interpreter
    python = os.path.join(root, "bin", "python")
    with open(python, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(python, 0o755)
    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    env = {**os.environ, "PATH": os.path.join(root, "bin") + os.pathsep + os.environ["PATH"],
           "PYTHONPATH": REPO, "data": data, "exp": exp, "config": conf_path,
           "train_tsv": os.path.join(root, "train.tsv"), "avg_num": "2"}
    if device != "cuda":
        env["device"] = device
    walls, logs = [], []
    for stage, what in enumerate(RECIPE_STAGES):
        t0 = time.time()
        out = subprocess.run(["bash", RECIPE], env={**env, "stage": str(stage),
                                                    "stop_stage": str(stage)},
                             capture_output=True, text=True, timeout=600)
        walls.append(time.time() - t0)
        logs.append(out.stdout + out.stderr)
        require(out.returncode == 0 and f"stage {stage}:" in out.stdout,
                f"recipe stage {stage} ({what}) exited {out.returncode}: {logs[-1][-3000:]}")
    log("recipe examples/asr/ctc/run_torch.sh (device " + device + ", avg_num=2, "
        + ", ".join(f"{k} {v}" for k, v in RECIPE_CUTS.items()) + ") on "
        f"{len(rows)} synthetic WAVs: " + "; ".join(
            f"stage {i} ({what}) {w:.1f} s" for i, (what, w) in enumerate(zip(RECIPE_STAGES,
                                                                               walls)))
        + f"; all {sum(walls):.1f} s, every exit code 0; card {card}")

    # stage 3: its drawn chunks, one a step, and its kernels' launch counts
    chunks = [int(c) for c in re.findall(r"step \d+ chunk=\((-?\d+), -?\d+, -?\d+\)", logs[3])]
    found = re.findall(r"kernel launches: (\{.*\})", logs[3])
    require(len(chunks) > 0 and len(found) == 1, f"recipe stage 3: {len(chunks)} step lines, "
            f"{len(found)} launch lines")
    counts = json.loads(found[0])
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [json.loads(x) for x in f if '"train"' in x]
    n_layers, accum = conf["encoder_conf"]["num_blocks"], conf["accum_grad"]
    limited = accum * n_layers * sum(c > 0 for c in chunks)
    want = {"chunk_attention": 0, "chunk_attention_tc": 0, "train_fwd": 0, "train_bwd": 0,
            "train_fwd_tc": limited, "train_bwd_tc": limited, "fbank": 0, "fbank_fft": 0,
            "fbank_fft_block": 0}
    losses = ", ".join(f"{s['loss']:.4g}" for s in steps)
    log(f"recipe stage 3: {len(steps)} steps (accum_grad {accum}) at chunks {chunks}, "
        f"losses {losses}; launches {counts}")
    if device == "cuda":
        require(counts == want, f"recipe stage 3 launches {counts}, expected {want}")
    require(len(steps) == len(chunks) and all(np.isfinite(s["loss"]) for s in steps),
            f"recipe stage 3 metrics {steps}")
    require(os.path.exists(os.path.join(exp, "avg_2.pt")) and "exported avg_2" in logs[5],
            "recipe stages 4-5 did not export avg_2")

    # stage 6 against bin/recognize.py in this process on the same export
    mine = os.path.join(root, "recognize")
    require(recognize.main(["--model_checkpoint", os.path.join(exp, "export"), "--test_data",
                            os.path.join(data, "internal_test.list"), "--modes",
                            "ctc_greedy_search", "--result_dir", mine,
                            "--device", device]) == 0, "in-process recognize failed")
    with open(os.path.join(exp, "results", "ctc_greedy_search.txt"), "rb") as f:
        got = f.read()
    with open(os.path.join(mine, "ctc_greedy_search.txt"), "rb") as f:
        want_text = f.read()
    n_lines = len(got.decode("utf-8").splitlines())
    log(f"recipe stage 6: ctc_greedy_search on {n_lines} test files equal to bin/recognize.py "
        f"in-process on the same export: {got == want_text}")
    require(n_lines > 0 and got == want_text, "recipe stage 6's ctc_greedy_search file differs "
            "from bin/recognize.py's")
    return counts


def phase_data_parallel_one(card, device):
    """One f32 step of the flagship train model with a batch-norm conv
    module and the length-normalized attention loss (dropout 0) under
    ``dp`` at world size 1 on NCCL (``Parallel``: DDP), its modules given
    the world's group as their data group (``set_data_group``), against the
    same step of the same model with no group: a group of one takes the
    single-process statistics (``data_group.active`` is false), so the
    parameters are within 1e-6 and ``acc_att`` equal. Returns the grouped
    step's training-attention launch counts."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.parallel.data_group import active, set_data_group
    from chunkformer_tpu_torch.parallel.mesh import Parallel, init_distributed
    from chunkformer_tpu_torch.train.losses import asr_model_loss
    from chunkformer_tpu_torch.train.optim import build_optimizer
    from chunkformer_tpu_torch.train.train_step import make_train_step

    plain = no_dropout(TRAIN)
    cfg_dict = {**plain, "encoder_conf": {**plain["encoder_conf"], "cnn_module_norm": "batch_norm"},
                "model_conf": {**plain["model_conf"], "length_normalized_loss": True}}
    cfg = ChunkFormerConfig.from_dict(cfg_dict)
    batch = train_batch(cfg, device, SEED + 61)
    backend = "nccl" if device.type == "cuda" else "gloo"
    runs = {}
    for grouped in (False, True):
        model = init_random_(ASRModel(cfg), torch.Generator().manual_seed(SEED)).to(device)
        opt, sched = build_optimizer(list(model.parameters()), "adamw", {"lr": 1e-3},
                                     "warmuplr", {"warmup_steps": 25000})
        kw = dict(chunk_cfg=(C, LEFT, RIGHT), grad_clip=GRAD_CLIP)
        with world_of_one() if grouped else contextlib.nullcontext():
            if grouped:
                dp = init_distributed(device, "dp")
                par = Parallel(model, cfg, asr_model_loss, dp)
                set_data_group(model, dist.group.WORLD)
                groups = [m.data_group for m in model.modules() if hasattr(m, "data_group")]
                require(dist.get_backend() == backend and len(groups) == 1 + cfg.encoder_conf
                        .num_blocks and all(g is dist.group.WORLD for g in groups)
                        and not active(groups[0]), f"data groups {len(groups)}")
                kw.update(loss_fn=par.loss_fn, no_sync=par.no_sync,
                          reduce_grads=par.reduce_grads, grad_norm=par.grad_norm)
            step = make_train_step(model, cfg, opt, sched, **kw)
            reset_train_counts()
            t0 = time.time()
            metrics = {k: float(v) for k, v in step(*batch).items()}
            runs[grouped] = (metrics, [p.detach().clone() for p in model.parameters()],
                             read_train_counts(), time.time() - t0)
        del model, opt, step
    (m0, p0, _, t_plain), (m1, p1, counts, t_grouped) = runs[False], runs[True]
    err = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
    log(f"batch-norm, length-normalized step under dp at world size 1 ({backend}, DDP, the "
        f"world group as data group) vs no group: parameters within {err:.3g} (limit 1e-6), "
        f"acc_att {m1['acc_att']:.6g} vs {m0['acc_att']:.6g}, loss {m1['loss']:.6g} vs "
        f"{m0['loss']:.6g}, loss_att {m1['loss_att']:.6g} vs {m0['loss_att']:.6g}; "
        f"{1e3 * t_grouped:.1f} / {1e3 * t_plain:.1f} ms (first step of each); launches "
        f"{counts}; card {card}")
    n_layers = cfg.encoder_conf.num_blocks
    recompute = 2 if cfg.encoder_conf.remat_policy == "nothing" else 1
    require(err <= 1e-6 and m1["acc_att"] == m0["acc_att"] and np.isfinite(m1["loss"]),
            f"dp at world size 1 differs from the plain step: parameters {err}, acc_att "
            f"{m1['acc_att']} vs {m0['acc_att']}")
    require(device.type != "cuda" or counts == {
        "fwd": 0, "bwd": 0, "fwd_tc": n_layers * recompute, "bwd_tc": n_layers},
        f"dp step launches {counts}")
    return counts


def phase_sharded_decode(card, device):
    """Masked-batch decode with the chunk rows split over a process group
    (``parallel/row_shard.py``) at world size 1 on NCCL (gloo on the CPU), in
    the smoke's own process: ChunkFormer-large (random weights from
    ``random_params_like``) at (64, 128, 128) on a middle macro-segment of
    the 1800 s budget (``endless_sizing``: 209 rows, trunc > 0; the caches
    from the segment before it), in bf16 and f32. ``parallel_chunk(group=g)``
    with the gathered CTC tokens must equal ``group=None`` bit for bit
    (tokens, outputs, both new caches): at one process the halo exchange
    copies the rank's own slab. Each sharded call launches the routed
    tensor-core B1 once a layer and no CUDA-core B1. Prints both walls
    (median of three calls after a warm-up). Returns the launch counts of
    the sharded calls by dtype. The group is destroyed before returning."""
    import torch.distributed as dist

    from chunkformer_tpu_torch.api import endless_sizing
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel
    from chunkformer_tpu_torch.ops import chunk as chunk_ops
    from chunkformer_tpu_torch.parallel.mesh import init_distributed
    from chunkformer_tpu_torch.utils.params import random_params_like

    cfg = ChunkFormerConfig.from_dict(LARGE)
    enc = cfg.encoder_conf
    n_layers = enc.num_blocks
    trunc, _, step_raw, seg_raw, capacity = endless_sizing(enc, C, RIGHT, BUDGET)
    span = (capacity - 1) * enc.subsampling_rate * C + (C - 1) * enc.subsampling_rate + 15
    gen = torch.Generator().manual_seed(SEED + 71)
    feats = torch.randn(step_raw + span, 80, generator=gen).to(device)
    max_len = 1 + (seg_raw - 15) // enc.subsampling_rate

    def meta(value):
        return torch.full((capacity,), value, dtype=torch.int32, device=device)

    chunk_idx = torch.arange(capacity, dtype=torch.int32, device=device)
    base = random_params_like(ASRModel(cfg))
    counts = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with world_of_one():
        init_distributed(device, "dp")
        group = dist.group.WORLD
        backend = dist.get_backend(group)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            model = ASRModel(cfg).to(device=device, dtype=dtype).eval()
            model.load_state_dict(base.state_dict())
            with torch.inference_mode():
                att, cnn = model.encoder.init_caches(LEFT, dtype, device)
                xs = chunk_ops.device_pack_segment(feats, 0, C, capacity=capacity).to(dtype)
                _, att, cnn = model.encoder.parallel_chunk(
                    xs, chunk_idx, meta(0), meta(max_len), C, LEFT, RIGHT, att, cnn, trunc)
                xs = chunk_ops.device_pack_segment(feats, step_raw, C, capacity=capacity)
                args = (xs.to(dtype), chunk_idx, meta(trunc), meta(max_len), C, LEFT, RIGHT,
                        att, cnn, trunc)

                def plain():
                    out, a, k = model.encoder.parallel_chunk(*args)
                    return model.ctc.argmax(out), out, a, k

                def sharded():
                    out, a, k = model.encoder.parallel_chunk(*args, group=group)
                    return model.ctc.gathered_argmax(out, group), out, a, k

                walls = {}
                for name, fn in (("group=None", plain), ("group", sharded)):
                    fn()
                    sync()
                    times = []
                    for _ in range(3):
                        reset_counts()
                        t0 = time.time()
                        result = fn()
                        sync()
                        times.append(time.time() - t0)
                    walls[name] = (sorted(times)[1], result, read_counts())
            (t_plain, want, _), (t_sharded, got, launches) = walls["group=None"], walls["group"]
            equal = {name: torch.equal(g, w) for name, g, w in zip(
                ("tokens", "outputs", "attention cache", "conv cache"), got, want)}
            log(f"sharded decode {tag}, world size 1 ({backend}), {capacity} rows, trunc "
                f"{trunc}: group vs group=None bitwise {equal}; wall {1e3 * t_sharded:.2f} ms "
                f"vs {1e3 * t_plain:.2f} ms (median of 3); launches {launches}; card {card}")
            require(all(equal.values()),
                    f"sharded decode {tag} differs from group=None: {equal}")
            require(device.type != "cuda" or (launches["chunk_attention_tc"] == n_layers
                                              and launches["chunk_attention"] == 0),
                    f"sharded decode {tag} launches {launches}")
            counts[tag] = launches
            del model
    require(not dist.is_initialized(), "the sharded decode's process group is still up")
    return counts


TOOL_RUNS = (  # (tool, its smallest arguments at full width), each with --json
    ("ablate_torch_step.py", ["--iters", "1"]),
    ("ablate_torch_train_step.py", ["full", "--steps", "1"]),
    ("bench_torch_endless_breakdown.py", ["--trials", "1", "--seconds", "300"]),
    ("bench_torch_pipeline.py", ["--n", "16", "--seconds", "2"]),
    ("bench_torch_scaling.py", ["--iters", "1", "--minutes", "1"]),
)


def phase_tools(tmp, card):
    """The five measurement-tool twins as subprocesses of this interpreter at
    their smallest arguments, ``bench_torch_scaling.py`` under torchrun with
    one process: each exits 0 and writes parseable JSON naming the card.
    Prints each one's wall and its JSON."""
    import socket

    for tool, argv in TOOL_RUNS:
        out = os.path.join(tmp, tool.replace(".py", ".json"))
        cmd = [os.path.join(REPO, "tools", tool), *argv, "--json", out]
        if tool == "bench_torch_scaling.py":
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            cmd = ["-m", "torch.distributed.run", "--nproc_per_node", "1",
                   "--master_addr", "localhost", "--master_port", str(port), *cmd]
        t0 = time.time()
        run = subprocess.run([sys.executable, *cmd], capture_output=True, text=True,
                             timeout=600, cwd=REPO)
        wall = time.time() - t0
        require(run.returncode == 0, f"{tool} exited {run.returncode}: "
                f"{run.stdout[-2000:]}{run.stderr[-3000:]}")
        with open(out) as f:
            result = json.load(f)
        require(result.get("device") == card, f"{tool} ran on {result.get('device')}")
        log(f"{tool} {' '.join(argv)}: exit 0 in {wall:.1f} s; {json.dumps(result)}")


def phase_bench(card):
    """``bench_torch.py`` at its defaults as a subprocess of this
    interpreter: exit 0; three stdout lines, each JSON extending the one
    before; mfu and train_mfu in (0, 1]; a finite train_loss; the launch
    counts it prints on stderr a stage: the bf16 tensor-core B1 only, 34 a
    decode call (17 blocks, two macro-segments), in stages 1 and 2, the
    bf16 tensor-core B4 and B5 only, 17 each a step, in stage 3. Prints the
    three lines; returns the launches by counter name."""
    from bench_torch import DECODE, DEVICE_SEGMENTS, LAUNCHES, TRAIN

    t0 = time.time()
    run = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                         capture_output=True, text=True, timeout=600, cwd=REPO)
    wall = time.time() - t0
    require(run.returncode == 0, f"bench_torch.py exited {run.returncode}: "
            f"{run.stdout[-2000:]}{run.stderr[-3000:]}")
    try:
        lines = [json.loads(line) for line in run.stdout.splitlines()]
        stages = {s["stage"]: s for s in (json.loads(line.split(LAUNCHES, 1)[1])
                                          for line in run.stderr.splitlines()
                                          if LAUNCHES in line)}
    except (json.JSONDecodeError, KeyError) as e:
        raise PhaseFailed(f"bench_torch.py printed malformed lines ({e}): {run.stdout[-2000:]}")
    for line in lines:
        log(f"bench_torch.py: {json.dumps(line)}")
    require(len(lines) == 3, f"bench_torch.py printed {len(lines)} lines, not 3")
    for before, after in zip(lines, lines[1:]):
        require(len(after) > len(before) and all(after.get(k) == v for k, v in before.items()),
                f"{after} does not extend {before}")
    last = lines[-1]
    require(0 < last["mfu"] <= 1 and 0 < last["train_mfu"] <= 1,
            f"mfu {last['mfu']}, train_mfu {last['train_mfu']} not in (0, 1]")
    require(bool(np.isfinite(last["train_loss"])), f"train_loss {last['train_loss']}")
    require(last["device_kind"] == torch.cuda.get_device_name(0),
            f"bench_torch.py ran on {last['device_kind']}")
    decode_blocks = DECODE["encoder_conf"]["num_blocks"]
    train_blocks = TRAIN["encoder_conf"]["num_blocks"]
    want = {"e2e": {"chunk_attention_tc": 2 * decode_blocks},  # two macro-segments a call
            "device": {"chunk_attention_tc": DEVICE_SEGMENTS * decode_blocks},
            "train": {"train_fwd_tc": train_blocks, "train_bwd_tc": train_blocks}}
    require(sorted(stages) == sorted(want), f"bench_torch.py stage launches {stages}")
    for name, per_call in want.items():
        calls = stages[name]["calls"]
        require(stages[name]["counts"] == {k: v * calls for k, v in per_call.items()},
                f"bench_torch.py {name} launches {stages[name]}, expected {per_call} a call")
    log(f"bench_torch.py: exit 0 in {wall:.1f} s; launches "
        f"{json.dumps({k: v for k, v in stages.items()})}; card {card}")
    return {"chunk_attention_tc": sum(stages[k]["counts"]["chunk_attention_tc"]
                                      for k in ("e2e", "device")),
            "fwd_tc": stages["train"]["counts"]["train_fwd_tc"],
            "bwd_tc": stages["train"]["counts"]["train_bwd_tc"]}


@contextlib.contextmanager
def app_modules(name):
    """``apps/<name>`` first on sys.path, with none of the apps' module
    names loaded from elsewhere; yields an importer."""
    import importlib

    path = os.path.join(REPO, "apps", name)
    for n in APP_MODULES:
        sys.modules.pop(n, None)
    sys.path.insert(0, path)
    try:
        yield importlib.import_module
    finally:
        sys.path.remove(path)


def write_main_export(tmp, cfg, sd):
    """The main path's model (its random weights and CMVN) as an export
    directory with its vocabulary."""
    from chunkformer_tpu_torch.export import export_model_dir

    return export_model_dir(os.path.join(tmp, "main_export"), LARGE, sd,
                            {sym: i for i, sym in main_vocabulary(cfg.vocab_size).items()})


def phase_apps(tmp, card, device, main_export, long_wav):
    """The app twins at ChunkFormer-large width: ``apps/realtime-asr-torch``'s
    ``RealtimeASR.run`` on the streaming phase's 60 s file and export at
    speed 0, f32, (6, 50, 0), its transcript equal to ``bin/stream.py``'s
    on that file (``run_stream``), one FFT fbank launch a step and no
    attention kernel; ``apps/streamlit_torch``'s
    ``transcription.transcribe_audio`` of the 2040 s decode file through its
    ``load_model(dir, "cuda")`` at the app's defaults (64, 128, 128, 1800 s
    budget, 0.5 s silence), its segments equal to ``endless_decode``'s of
    the same export. Returns the launch counts of both."""
    from chunkformer_tpu_torch.api import ChunkFormerModel

    model_dir, wav = os.path.join(tmp, "stream_export"), os.path.join(tmp, "stream.wav")
    c, left, right = STREAM_CTX
    with app_modules("realtime-asr-torch") as load:
        stream_asr = load("stream_asr")
        asr = stream_asr.RealtimeASR(ChunkFormerModel.from_pretrained(
            model_dir, dtype=torch.float32, device=device), c, left, right)
        reset_counts()
        t0 = time.time()
        text = asr.run(wav, speed=0.0)
        t_app = time.time() - t0
        app_counts = read_counts()
    want, t_cli, final, _ = run_stream(model_dir, wav, "fp32")
    steps = len(asr.step_seconds)
    log(f"apps/realtime-asr-torch RealtimeASR.run on {STREAM_SECONDS:.0f} s at speed 0 "
        f"(f32, {STREAM_CTX}): {t_app:.2f} s, {steps} steps, RTF {t_app / STREAM_SECONDS:.4f}, "
        f"{len(text)} characters; bin/stream.py on the same file {t_cli:.2f} s (model load "
        f"included); transcripts equal: {text == want.text()}; launches {app_counts}; "
        f"card {card}")
    require(len(text) > 0 and text == want.text() and final.endswith(text),
            "RealtimeASR.run's transcript differs from bin/stream.py's")
    if device.type == "cuda":
        require(app_counts == {"chunk_attention": 0, "chunk_attention_tc": 0, "fbank": 0,
                               "fbank_fft": steps}, f"RealtimeASR launches {app_counts}")

    kw = dict(chunk_size=64, left_context_size=128, right_context_size=128,
              total_batch_duration=1800, max_silence_duration=0.5)
    with app_modules("streamlit_torch") as load:
        transcription = load("transcription")
        t0 = time.time()
        model = transcription.load_model(main_export, device.type)
        t_load = time.time() - t0
        reset_counts()
        segments, info = transcription.transcribe_audio(model, long_wav, **kw)
        transcribe_counts = read_counts()
        require(transcription.load_model(main_export, device.type) is model,
                "load_model does not cache")
        del model
    reference = ChunkFormerModel.from_pretrained(main_export, dtype=torch.float32, device=device)
    want_segments = reference.endless_decode(long_wav, return_timestamps=True, **kw)
    del reference
    torch.cuda.empty_cache()
    log(f"apps/streamlit_torch transcribe_audio of {LONG_SECONDS:.0f} s (f32, (64, 128, 128), "
        f"budget 1800 s): load_model {t_load:.2f} s, decode {info['elapsed_s']:.3f} s "
        f"({LONG_SECONDS / info['elapsed_s']:.1f} audio-s/s), {info['segments']} segments, "
        f"{info['words']} words; equal to endless_decode's segments: "
        f"{segments == want_segments}; launches {transcribe_counts}; card {card}")
    require(len(segments) > 0 and segments == want_segments,
            "transcribe_audio's segments differ from endless_decode's")
    require(device.type != "cuda" or (
        transcribe_counts["chunk_attention_tc"] > 0 and transcribe_counts["fbank_fft"] > 0
        and transcribe_counts["chunk_attention"] == 0 and transcribe_counts["fbank"] == 0),
        f"transcribe_audio launches {transcribe_counts}")
    return app_counts, transcribe_counts


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
        launches, f32_launches, capacity, main_model = phase_main_path(tmp, card,
                                                                       torch.device("cuda"))
        log(f"[phase main path] {time.time() - t:.1f} s")

        t = time.time()
        upload_launches = phase_upload(card, torch.device("cuda"), *main_model)
        main_export = write_main_export(tmp, main_model[0], main_model[1])
        long_wav = main_model[2]
        del main_model
        log(f"[phase host-feature upload] {time.time() - t:.1f} s")

        t = time.time()
        train_results = phase_train_kernels(torch.device("cuda"))
        log(f"[phase train kernels] {time.time() - t:.1f} s")

        t = time.time()
        phase_local_heads(card, torch.device("cuda"))
        log(f"[phase kernels on local heads] {time.time() - t:.1f} s")

        t = time.time()
        train_launches, f32_train_launches, _, _ = phase_train(card, torch.device("cuda"))
        log(f"[phase train path] {time.time() - t:.1f} s")

        t = time.time()
        search_launches, b4_eval, search_f32, search = phase_search(tmp, card,
                                                                    torch.device("cuda"))
        log(f"[phase search path] {time.time() - t:.1f} s")

        t = time.time()
        other, c96_launches = phase_other_geometries(card, torch.device("cuda"), search_f32,
                                                     search[2])
        del search_f32
        torch.cuda.empty_cache()
        log(f"[phase other geometries] {time.time() - t:.1f} s")

        t = time.time()
        stream_launches, stream_fbank = phase_streaming(tmp, card, torch.device("cuda"), search)
        log(f"[phase streaming path] {time.time() - t:.1f} s")

        t = time.time()
        classify_launches, b4_classify = phase_classification(tmp, card, torch.device("cuda"),
                                                              search)
        log(f"[phase classification path] {time.time() - t:.1f} s")

        t = time.time()
        rnnt_launches, rnnt = phase_transducer(tmp, card, torch.device("cuda"), search)
        log(f"[phase transducer path] {time.time() - t:.1f} s")

        t = time.time()
        cli_train, cli_decode, sharded_train, sharded_decode = phase_train_cli(tmp, card)
        log(f"[phase train CLI] {time.time() - t:.1f} s")

        t = time.time()
        recipe_train = phase_recipe(tmp, card)
        log(f"[phase recipe] {time.time() - t:.1f} s")

        t = time.time()
        dp_one = phase_data_parallel_one(card, torch.device("cuda"))
        log(f"[phase data-parallel statistics at world size 1] {time.time() - t:.1f} s")

        t = time.time()
        app_launches, transcribe_launches = phase_apps(tmp, card, torch.device("cuda"),
                                                       main_export, long_wav)
        log(f"[phase apps] {time.time() - t:.1f} s")

        t = time.time()
        sharded_launches = phase_sharded_decode(card, torch.device("cuda"))
        log(f"[phase sharded decode at world size 1] {time.time() - t:.1f} s")

        t = time.time()
        phase_tools(tmp, card)
        log(f"[phase measurement tools] {time.time() - t:.1f} s")

        t = time.time()
        torch.cuda.empty_cache()
        bench_launches = phase_bench(card)
        log(f"[phase bench] {time.time() - t:.1f} s")
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {"name": "chunk_attention_tc", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": launches["chunk_attention_tc"], **results["attention bf16 tensor cores"],
         "library_ms": None},
        {"name": "chunk_attention_tc_f32", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": f32_launches["chunk_attention_tc"], **results["attention f32 tensor cores"],
         "library_ms": None},
        {"name": "chunk_attention", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": f32_launches["chunk_attention"], **results["attention f32"],
         "library_ms": None},
        {"name": "fbank_fft", "route": "cuda", "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": launches["fbank_fft"], **results["fbank_fft"], "library_ms": None},
        {"name": "fbank", "route": "cuda", "source": "chunkformer_tpu_torch/csrc/fbank.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": launches["fbank"], **results["fbank"], "library_ms": None},
        {"name": "chunk_train_attention_tc_fwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": train_launches["fwd_tc"],
         **train_results["train attention bf16 p=0.0"]["tensor_core"]["fwd"],
         "library_ms": None},
        {"name": "chunk_train_attention_tc_bwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:390",
         "launches": train_launches["bwd_tc"],
         **train_results["train attention bf16 p=0.0"]["tensor_core"]["bwd"],
         "library_ms": None},
        {"name": "chunk_train_attention_tc_f32_fwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": f32_train_launches["fwd_tc"],
         **train_results["train attention f32 p=0.0"]["tensor_core"]["fwd"],
         "library_ms": None},
        {"name": "chunk_train_attention_tc_f32_bwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:390",
         "launches": f32_train_launches["bwd_tc"],
         **train_results["train attention f32 p=0.0"]["tensor_core"]["bwd"],
         "library_ms": None},
        {"name": "chunk_train_attention_f32_fwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": f32_train_launches["fwd"],
         **train_results["train attention f32 p=0.0"]["cuda_core"]["fwd"], "library_ms": None},
        {"name": "chunk_train_attention_f32_bwd", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:390",
         "launches": f32_train_launches["bwd"],
         **train_results["train attention f32 p=0.0"]["cuda_core"]["bwd"], "library_ms": None},
        {"name": "chunk_train_attention_tc_fwd_eval", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": search_launches["bf16"]["fwd_tc"], **b4_eval["bf16"], "library_ms": None},
        {"name": "chunk_train_attention_tc_f32_fwd_eval", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": search_launches["fp32"]["fwd_tc"], **b4_eval["fp32"], "library_ms": None},
        {"name": "chunk_attention_c96", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": c96_launches["decode"]["chunk_attention_tc"],
         **other[(96, 64)]["f32"]["tc"],
         "library_ms": None},
        {"name": "chunk_attention_c96_bf16", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": 0, **other[(96, 64)]["bf16"]["tc"], "library_ms": None},
        {"name": "chunk_attention_c96_cuda_core", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": c96_launches["decode"]["chunk_attention"], **other[(96, 64)]["f32"]["cc"],
         "library_ms": None},
        {"name": "fbank_fft_stream", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": stream_launches, **stream_fbank, "library_ms": None},
        {"name": "chunk_train_attention_tc_fwd_classify", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": classify_launches["bf16"], **b4_classify["bf16"], "library_ms": None},
        {"name": "chunk_train_attention_tc_f32_fwd_classify", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
         "launches": classify_launches["f32"], **b4_classify["f32"], "library_ms": None},
    ]
    for tag, suffix in (("bf16", ""), ("f32", "_f32")):
        cu = f"chunkformer_tpu_torch/csrc/chunk_attention{{}}_tc{suffix}.cu"
        kernels += [
            {"name": f"chunk_attention_tc{suffix}_rnnt", "route": "cuda", "source": cu.format(""),
             "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
             "launches": sum(rnnt_launches[f"{p} {tag}"]["chunk_attention_tc"]
                             for p in ("endless", "batch")),
             **rnnt[f"B1 {tag}"], "library_ms": None},
            {"name": f"chunk_train_attention_tc{suffix}_fwd_eval_rnnt", "route": "cuda",
             "source": cu.format("_train"),
             "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
             "launches": rnnt_launches[f"recognize {'fp32' if tag == 'f32' else tag}"]["fwd_tc"],
             **rnnt[f"B4 eval {tag}"], "library_ms": None}]
        for part, line in (("fwd", 316), ("bwd", 390)):
            kernels.append(
                {"name": f"chunk_train_attention_tc{suffix}_{part}_rnnt", "route": "cuda",
                 "source": cu.format("_train"),
                 "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
                 "launches": rnnt_launches[f"train {tag}"][f"{part}_tc"],
                 **rnnt[f"train {tag}"][part], "library_ms": None})
    for tag, geometry in (("odd_shift", "50 ms / 161"), ("long_shift", "25 ms / 40 ms shift"),
                          ("2048", "25 ms at 44.1 kHz (2048 points)")):
        fb_other = other["fbank"][geometry]
        kernels.append({"name": f"fbank_fft_{tag}", "route": "cuda",
                        "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
                        "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
                        "launches": fb_other["launches"]["fbank_fft"], **fb_other["fft"],
                        "library_ms": None})
    for tag, geometry in (("160_bins", "160 bins at 25 ms / 16 kHz"),
                          ("128", "15 ms at 8 kHz (128 points)"),
                          ("4096", "25 ms at 96 kHz (4096 points)")):
        fb_other = other["fbank"][geometry]
        kernels.append({"name": f"fbank_fft_{tag}", "route": "cuda",
                        "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
                        "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
                        "launches": fb_other["launches"]["fbank_fft"], **fb_other["fft"],
                        "library_ms": None})
    for tag, geometry in (("8192", "50 ms at 96 kHz (8192 points)"),
                          ("16384", "100 ms at 96 kHz (16384 points)"),
                          ("32768", "100 ms at 192 kHz (32768 points)")):
        fb_other = other["fbank"][geometry]
        kernels.append({"name": f"fbank_fft_block_{tag}", "route": "cuda",
                        "source": "chunkformer_tpu_torch/csrc/fbank_fft_block.cu",
                        "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
                        "launches": fb_other["launches"]["fbank_fft_block"], **fb_other["fft"],
                        "library_ms": None})
    train96 = other[("train",) + C7_DECODE[0]]
    for tag, suffix, step in (("f32", "_f32", "train f32"), ("bf16", "", "train bf16")):
        for part, line in (("fwd", 316), ("bwd", 390)):
            kernels.append(
                {"name": f"chunk_train_attention_tc{suffix}_{part}_c96", "route": "cuda",
                 "source": f"chunkformer_tpu_torch/csrc/chunk_attention_train_tc{suffix}.cu",
                 "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
                 "launches": c96_launches[step][f"{part}_tc"], **train96[tag]["tc"][part],
                 "library_ms": None})
            if tag == "f32":
                kernels.append(
                    {"name": f"chunk_train_attention_f32_{part}_c96", "route": "cuda",
                     "source": "chunkformer_tpu_torch/csrc/chunk_attention_train.cu",
                     "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
                     "launches": c96_launches[step][part], **train96[tag]["cc"][part],
                     "library_ms": None})
    kernels.append({"name": "chunk_train_attention_tc_f32_fwd_eval_c96", "route": "cuda",
                    "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
                    "replaces": "chunkformer_tpu/ops/pallas/chunk_attention_train.py:316",
                    "launches": c96_launches["encode"]["fwd_tc"], **other["encode c96"],
                    "library_ms": None})
    kernels.append({"name": "fbank_dft_odd_shift", "route": "cuda",
                    "source": "chunkformer_tpu_torch/csrc/fbank.cu",
                    "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
                    "launches": other["fbank"]["50 ms / 161"]["launches"]["fbank"],
                    **other["fbank"]["50 ms / 161"]["dft"], "library_ms": None})
    kernels.append({"name": "fbank_fft_rnnt", "route": "cuda",
                    "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
                    "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
                    "launches": sum(c.get("fbank_fft", 0) for c in rnnt_launches.values()),
                    **rnnt["fbank"], "library_ms": None})
    f32_tc = train_results["train attention f32 p=0.0"]["tensor_core"]
    for part, line in (("fwd", 316), ("bwd", 390)):
        kernels.append(
            {"name": f"chunk_train_attention_tc_f32_{part}_cli", "route": "cuda",
             "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
             "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
             "launches": cli_train[f"{part}_tc"], **f32_tc[part], "library_ms": None})
    kernels += [
        {"name": "chunk_attention_tc_f32_cli", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": cli_decode["chunk_attention_tc"], **results["attention f32 tensor cores"],
         "library_ms": None},
        {"name": "fbank_fft_cli", "route": "cuda", "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": cli_decode["fbank_fft"], **results["fbank_fft"], "library_ms": None}]
    for part, line in (("fwd", 316), ("bwd", 390)):
        kernels.append(
            {"name": f"chunk_train_attention_tc_f32_{part}_sharded", "route": "cuda",
             "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
             "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
             "launches": sharded_train[f"{part}_tc"], **f32_tc[part], "library_ms": None})
    kernels += [
        {"name": "chunk_attention_tc_upload", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": upload_launches["bf16"]["chunk_attention_tc"],
         **results["attention bf16 tensor cores"], "library_ms": None},
        {"name": "chunk_attention_tc_f32_upload", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": upload_launches["f32"]["chunk_attention_tc"] + sharded_decode[
             "chunk_attention_tc"], **results["attention f32 tensor cores"], "library_ms": None},
        {"name": "fbank_fft_sharded_export", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": sharded_decode["fbank_fft"], **results["fbank_fft"], "library_ms": None}]
    for part, line in (("fwd", 316), ("bwd", 390)):
        kernels += [
            {"name": f"chunk_train_attention_tc_f32_{part}_recipe", "route": "cuda",
             "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
             "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
             "launches": recipe_train[f"train_{part}_tc"], **f32_tc[part], "library_ms": None},
            {"name": f"chunk_train_attention_tc_f32_{part}_dp1", "route": "cuda",
             "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc_f32.cu",
             "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
             "launches": dp_one[f"{part}_tc"], **f32_tc[part], "library_ms": None}]
    kernels += [
        {"name": "chunk_attention_tc_f32_apps", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": transcribe_launches["chunk_attention_tc"],
         **results["attention f32 tensor cores"], "library_ms": None},
        {"name": "fbank_fft_apps", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/fbank_fft.cu",
         "replaces": "chunkformer_tpu/ops/pallas/fbank.py:43",
         "launches": app_launches["fbank_fft"] + transcribe_launches["fbank_fft"],
         **results["fbank_fft"], "library_ms": None}]
    kernels += [
        {"name": "chunk_attention_tc_sharded", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": sharded_launches["bf16"]["chunk_attention_tc"],
         **results["attention bf16 tensor cores"], "library_ms": None},
        {"name": "chunk_attention_tc_f32_sharded", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc_f32.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": sharded_launches["f32"]["chunk_attention_tc"],
         **results["attention f32 tensor cores"], "library_ms": None},
        {"name": "chunk_attention_tc_bench", "route": "cuda",
         "source": "chunkformer_tpu_torch/csrc/chunk_attention_tc.cu",
         "replaces": "chunkformer_tpu/ops/pallas/chunk_attention.py:335",
         "launches": bench_launches["chunk_attention_tc"],
         **results["attention bf16 tensor cores"], "library_ms": None}]
    bf16_tc = train_results["train attention bf16 p=0.0"]["tensor_core"]
    for part, line in (("fwd", 316), ("bwd", 390)):
        kernels.append(
            {"name": f"chunk_train_attention_tc_{part}_bench", "route": "cuda",
             "source": "chunkformer_tpu_torch/csrc/chunk_attention_train_tc.cu",
             "replaces": f"chunkformer_tpu/ops/pallas/chunk_attention_train.py:{line}",
             "launches": bench_launches[f"{part}_tc"], **bf16_tc[part], "library_ms": None})
    log(f"kernels at the main paths' shapes (fbank: the 2040 s launch, the FFT kernel with "
        f"launches from the bf16 decode, the DFT kernel timed on the same input with launches "
        f"from the bf16 decode (0: not the route of the main path's geometry); "
        f"attention: N={capacity}, the tensor-core kernels "
        f"in bf16 and f32 with launches from the bf16 and the f32 decode, the CUDA-core kernel "
        f"timed in f32 with launches from the f32 decode (0: not the route of the main path's "
        f"shapes); train attention: B={TRAIN_BATCH}, p=0, the tensor-core kernels in bf16 "
        f"and f32 with launches from the bf16 steps and the f32 step, the CUDA-core kernels "
        f"timed in f32 with launches from the f32 step (0: not the route of the main path's "
        f"shapes); the search path: B4's forward in eval at the recognize batch's shape "
        f"(8 files, c = 64), launches from the bf16 and the f32 recognize calls; other "
        f"geometries: the decode kernels at c = 96, dk = 64 (the f32 and bf16 tensor-core "
        f"kernels and the f32 CUDA-core kernel), launches from the 120 s f32 endless_decode "
        f"at c = 96; fbank at 50 ms / 161, a 40 ms shift, 25 ms at 44.1 kHz, 160 bins, 128 "
        f"points (15 ms at 8 kHz) and 4096 points (25 ms at 96 kHz) (the FFT kernel; the DFT "
        f"kernel at 50 ms / 161 only), launches from one routed fbank call at each; "
        f"fbank_fft_block_*: the block plan at 8192, 16384 (120 s at 96 kHz) and 32768 "
        f"points (30 s at 192 kHz), launches from one routed fbank call at each; the "
        f"training kernels at c = 96 (*_c96: B = 8, 4 chunks, H = 8, dk = 64, p = 0.1; the "
        f"tensor-core kernels in f32 and bf16 and the f32 CUDA-core kernels), launches from "
        f"the flagship train step at (96, 128, 128) in that dtype, B4's eval forward at the "
        f"c = 96 encode of the search files, launches from that encode; the streaming path: "
        f"the FFT fbank kernel on one step's window, launches from the f32 bin/stream run; "
        f"classification: B4's forward in eval "
        f"at classify_audio's shape at (128, 128, 128) (the 40 s file), launches from "
        f"classify_audio over the 8 files in bf16 and in f32; the transducer (*_rnnt, H = 4): "
        f"B1 at a middle segment of the {RNNT_SECONDS:.0f} s endless_decode, launches from "
        f"its endless_decode and batch_decode in that dtype; B4's eval forward at its "
        f"recognize batch, launches from that recognize call; B4 and B5 at the train batch, "
        f"launches from the {TRAIN_STEPS} steps in that dtype; the FFT fbank kernel on the "
        f"{RNNT_SECONDS:.0f} s file, launches from all its decode paths; the train CLI "
        f"(*_cli): B4 and B5 in f32 on the tensor cores timed at the flagship train shape, "
        f"launches from its three bin/train.py runs (two epochs, the resume, the DDP step); "
        f"B1 f32 and the FFT fbank kernel timed at the main path's shapes, launches from the "
        f"{CLI_DECODE_SECONDS:.0f} s decode of the exported average; the sharding modes "
        f"(*_sharded): B4 and B5 f32 timed as *_cli, launches from the fsdp, tp and fsdp_tp "
        f"runs of bin/train.py; the host-feature upload (*_upload): B1 timed at the main "
        f"path's shapes, launches from endless_encode_tokens of the 2040 s file's host "
        f"features in bf16 and in f32 (f32 also from the decode of the fsdp_tp run's export); "
        f"fbank_fft_sharded_export: launches from that decode; the recipe (*_recipe): B4 and "
        f"B5 f32 timed as *_cli, launches from its stage 3 (bin/train.py in its own "
        f"process); the world-of-one data-parallel step (*_dp1): the same, launches from the "
        f"grouped step; the apps (*_apps): B1 f32 and the FFT fbank kernel timed at the main "
        f"path's shapes, launches from transcribe_audio of the 2040 s file (fbank also from "
        f"RealtimeASR.run's 60 s); the sharded decode (*_sharded): B1 timed at the main "
        f"path's shapes (the same N = {capacity} segment), launches from one "
        f"parallel_chunk(group=...) call at world size 1 in each dtype; the port's "
        f"benchmark (*_bench): B1 bf16 timed at the main path's shapes (its macro-segments "
        f"have the same N = {capacity}), launches from bench_torch.py's end-to-end and "
        f"device-walk stages; B4 and B5 bf16 timed at the flagship train shape, launches "
        f"from its train stage; card {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
