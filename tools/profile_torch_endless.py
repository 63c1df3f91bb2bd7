#!/usr/bin/env python3
"""Where the device time of the port's ``endless_decode`` goes, on one NVIDIA card.

    python3 tools/profile_torch_endless.py

Runs ``chunkformer_tpu_torch`` at ChunkFormer-large width with random weights
on the synthetic audio of ``chip_smoke.py`` (2040 s, 3 macro-segments), in
bf16 and in f32 (the default precision; TF32 off in cuBLAS and cuDNN), each
once to warm up and once under ``torch.profiler``; the f32 decode a third
time with the CUDA-core attention kernel swapped in for the routed one (the
3xTF32 tensor-core kernel at these shapes). Prints the card's name and power
limit and, for each run, the wall time, the summed kernel time and the
device busy share (summed kernel time over the profiled wall time, one
stream), kernel time by group (chunk attention on each route, fbank, matrix
products, convolutions, the rest), and the top kernels by device time.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402  (config, audio and sizes of the smoke run)


def group(name: str) -> str:
    n = name.lower()
    if "chunk_attention_tc" in n:
        return "chunk attention kernel, tensor cores"
    if "chunk_attention" in n:
        return "chunk attention kernel, CUDA cores"
    if "fbank" in n:
        return "fbank kernel"
    if "conv" in n:
        return "convolutions (cuDNN and native)"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "matmul")):
        return "matrix products (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies between host and device, memsets"
    return "elementwise, norms, reductions, other"


def profile_decode(model, args, label: str) -> bool:
    """One warm-up ``endless_decode``, then one under ``torch.profiler``;
    prints the wall time, kernel time by group and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    model.endless_decode(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        model.endless_decode(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the trace holds no device events", file=sys.stderr)
        return False
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_group[group(e.name)] = by_group.get(group(e.name), 0.0) + us
    total_ms = sum(by_name.values()) / 1e3
    print(f"endless_decode {label}, {smoke.LONG_SECONDS:.0f} s audio: wall {wall * 1e3:.1f} ms "
          f"({smoke.LONG_SECONDS / wall:.1f} audio-s/s) under the profiler; kernels "
          f"{total_ms:.1f} ms, {len(kernels)} launches; device busy {total_ms / (wall * 1e3):.3f}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.2f} ms  {us / 1e3 / total_ms:6.3f}  {g}")
    print("top kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3:9.2f} ms  {name[:110]}")
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from chunkformer_tpu_torch.api import ChunkFormerModel
    from chunkformer_tpu_torch.config import ChunkFormerConfig
    from chunkformer_tpu_torch.models.asr import ASRModel, init_random_
    from chunkformer_tpu_torch.nn import attention as attention_module
    from chunkformer_tpu_torch.ops.chunk_attention import chunk_attention_cuda_core

    # f32 runs in full f32, as in chip_smoke.py (cuDNN convolutions default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    cfg = ChunkFormerConfig.from_dict(smoke.LARGE)
    sd = init_random_(ASRModel(cfg), torch.Generator().manual_seed(smoke.SEED)).state_dict()
    tmp = tempfile.mkdtemp(prefix="profile_")
    try:
        wav = smoke.write_wav(os.path.join(tmp, "long.wav"),
                              smoke.speechlike(np.random.default_rng(smoke.SEED),
                                               smoke.LONG_SECONDS))
        args = (wav, smoke.C, smoke.LEFT, smoke.RIGHT, smoke.BUDGET)
        for dtype in (torch.bfloat16, torch.float32):
            model = ChunkFormerModel(cfg, sd, None, dtype=dtype)
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            if not profile_decode(model, args, f"{name}, attention on its routed kernel"):
                return 1
            if dtype == torch.float32:
                # the same f32 decode with the CUDA-core kernel swapped in
                routed = attention_module.chunk_attention
                attention_module.chunk_attention = chunk_attention_cuda_core
                try:
                    if not profile_decode(model, args, "f32, attention on the CUDA-core kernel"):
                        return 1
                finally:
                    attention_module.chunk_attention = routed
            del model
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
