#!/usr/bin/env python3
"""Where the device time of the port's train step goes, on one NVIDIA card.

    python3 tools/profile_torch_train.py [--part bf16|f32|all]

Builds the flagship hybrid CTC/AED trainer of ``chip_smoke.py`` (bench.py:149-177:
ChunkFormer-large encoder with gradient checkpointing, bitransformer decoder
3 + 3, vocab 6992, adamw; random weights from a seed) and its seeded batch of
32 utterances of 16 s. Part bf16: a bf16 trainer for each checkpoint policy
(``remat_policy`` "dots", the configuration's, and "nothing", full
recompute). Part f32: an f32 trainer (TF32 off, as the smoke's f32 step) of
the "dots" policy for each route of the training attention, the tensor cores
(the route of these shapes, 3xTF32) and the CUDA-core kernels swapped in.
For each trainer it times three steps without the profiler (wall time a step
and peak device memory), then runs one more under ``torch.profiler``. Last,
with a part's trainers built, it alternates ROUNDS unprofiled steps of each,
so that all see the same state of the machine, and prints each one's step
times with their median. Prints the card's name and power limit, and per
trainer the step's wall time, the summed kernel time and the device busy
share (summed kernel time over the profiled wall time, one stream), kernel
time by group, the top kernels by device time and the host operations by
self time.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402  (train configuration and batch of the smoke run)
from tools.profile_torch_endless import group as decode_group  # noqa: E402

ROUNDS = 8


def group(name: str) -> str:
    n = name.lower()
    if "train_fwd" in n:
        return "training attention forward kernel"
    if "train_bwd" in n:
        return "training attention backward kernels"
    if "ctc" in n:
        return "CTC loss"
    return decode_group(name)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--part", choices=("bf16", "f32", "all"), default="all")
    part = parser.parse_args().part
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    # f32 runs in full f32, as the smoke's f32 step: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    trainers = {}
    if part in ("bf16", "all"):
        for remat in ("dots", "nothing"):
            train = {**smoke.TRAIN, "encoder_conf": {**smoke.TRAIN["encoder_conf"],
                                                     "remat_policy": remat}}
            trainers[f"bf16 {remat}"] = (train, torch.bfloat16, None)
    if part in ("f32", "all"):
        trainers["f32 dots, tensor-core attention"] = (smoke.TRAIN, None, None)
        trainers["f32 dots, CUDA-core attention"] = (smoke.TRAIN, None,
                                                      cat.chunk_train_attention_cuda_core)
    for parts in ([k for k in trainers if k.startswith("bf16")],
                  [k for k in trainers if k.startswith("f32")]):
        if not parts:
            continue
        steps = {}
        for label in parts:
            print(f"== {label}")
            steps[label] = profile_step(label, *trainers[label])
            if steps[label] is None:
                return 1
            torch.cuda.empty_cache()
        times = {label: [] for label in steps}
        for _ in range(ROUNDS):
            for label, run in steps.items():
                t0 = time.time()
                run()
                times[label].append(time.time() - t0)
        print(f"== {ROUNDS} alternating unprofiled steps of each; {card}")
        for label, ts in times.items():
            print(f"  {label}: median {1e3 * sorted(ts)[len(ts) // 2]:.1f} ms a step; "
                  + ", ".join(f"{1e3 * t:.1f}" for t in ts) + " ms")
        del steps
        torch.cuda.empty_cache()
    return 0


def profile_step(label, train, autocast, attention):
    """Times and profiles the trainer of ``train`` under ``autocast`` (None:
    f32), with ``attention`` in place of the routed training attention if
    given; returns a function that runs one more step, or None if the trace
    holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    from chunkformer_tpu_torch.nn import attention as attention_module

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()   # earlier trainers', not this one's
    cfg, model, step = smoke.new_trainer(train, dev, autocast)
    batch = smoke.train_batch(cfg, dev, smoke.SEED + 2)
    gen = torch.Generator().manual_seed(smoke.SEED + 3)

    def run():
        routed = attention_module.chunk_train_attention
        if attention is not None:
            attention_module.chunk_train_attention = attention
        try:
            return float(step(*batch, gen)["loss"])
        finally:
            attention_module.chunk_train_attention = routed

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(smoke.TRAIN_STEPS):
        t0 = time.time()
        run()
        times.append(time.time() - t0)
    audio_s = smoke.TRAIN_BATCH * smoke.TRAIN_FRAMES / 100.0
    warm = sum(times[1:]) / len(times[1:])
    print("steps without the profiler: " + ", ".join(f"{1e3 * t:.1f}" for t in times)
          + f" ms; steps 2-{len(times)} {1e3 * warm:.1f} ms a step, {audio_s / warm:.1f} "
          f"train audio-s/s; peak device memory "
          f"{(torch.cuda.max_memory_allocated() - resident) / 2 ** 30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the trace holds no device events", file=sys.stderr)
        return None
    by_name, by_group = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        by_group[group(e.name)] = by_group.get(group(e.name), 0.0) + us
    total_ms = sum(by_name.values()) / 1e3
    print(f"train step {label}, {audio_s:.0f} audio-s: wall {wall * 1e3:.1f} ms "
          f"({audio_s / wall:.1f} audio-s/s) under the profiler; kernels {total_ms:.1f} ms, "
          f"{len(kernels)} launches; device busy {total_ms / (wall * 1e3):.3f}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:9.2f} ms  {us / 1e3 / total_ms:6.3f}  {g}")
    print("top kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:9.2f} ms  {name[:110]}")
    ops = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_ms = sum(e.self_cpu_time_total for e in ops) / 1e3
    print(f"host: {host_ms:.1f} ms of self time in {sum(e.count for e in ops)} profiled calls; "
          f"top by self time:")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms  {e.count:6d} calls  {e.key[:80]}")
    for e in prof.key_averages():
        if e.key.startswith("Optimizer.step"):
            print(f"optimizer update: {e.key}, {e.cpu_time_total / 1e3:.2f} ms of host time "
                  f"(with its children)")
    return run


if __name__ == "__main__":
    sys.exit(main())
