#!/usr/bin/env python3
"""Where the device time of the port's train step goes, on one NVIDIA card.

    python3 tools/profile_torch_train.py

Builds the flagship hybrid CTC/AED trainer of ``chip_smoke.py`` (bench.py:149-177:
ChunkFormer-large encoder with gradient checkpointing, bitransformer decoder
3 + 3, vocab 6992, adamw; random weights from a seed) and its seeded batch of
32 utterances of 16 s, once for each checkpoint policy (``remat_policy``
"dots", the configuration's, and "nothing", full recompute). For each it
times three bf16 steps without the profiler (wall time a step and peak device
memory), then runs one more under ``torch.profiler``. Last, with both
trainers built, it alternates ROUNDS unprofiled steps of each policy, so
that both see the same state of the machine, and prints each policy's step
times with their median. Prints the card's name and power limit, and per
policy the step's wall time, the summed kernel time and the device busy
share (summed kernel time over the profiled wall time, one stream), kernel
time by group, the top kernels by device time and the host operations by
self time.
"""

from __future__ import annotations

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
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    steps = {}
    for remat in ("dots", "nothing"):
        print(f"== remat_policy {remat!r}")
        train = {**smoke.TRAIN, "encoder_conf": {**smoke.TRAIN["encoder_conf"],
                                                 "remat_policy": remat}}
        steps[remat] = profile_step(train)
        if steps[remat] is None:
            return 1
        torch.cuda.empty_cache()
    times = {remat: [] for remat in steps}
    for _ in range(ROUNDS):
        for remat, run in steps.items():
            t0 = time.time()
            run()
            times[remat].append(time.time() - t0)
    print(f"== {ROUNDS} alternating unprofiled steps of each policy; {card}")
    for remat, ts in times.items():
        print(f"  {remat}: median {1e3 * sorted(ts)[len(ts) // 2]:.1f} ms a step; "
              + ", ".join(f"{1e3 * t:.1f}" for t in ts) + " ms")
    return 0


def profile_step(train):
    """Times and profiles the trainer of ``train``; returns a function that
    runs one more step, or None if the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()   # an earlier trainer's, not this one's
    cfg, model, step = smoke.new_trainer(train, dev, torch.bfloat16)
    batch = smoke.train_batch(cfg, dev, smoke.SEED + 2)
    gen = torch.Generator().manual_seed(smoke.SEED + 3)

    def run():
        return float(step(*batch, gen)["loss"])

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
    print(f"train step bf16, {audio_s:.0f} audio-s: wall {wall * 1e3:.1f} ms "
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
