#!/usr/bin/env python3
"""Device time of each training attention kernel, by route, on one NVIDIA card.

    python3 tools/profile_torch_train_attention.py [--chunk C --dk DK] [--splits S]

At the flagship train shape of ``chip_smoke.py`` (B = 32 utterances of 199
subsampled frames, n = 4 chunks of 64, L = R = 128, H = 8, dk = 64, p = 0;
operands from a seed), or with ``--chunk`` at the other-geometry shape of
``chip_smoke.py``'s ``other_train_inputs`` (B = 8 utterances of 4 chunks
of C frames, lengths down to 1, head dim ``--dk``), in bf16 and in f32,
runs the forward and the backward
of each route (``tensor_core``: the bf16 kernels or the 3xTF32 f32 kernels;
``cuda_core``) ROUNDS times under ``torch.profiler`` and prints each
kernel's mean device time a call, with the card's name and power limit. The
routes' wrappers launch several kernels a backward (dq, dK/dV and the sums of
the partials); this shows which of them holds the time. ``--splits S``
fixes the tensor-core dq kernel's chunk ranges an utterance
(``ops/chunk_attention_train.py dp_splits``; 0: the wrapper's choice), so
that the design with one dq block an utterance can be timed beside it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402  (flagship train attention operands)

ROUNDS = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunk size of the other-geometry shape (0: the flagship shape)")
    ap.add_argument("--dk", type=int, default=64, help="head dim with --chunk")
    ap.add_argument("--splits", type=int, default=0,
                    help="the dq kernel's chunk ranges an utterance (0: the wrapper's choice)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chunkformer_tpu_torch.ops import chunk_attention_train as cat

    if opts.splits:
        cat.dp_splits = lambda *_: opts.splits

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    c = opts.chunk or smoke.C
    st = (20260, c, smoke.LEFT, smoke.RIGHT, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        args = (smoke.other_train_inputs(c, opts.dk, dtype, gen, dev) if opts.chunk
                else smoke.train_attention_inputs(dtype, gen, dev))
        for path in ("tensor_core", "cuda_core"):
            ctx, m, den = cat.forward_kernel(*args, *st, path=path)
            dctx = torch.randn(ctx.shape, generator=gen, device=dev).to(dtype)

            def run():
                cat.forward_kernel(*args, *st, path=path)
                cat.backward_kernel(*args, ctx, m, den, dctx, *st, path=path)

            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUNDS):
                    run()
                torch.cuda.synchronize()
            rows = [(e.device_time_total / e.count / 1e3, e.count, e.key)
                    for e in prof.key_averages() if e.device_time_total > 0]
            total = sum(ms * n for ms, n, _ in rows) / ROUNDS
            print(f"== {path}: forward + backward, B={args[0].shape[0]} T'={args[0].shape[1]} "
                  f"H=8 c={c} dk={args[0].shape[3]} L=R={smoke.LEFT}, {str(dtype)[6:]}, p=0, dq "
                  f"chunk ranges {opts.splits or 'by the wrapper'}: "
                  f"{total:.4f} ms of kernels a forward and backward ({ROUNDS} rounds)")
            for ms, n, key in sorted(rows, key=lambda r: -r[0] * r[1]):
                print(f"  {ms:8.4f} ms a call  {n // ROUNDS:3d} a round  {key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
