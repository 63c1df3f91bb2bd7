#!/usr/bin/env python3
"""Time and fingerprint the decode attention kernels (CUDA cores and tensor
cores), the CUDA-core training attention kernels (forward and backward), the
tensor-core training attention kernels (B4 and B5, f32 and bf16) and both
fbank kernels at the main paths' shapes (the FFT kernel also at a 50 ms
window, 1024 points), so that two checkouts can be compared on one card in
one call.

    cd <checkout> && python3 <this repo>/tools/compare_torch_kernels.py <tag> <out_dir>
    python3 tools/compare_torch_kernels.py --compare <out_dir>/ab_<a>.pt <out_dir>/ab_<b>.pt

The first form runs from a checkout's root (its package, its kernels and its
``chip_smoke.py`` helpers), prints each kernel's CUDA-event time in three
rounds and saves every output to ``<out_dir>/ab_<tag>.pt``; run it for the
parent and the change in turns (parent, change, change, parent). The second
form says which outputs are bit for bit equal.
"""
import os
import sys
import time


def compare(a_path, b_path):
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    for k in a:
        same = torch.equal(a[k], b[k])
        print(k, "bitwise equal" if same else
              f"DIFFER max {float((a[k].float() - b[k].float()).abs().max()):.3g}")


def fingerprint(tag, out_dir):
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat
    from chunkformer_tpu_torch.ops import kernels
    from chunkformer_tpu_torch.ops.chunk_attention import (chunk_attention_cuda_core,
                                                           chunk_attention_tensor_core)
    from chunkformer_tpu_torch.ops.fbank import fbank_dft, fbank_fft

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.time()
    kernels.library()
    print(tag, "build", round(time.time() - t, 1), "s", flush=True)
    outs, times = {}, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(chunk=64, left=128, right=128)
    for dtype in (torch.float32, torch.bfloat16):
        args = cs.attention_inputs(209, dtype, 11200, 13339, gen, dev)
        outs[f"decode {dtype}"] = chunk_attention_cuda_core(*args, **kw)
        times[f"decode {dtype}"] = [cs.cuda_ms(lambda: chunk_attention_cuda_core(*args, **kw),
                                               iters=20) for _ in range(3)]
        outs[f"decode tc {dtype}"] = chunk_attention_tensor_core(*args, **kw)
        times[f"decode tc {dtype}"] = [cs.cuda_ms(
            lambda: chunk_attention_tensor_core(*args, **kw), iters=50) for _ in range(3)]
        targs = cs.train_attention_inputs(dtype, gen, dev)
        st = (3, 64, 128, 128, 0.1)
        ctx, m, den = cat.forward_kernel(*targs, *st, path="cuda_core")
        dctx = torch.randn(ctx.shape, generator=gen, device=dev).to(dtype)
        grads = cat.backward_kernel(*targs, ctx, m, den, dctx, *st, path="cuda_core")
        outs[f"train fwd {dtype}"] = ctx
        outs[f"train bwd {dtype}"] = torch.cat([x.float().reshape(-1) for x in grads])
        times[f"train fwd {dtype}"] = [cs.cuda_ms(lambda: cat.forward_kernel(
            *targs, *st, path="cuda_core"), iters=10) for _ in range(3)]
        times[f"train bwd {dtype}"] = [cs.cuda_ms(lambda: cat.backward_kernel(
            *targs, ctx, m, den, dctx, *st, path="cuda_core"), iters=5) for _ in range(3)]
        for drop in (0.0, 0.1):
            st = (3, 64, 128, 128, drop)
            ctx, m, den = cat.forward_kernel(*targs, *st, path="tensor_core")
            grads = cat.backward_kernel(*targs, ctx, m, den, dctx, *st, path="tensor_core")
            outs[f"train tc fwd {dtype} p={drop}"] = ctx
            outs[f"train tc bwd {dtype} p={drop}"] = torch.cat(
                [x.float().reshape(-1) for x in grads])
            times[f"train tc fwd {dtype} p={drop}"] = [cs.cuda_ms(lambda: cat.forward_kernel(
                *targs, *st, path="tensor_core"), iters=20) for _ in range(3)]
            times[f"train tc bwd {dtype} p={drop}"] = [cs.cuda_ms(lambda: cat.backward_kernel(
                *targs, ctx, m, den, dctx, *st, path="tensor_core"), iters=20)
                for _ in range(3)]
    for sr, sec in ((16000, 2040.0), (8000, 120.0), (16000, 120.0)):
        wave = torch.from_numpy(cs.speechlike(np.random.default_rng(0), sec, sr)
                                .astype(np.float32)).to(dev)
        for name, fn, iters in (("fft", fbank_fft, 10), ("dft", fbank_dft, 3)):
            outs[f"{name} {sr} {sec}"] = fn(wave, sample_rate=sr)
            times[f"{name} {sr} {sec}"] = [cs.cuda_ms(lambda: fn(wave, sample_rate=sr),
                                                      iters=iters) for _ in range(3)]
        if sec == 120.0 and sr == 16000:
            outs["fft 50 ms"] = fbank_fft(wave, frame_length=50.0)
            times["fft 50 ms"] = [cs.cuda_ms(lambda: fbank_fft(wave, frame_length=50.0),
                                             iters=10) for _ in range(3)]
    torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    torch.save({k: v.cpu() for k, v in outs.items()}, os.path.join(out_dir, f"ab_{tag}.pt"))
    for k, v in times.items():
        print(tag, k, " ".join(f"{x:.4f}" for x in v), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        fingerprint(sys.argv[1], sys.argv[2])
