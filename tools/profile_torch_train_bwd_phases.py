#!/usr/bin/env python3
"""Where the f32 tensor-core dq kernel's time goes, phase by phase, on one NVIDIA card.

    python3 tools/profile_torch_train_bwd_phases.py

Copies ``chunkformer_tpu_torch/csrc`` into ``build/bwd_phases/``, inserts
``clock64()`` marks at the phase boundaries of one key tile of
``train_bwd_dq_tc_f32_kernel`` (chunk_attention_train_tc_f32.cu; thread 0 of
each block sums the cycles between marks and adds them into a device array
at the end), builds that copy with the package's nvcc flags, and runs the
f32 tensor-core backward at the flagship train shape of ``chip_smoke.py``
(B = 32, 199 frames, c = 64, H = 8, dk = 64, L = R = 128, p = 0) five times
after three warm-ups. Prints the ptxas report of the f32 kernels, the mean
cycles a key tile in each phase and its share, and the card's name, power
limit and SM clock. The marks cost a few registers and instructions, so the
copy runs a little slower than the package's kernel. Fails if a phase
boundary is not found in the source.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (flagship train attention operands)

OUT = os.path.join(ROOT, "build", "bwd_phases")
SOURCE = "chunk_attention_train_tc_f32.cu"
# (source line the mark goes before, or after with True, phase it opens)
MARKS = [
    ("          const int pt0 = pb0 + 64 * t;  // first positional row of block t\n", True,
     "A: cp.async Q K P dctx V, u.k and v.p, split"),
    ("            product_step(bd, d1 == 0, u0, u2);", False, "S, BD, dA products, BD staged"),
    ("          // dS = A (keep dA / (1 - p) - delta), f32, in s, and its skewed f32\n", False,
     "raw staging issued; dS and the f32 band (warpgroup 0), cp.async wait"),
    ("          // dq += dS K: K^T (u1)", False, "K^T split_vt, band column sums"),
    ("          if (wg == 0) {\n            uint32_t ah[8][4], al[8][4];\n            acc_to_tf32(s, ah, al);",
     False, "dq += dS K"),
    ("          // this warpgroup's slab values (positional block t + wg), loaded while", False,
     "slab prefetch issued"),
    ("          // dq += band P, 64 positions at a time", False,
     "band halves: write, P^T split_vt, two products"),
    ("          // band^T [128 positions][64 rows]", False, "band^T and Q^T split_vt"),
    ("          // dP rows of block t + wg += band^T Q", False,
     "dP: a product a warpgroup, slab stores"),
    ("        // delta' = sum_j A_j dA_j", False,
     "between tiles and row blocks: delta, BD of block 0, dq stores"),
]
CLOCK = r'''
__device__ unsigned long long g_phase[16];
#define PHASE(n) do { if (threadIdx.x == 0) { long long now_ = clock64(); \
  ph_acc[ph_last] += now_ - ph_t; ph_t = now_; ph_last = (n); } } while (0)
'''


def instrument(text: str) -> str:
    n = len(MARKS)
    for k, (line, after, _) in enumerate(MARKS):
        if text.count(line) != 1:
            raise SystemExit(f"phase boundary {k} not found once in {SOURCE}: {line!r}")
        mark = f"PHASE({k});" + ("\n          ++ph_tiles;" if k == 0 else "")
        indent = line[:len(line) - len(line.lstrip())]
        text = text.replace(line, line + indent + mark + "\n" if after
                            else indent + mark + "\n" + line)
    text = text.replace('#include "tf32_split.cuh"\n', '#include "tf32_split.cuh"\n' + CLOCK, 1)
    start = "  const int grp = blockIdx.x, h = blockIdx.y, z = blockIdx.z, d0 = 64 * z;\n"
    text = text.replace(start, start + f"  long long ph_acc[{n}] = {{0}}, ph_t = clock64(), "
                        f"ph_tiles = 0;\n  int ph_last = {n - 1};\n", 1)
    end = text.index("\n}\n", text.index("train_bwd_dq_tc_f32_kernel("))
    text = (text[:end] + f"\n  if (threadIdx.x == 0) {{\n    for (int k = 0; k < {n}; ++k) "
            "atomicAdd(&g_phase[k], (unsigned long long)ph_acc[k]);\n"
            f"    atomicAdd(&g_phase[{n}], (unsigned long long)ph_tiles);\n  }}" + text[end:])
    return text + r'''
extern "C" int probe_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return static_cast<int>(cudaDeviceSynchronize());
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from chunkformer_tpu_torch.ops import chunk_attention_train as cat
    from chunkformer_tpu_torch.ops import kernels

    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, os.path.join(OUT, "csrc"))
    path = os.path.join(OUT, "csrc", SOURCE)
    with open(path) as f:
        text = instrument(f.read())
    with open(path, "w") as f:
        f.write(text)
    sources = sorted(glob.glob(os.path.join(OUT, "csrc", "*.cu")))
    procs = [subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-c", "-o", s + ".o", s],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for s in sources]
    for s, p in zip(sources, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {s}:\n{err}")
        if s.endswith(SOURCE):
            lines = err.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and "f32_kernel" in line:
                    name = line.split("'")[1]
                    print(name[name.index("train_"):name.index("EE") + 2], "|",
                          " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
    lib_path = os.path.join(OUT, "libcf_kernels_phases.so")
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib_path, *[s + ".o" for s in sources]], check=True)
    kernels.build = lambda: lib_path
    kernels.library.cache_clear()
    lib = kernels.library()
    lib.probe_phases.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    args = smoke.train_attention_inputs(torch.float32, gen, dev)
    st = (20260, smoke.C, smoke.LEFT, smoke.RIGHT, 0.0)
    ctx, m, den = cat.forward_kernel(*args, *st, path="tensor_core")
    dctx = torch.randn(ctx.shape, generator=gen, device=dev)
    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(3):
        cat.backward_kernel(*args, ctx, m, den, dctx, *st, path="tensor_core")
    lib.probe_phases(buf)
    calls = 5
    for _ in range(calls):
        cat.backward_kernel(*args, ctx, m, den, dctx, *st, path="tensor_core")
    lib.probe_phases(buf)
    n = len(MARKS)
    tiles = buf[n]
    total = sum(buf[k] for k in range(n))
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"dq kernel, f32, B={smoke.TRAIN_BATCH} T'={args[0].shape[1]} H=8 c={smoke.C} dk=64 "
          f"L=R={smoke.LEFT}, p=0: {tiles // calls} key tiles a call; cycles a key tile "
          f"(thread 0 of each block), by phase; card {smi.stdout.strip()}")
    for k in range(n):
        print(f"  {buf[k] / tiles:10.0f}  {buf[k] / total:6.3f}  {MARKS[k][2]}")
    print(f"  {total / tiles:10.0f}  1.000  a key tile in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
