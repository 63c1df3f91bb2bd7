#!/usr/bin/env python3
"""Where the FFT fbank kernel's time goes, phase by phase, on one NVIDIA card.

    python3 tools/profile_torch_fbank_phases.py [--seconds 2040]

Copies ``chunkformer_tpu_torch/csrc`` into ``build/fbank_phases/``, inserts
``clock64()`` marks at the phase boundaries of ``fbank_fft_kernel``
(fbank_fft.cu: the tile loop and each frame; lane 0 of each warp sums the
cycles between marks and adds them into a device array at the end), builds
that copy with the package's nvcc flags, and runs the kernel on the
``speechlike`` audio of ``chip_smoke.py`` (16 kHz, 2040 s by default) five
times after three warm-ups. Prints the ptxas report of the kernel, the
instrumented kernel's CUDA-event time, the mean cycles a frame (a warp's) in
each phase and its share, and the card's name, power limit and SM clock. The
marks cost a few registers and instructions, so the copy runs a little
slower than the package's kernel. Fails if a phase boundary is not found in
the source.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (the smoke run's audio and timer)

OUT = os.path.join(ROOT, "build", "fbank_phases")
SOURCE = "fbank_fft.cu"
# (source lines the mark goes before, each found once, phase it opens); a
# phase with two lines opens in either branch of an `if constexpr`
MARKS = [
    (["    const float* cur = tiles + (it & 1) * L.span;\n"],
     "tile: issue the next tile's cp.async, wait for this one, barrier"),
    (["  static_assert(B1 == 1 || T1 % 32 == 0, \"whole rounds of first-stage butterflies\");\n"],
     "frame: sample loads, float64 conversions, sum"),
    (["#pragma unroll\n    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, "
      "sum, o);\n    const double mean = sum * inv_win;\n#pragma unroll\n    for (int b = 0; b < "
      "B1; ++b) {\n      const int i = lane + 32 * b;\n      if (i < T1)",
      "#pragma unroll\n    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, "
      "sum, o);\n    const double mean = sum * inv_win;\n#pragma unroll\n    for (int b = 0; b < "
      "B1; ++b) {\n      const int i = lane + 32 * b;\n      double xe"],
     "warp sum, mean; preemphasis, window, radix-8 first stage, stores"),
    (["    later_stages<N>(z, tw, lane, zq);\n", "    later_stages<N>(z, tw, lane, nullptr);\n"],
     "later stages (the last in registers up to 1024 points)"),
    (["    // real split: Z[N - k] is Z[(32 - lane) + 32 (Q - 1 - q)], in lane\n",
      "    // real split with Z[k] and Z[N - k] from the buffer\n"],
     "real split (partners by shuffle, or from the buffer), power"),
    (["  // sparse mel: each lane walks its steps, a band's bins in ascending order,\n"],
     "sparse mel"),
    (["  for (int m = lane; m < n_mels; m += 32) row[m] = logf(fmaxf(row[m], kEps));\n"],
     "log of the frame's row"),
    (["    __syncthreads();  // the staged rows are complete; `cur` may be refilled\n"],
     "barrier after the tile's frames, coalesced write-out"),
]
FRAME_MARK = 1
CLOCK = r'''
__device__ unsigned long long g_phase[16];
__shared__ long long ph_t[8];
__shared__ unsigned long long ph_acc[8][16];
__shared__ int ph_last[8];
#define PHASE(n) do { if ((threadIdx.x & 31) == 0) { const int w_ = threadIdx.x >> 5; \
  const long long now_ = clock64(); ph_acc[w_][ph_last[w_]] += now_ - ph_t[w_]; \
  ph_t[w_] = now_; ph_last[w_] = (n); if ((n) == %d) ++ph_acc[w_][15]; } } while (0)
''' % FRAME_MARK


def instrument(text: str) -> str:
    n = len(MARKS)
    for k, (lines, _) in enumerate(MARKS):
        for line in lines:
            if text.count(line) != 1:
                raise SystemExit(f"phase boundary {k} not found once in {SOURCE}: {line!r}")
            indent = "  " if line.startswith("#") else line[:len(line) - len(line.lstrip())]
            if line.startswith("#pragma unroll\n    "):
                indent = "    "
            text = text.replace(line, f"{indent}PHASE({k});\n{line}")
    anchor = "__host__ __device__ constexpr int threads(int n) { return 32 * warps(n); }\n"
    text = text.replace(anchor, anchor + CLOCK, 1)
    start = "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
    text = text.replace(start, start + (
        f"  if (lane == 0) {{\n    for (int k = 0; k < 16; ++k) ph_acc[warp][k] = 0;\n"
        f"    ph_last[warp] = {n - 1};\n    ph_t[warp] = clock64();\n  }}\n"), 1)
    body = text.index("fbank_fft_kernel(Params p) {")
    end = text.index("\n}\n", body)
    text = (text[:end] + "\n  PHASE(0);\n  if (lane == 0)\n    for (int k = 0; k < 16; ++k) "
            "atomicAdd(&g_phase[k], ph_acc[warp][k]);" + text[end:])
    return text + r'''
extern "C" int probe_phases(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(unsigned long long) * 16);
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return static_cast<int>(cudaDeviceSynchronize());
}
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=smoke.LONG_SECONDS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from chunkformer_tpu_torch.ops import kernels
    from chunkformer_tpu_torch.ops.fbank import fbank_fft, num_frames

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
                if "Compiling entry" in line and "fbank_fft_kernel" in line:
                    name = line.split("'")[1]
                    print(name[name.index("fbank_fft_kernel"):], "|",
                          " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
    lib_path = os.path.join(OUT, "libcf_kernels_phases.so")
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib_path, *[s + ".o" for s in sources]], check=True)
    kernels.build = lambda: lib_path
    kernels.library.cache_clear()
    lib = kernels.library()
    lib.probe_phases.argtypes = [ctypes.c_void_p]

    dev = torch.device("cuda")
    wave = torch.from_numpy(smoke.speechlike(np.random.default_rng(smoke.SEED), args.seconds)
                            .astype(np.float32)).to(dev)
    frames = num_frames(wave.numel())
    buf = (ctypes.c_ulonglong * 16)()
    for _ in range(3):
        fbank_fft(wave)
    lib.probe_phases(buf)
    calls = 5
    for _ in range(calls):
        fbank_fft(wave)
    lib.probe_phases(buf)
    ms = smoke.cuda_ms(lambda: fbank_fft(wave), iters=10)
    n = len(MARKS)
    counted = buf[15]
    total = sum(buf[k] for k in range(n))
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    ok = counted == calls * frames
    print(f"fbank_fft_kernel, {args.seconds:.0f} s at 16 kHz ({frames} frames, {counted // calls} "
          f"counted a call{'' if ok else ', MISMATCH'}): instrumented kernel {ms:.4f} ms a "
          f"call; warp cycles a frame (lane 0 of each warp), by phase; card {smi.stdout.strip()}")
    for k in range(n):
        print(f"  {buf[k] / counted:10.1f}  {buf[k] / total:6.3f}  {MARKS[k][1]}")
    print(f"  {total / counted:10.1f}  1.000  a frame in all (tile phases spread over its frames)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
