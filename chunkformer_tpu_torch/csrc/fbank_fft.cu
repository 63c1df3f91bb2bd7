// Kaldi log-mel filterbank features for Hopper (sm_90a): a warp per frame,
// an FFT written by hand in the kernel's body, staged waveform tiles and a
// sparse mel product.
//
// Replaces the TPU kernel fbank_pallas (chunkformer_tpu/ops/pallas/fbank.py:43):
// framing (snip_edges) -> per-frame DC removal -> preemphasis 0.97 (the first
// sample against itself) -> povey window -> power spectrum of the frame
// zero-padded to `padded` points -> Kaldi mel bank (the Nyquist column is
// zero) -> log(max(., 1.1920929e-07)). Dither is 0 (decode-time features).
// It takes a padded window of 256, 512, 1024 or 2048 points, any shift and
// at most 128 mel bins; the DFT kernel of the same function (csrc/fbank.cu)
// takes more bins and other padded windows.
//
// What bounds it on an H100: a 512-point real FFT is about 12 kFLOP a frame,
// and with the rest about 15 kFLOP against about 1.3 KB of input and output
// a frame, some 11 FLOP/byte: below the f32 ridge of 67 TFLOP/s / 3.35 TB/s
// = 20 FLOP/byte, so the least time is set by bytes: the waveform read once
// and the features written once, 11.5 MB (3.4 us) for 120 s of 16 kHz audio,
// 196 MB (58 us) for 2040 s.
//
// Why an FFT and no tensor cores: the TPU kernel computed the DFT as a
// product with cos/sin tables at HIGHEST precision, O(padded^2) work that
// suits a matrix unit. On Hopper the f32-accurate tensor-core route is three
// TF32 passes (3xTF32), still O(padded^2): about 1.27 MFLOP a frame, some 80x
// the FFT's arithmetic, with an 845 KB table staged again for every tile.
//
// Why float64 from the samples to the power spectrum: after DC removal and
// preemphasis a frame's lowest mel bands can hold 1e-12 of the power of its
// loudest bins (tones of int16-scale audio). A float32 FFT's rounding, of
// order 1e-7 of the loudest bins' amplitude, then moves those bands' log by
// more than the bar of 2e-3 against a float64 reference (this design's and
// cuFFT's float32 FFTs alike); in float64 it stays far below. The H100 runs
// float64 at half the float32 rate, and the kernel is not bound by it. The
// power is rounded to float32 for the mel product and the log, which lose
// nothing at that range.
//
// Design:
//  - Persistent blocks (occupancy x SMs) walk tiles of tile_frames
//    consecutive frames (16, or fewer where a long window and shift would
//    not fit shared memory: ops/fbank.py fft_tile_frames). A tile's frames
//    span one contiguous run of (tile_frames - 1) * shift + win samples
//    when they overlap or touch, or one run each when a shift longer than
//    the window leaves gaps, copied into shared memory by cp.async (16 bytes
//    a thread from the 16-byte boundary at or below a run's first sample of
//    a 16-byte-aligned waveform, 4 bytes a thread otherwise),
//    double-buffered: tile i + 1 lands while tile i computes, and each
//    sample crosses DRAM once instead of win / shift times.
//  - One warp per frame. The padded frame x (real, `padded` points) is the
//    complex sequence z[n] = x[2n] + i x[2n+1] of N = padded / 2 points.
//    Each lane builds the first stage's inputs z[i + j N/8] of its
//    butterflies i = lane + 32 b in registers (DC removal by a warp sum,
//    preemphasis, window from shared memory, zero padding), runs a radix-8
//    DFT on them, and the remaining radix-8/4 Stockham stages exchange
//    through a per-warp buffer in shared memory (swizzled against bank
//    conflicts); the last one leaves Z[lane + 32 q] in the lane's
//    registers. At an odd shift, where frames start at odd samples, the
//    kernel instance reads each frame's samples one by one instead of in
//    aligned pairs. Padded 256 and 512
//    points take one first-stage butterfly a lane; 1024 points (50 ms at 16
//    kHz, 46 ms at 22.05 kHz) take two, then two radix-8 stages; 2048
//    points (25 ms at 44.1 and 48 kHz) take four, with the frame's sum taken
//    in a pass of its own so that only one butterfly's samples are in
//    registers at a time, then the stages (8, 8), (4, 64), (4, 256), the
//    last of which writes Z back to the buffer (32 outputs a lane would not
//    fit the registers beside the split), and four warps a block, since
//    each warp's buffer takes 16 KB. The real split
//    X[k] = (Z[k] + conj Z[N-k]) / 2 - i W^k (Z[k] - conj Z[N-k]) / 2,
//    W = exp(-2 pi i / padded), takes each Z[N-k] from lane 32 - lane by
//    shuffle (at 2048 points from the buffer) and gives the bins k < N (the
//    Nyquist bin meets a zero mel column and is not formed). Twiddles are
//    float64 tables computed on the host, one a stage laid out [j][k] so
//    that neighbouring lanes read neighbouring entries, held in shared
//    memory.
//  - Shared memory traffic and the float64 pipe hold it, not DRAM: registers
//    are capped (blocks_per_sm) so that three blocks, 24 warps, share an SM
//    at 256 and 512 points. At 1024 points a block takes about 127 KB of
//    shared memory (64 KB of it the warps' FFT buffers), so one block, 8
//    warps, fits an SM, and its registers are not capped; at 2048 points
//    about 196 KB (25 ms at 44.1 kHz; 64 KB of buffers for 4 warps).
//  - Sparse mel: each triangular band is a contiguous run of bins. The host
//    deals whole bands to the 32 lanes so that each lane has about as many
//    (bin, weight) steps as the others (about 16 for 80 bands at 512
//    points): every lane runs the same number of steps without divergence,
//    summing each of its bands over its bins in ascending order (no work on
//    the zeros). The warp then takes the full-precision log of the row, and
//    the tile's [frames, n_mels] rows, staged in shared memory, leave in
//    16-byte coalesced stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxTileFrames = 16;
// warps a block: eight, each with its own FFT buffer of N complex float64
// (16 KB at N = 1024, where four leave room for the tiles)
__host__ __device__ constexpr int warps(int n) { return n == 1024 ? 4 : 8; }
// registers capped so that 3 blocks (24 warps) fit an SM at N = 128 and
// 256; at N = 512 and 1024 shared memory admits one block an SM, which may
// then take all the registers
__host__ __device__ constexpr int blocks_per_sm(int n) { return n >= 512 ? 1 : 3; }
__host__ __device__ constexpr int threads(int n) { return 32 * warps(n); }
constexpr float kPreemph = 0.97f;
constexpr float kEps = 1.1920928955078125e-07f;
constexpr double kSqrtHalf = 0.70710678118654752440;

struct Params {
  const float* wave;      // [S]
  const double2* twiddle;  // per later stage (R, P): [R - 1][P] exp(-2 pi i k j / (P R))
  const double2* split;    // [N] exp(-2 pi i k / padded)
  const float* window;    // [win]
  const int2* mel;        // [mel_steps][32] a lane's steps: (bin, weight bits), the
                          // bin's high half band + 1 at a band's last bin, else 0
  float* out;             // [n_frames][n_mels]
  int n_frames, win, shift, n_mels, mel_steps;
  int tile_frames;        // frames a tile (ops/fbank.py fft_tile_frames)
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// A tile's samples in shared memory. Frames that overlap or touch (shift <=
// win) share one contiguous run of (tile_frames - 1) * shift + win samples;
// frames with gaps between them (shift > win) are copied one by one into
// slots of round4(win + 3) floats, so that no gap crosses DRAM. Either copy
// starts up to 3 samples early, at the 16-byte boundary below the first
// sample it needs (when the waveform is 16-byte aligned), so that it moves
// 16 bytes a thread whatever the shift; the first sample then sits `lead`
// floats into the run or slot.
__host__ __device__ constexpr bool per_frame(int win, int shift) { return shift > win; }
__host__ __device__ constexpr int tile_span(int win, int shift, int tile_frames) {
  return per_frame(win, shift) ? tile_frames * round4(win + 3)
                               : round4((tile_frames - 1) * shift + win + 3);
}

// Shared memory, in floats from the base; every part starts 16-byte aligned.
// ops/fbank.py fft_smem_bytes mirrors it.
struct Layout {
  int split, zbuf, tiles, span, staged, window, mel, total;
  __host__ __device__ Layout(int n, int win, int shift, int n_mels, int mel_steps,
                             int tile_frames) {
    split = 4 * n;                 // the stage twiddles take fewer than n double2
    zbuf = split + 4 * n;
    tiles = zbuf + 4 * n * warps(n);
    span = tile_span(win, shift, tile_frames);
    staged = tiles + 2 * span;
    window = staged + round4(tile_frames * n_mels);
    mel = window + 2 * round4(win);  // the window as float64
    total = mel + 2 * 32 * mel_steps;
  }
};

// complex slot c of a warp's FFT buffer, swizzled so that the 8 lanes of a
// quarter-warp touch 8 different 16-byte bank groups in every stage's loads
// and stores
__device__ __forceinline__ int slot(int c) { return c ^ ((c >> 3) & 7); }

__device__ __forceinline__ double2 cx(double re, double im) { return make_double2(re, im); }
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return cx(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return cx(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return cx(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ double2 mul_neg_i(double2 a) { return cx(a.y, -a.x); }
// a * exp(-2 pi i / 8) and a * exp(-2 pi i 3 / 8)
__device__ __forceinline__ double2 mul_w8(double2 a) {
  return cx((a.x + a.y) * kSqrtHalf, (a.y - a.x) * kSqrtHalf);
}
__device__ __forceinline__ double2 mul_w8_3(double2 a) {
  return cx((a.y - a.x) * kSqrtHalf, -(a.x + a.y) * kSqrtHalf);
}

// in-place 4-point DFT, natural order in and out
__device__ __forceinline__ void dft4(double2* a) {
  const double2 b0 = cadd(a[0], a[2]), b2 = csub(a[0], a[2]);
  const double2 b1 = cadd(a[1], a[3]), b3 = mul_neg_i(csub(a[1], a[3]));
  a[0] = cadd(b0, b1);
  a[1] = cadd(b2, b3);
  a[2] = csub(b0, b1);
  a[3] = csub(b2, b3);
}

// in-place 8-point DFT: one radix-2 step, then a 4-point DFT of the sums
// (even outputs) and of the twiddled differences (odd outputs)
__device__ __forceinline__ void dft8(double2* a) {
  double2 e[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = cadd(a[j], a[j + 4]);
    o[j] = csub(a[j], a[j + 4]);
  }
  o[1] = mul_w8(o[1]);
  o[2] = mul_neg_i(o[2]);
  o[3] = mul_w8_3(o[3]);
  dft4(e);
  dft4(o);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] = e[q];
    a[2 * q + 1] = o[q];
  }
}

template <int Radix>
__device__ __forceinline__ void dft(double2* a) {
  if constexpr (Radix == 8) dft8(a);
  else dft4(a);
}

// One radix-R Stockham stage of the N-point FFT in the warp's buffer z,
// after P points have been combined: butterfly i < N / R takes z[i + j N/R],
// j < R, multiplies them by W_{PR}^{(i mod P) j} = tw[(j - 1) P + i mod P]
// (the stage's own table, so that neighbouring lanes read neighbouring
// entries), and writes its R-point DFT to z[(i / P) P R + i mod P + j P].
// Every lane reads all its inputs before any lane writes, so the stage runs
// in place. The last stage (P R = N) keeps its outputs in registers when
// Regs: out[q] = Z[lane + 32 q].
template <int N, int R, int P, bool Regs = (P * R == N)>
__device__ __forceinline__ void stage(double2* z, const double2* tw, int lane,
                                      double2* out = nullptr) {
  constexpr int T = N / R;
  constexpr int B = (T + 31) / 32;
  double2 a[B][R];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = lane + 32 * b;
    if (i < T) {
#pragma unroll
      for (int j = 0; j < R; ++j) a[b][j] = z[slot(i + j * T)];
    }
  }
  __syncwarp();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = lane + 32 * b;
    if (i < T) {
      const int k = i % P;
#pragma unroll
      for (int j = 1; j < R; ++j) a[b][j] = cmul(a[b][j], tw[(j - 1) * P + k]);
      dft<R>(a[b]);
      if constexpr (Regs) {
        static_assert(P * R == N && T % 32 == 0, "the last stage has whole rounds of butterflies");
#pragma unroll
        for (int j = 0; j < R; ++j) out[b + B * j] = a[b][j];  // Z[i + P j], i = lane + 32 b
      } else {
        const int base = (i / P) * P * R + k;
#pragma unroll
        for (int j = 0; j < R; ++j) z[slot(base + j * P)] = a[b][j];
      }
    }
  }
  if constexpr (!Regs) __syncwarp();
}

// The N-point FFT's stages after the first radix-8 one (P = 8); tw holds
// their tables one after the other (ops/fbank.py FFT_STAGES). Up to N = 512
// it leaves Z[lane + 32 q] in out[q]; at N = 1024 (32 outputs a lane) it
// leaves Z in natural order in z.
template <int N>
__device__ __forceinline__ void later_stages(double2* z, const double2* tw, int lane,
                                             double2* out) {
  if constexpr (N == 1024) {
    stage<N, 8, 8>(z, tw, lane);
    stage<N, 4, 64>(z, tw + 7 * 8, lane);
    stage<N, 4, 256, false>(z, tw + 7 * 8 + 3 * 64, lane);
  } else if constexpr (N == 512) {
    stage<N, 8, 8>(z, tw, lane);
    stage<N, 8, 64>(z, tw + 7 * 8, lane, out);
  } else if constexpr (N == 256) {
    stage<N, 8, 8>(z, tw, lane);
    stage<N, 4, 64>(z, tw + 7 * 8, lane, out);
  } else {
    static_assert(N == 128, "the FFT kernel is instantiated for padded 256 to 2048");
    stage<N, 4, 8>(z, tw, lane);
    stage<N, 4, 32>(z, tw + 3 * 8, lane, out);
  }
}

// entries of the stage twiddle tables of the N-point FFT
__host__ __device__ constexpr int stage_twiddles(int n) {
  return n == 1024 ? 7 * 8 + 3 * 64 + 3 * 256
                   : n == 512 ? 7 * 8 + 7 * 64 : n == 256 ? 7 * 8 + 3 * 64 : 3 * 8 + 3 * 32;
}

// Samples s and s + 1 of a frame (0 unless `live`, s inside the window;
// s + 1 past it is 0) and sample s - 1 (s itself at s = 0: the first
// sample's preemphasis is against itself). With Pairs (x 8-byte aligned, as
// an even shift keeps it) the pair is one load; otherwise (a frame at an
// odd sample) two.
template <bool Pairs>
__device__ __forceinline__ void samples(const float* x, int s, bool live, int win, double& e,
                                        double& o, double& prev) {
  float2 pair = make_float2(0.f, 0.f);
  if constexpr (Pairs) {
    if (live) pair = *reinterpret_cast<const float2*>(x + s);
  } else {
    if (live) pair = make_float2(x[s], s + 1 < win ? x[s + 1] : 0.f);
  }
  e = pair.x;
  o = s + 1 < win ? pair.y : 0.f;
  prev = live ? x[s > 0 ? s - 1 : 0] : 0.f;
}

// The first stage's butterfly i: z[i + j N/8], j < 8, from the frame's
// samples 2(i + j N/8) and the next (DC removal, preemphasis, window, zero
// padding), its 8-point DFT stored at z[8i + j].
template <int N>
__device__ __forceinline__ void first_butterfly(const double (&xe)[8], const double (&xo)[8],
                                                const double (&xp)[8], double mean,
                                                const double* window, double2* z, int i,
                                                int win) {
  constexpr int T1 = N / 8;
  double2 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = 2 * (i + j * T1);
    const double e = xe[j] - mean, o = xo[j] - mean, p = xp[j] - mean;
    const double2 w = s < win ? *reinterpret_cast<const double2*>(window + s) : cx(0.0, 0.0);
    v[j].x = s < win ? (e - kPreemph * p) * w.x : 0.0;
    v[j].y = s + 1 < win ? (o - kPreemph * e) * w.y : 0.0;
  }
  dft8(v);
#pragma unroll
  for (int j = 0; j < 8; ++j) z[slot(8 * i + j)] = v[j];
}

// One frame on one warp: x is the frame's first sample in the staged tile
// (8-byte aligned with Pairs), z the warp's FFT buffer, row the frame's
// staged output row.
template <int N, bool Pairs>
__device__ __forceinline__ void frame(const float* x, const double* window, const double2* tw,
                                      const double2* split, const int2* mel, double2* z,
                                      float* row, int win, double inv_win, int n_mels,
                                      int mel_steps, int lane) {
  constexpr int T1 = N / 8;  // first-stage butterflies
  constexpr int B1 = (T1 + 31) / 32;  // a lane's: butterfly i = lane + 32 b
  static_assert(B1 == 1 || T1 % 32 == 0, "whole rounds of first-stage butterflies");
  if constexpr (B1 <= 2) {
    // the frame's samples stay in registers from the warp sum to the
    // first stage
    double xe[B1][8], xo[B1][8], xp[B1][8];
    double sum = 0.0;
#pragma unroll
    for (int b = 0; b < B1; ++b) {
      const int i = lane + 32 * b;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 2 * (i + j * T1);
        samples<Pairs>(x, s, i < T1 && s < win, win, xe[b][j], xo[b][j], xp[b][j]);
        sum += xe[b][j] + xo[b][j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const double mean = sum * inv_win;
#pragma unroll
    for (int b = 0; b < B1; ++b) {
      const int i = lane + 32 * b;
      if (i < T1) first_butterfly<N>(xe[b], xo[b], xp[b], mean, window, z, i, win);
    }
  } else {
    // four butterflies a lane (N = 1024): the sum first, then each
    // butterfly's samples again, which keeps 24 of them in registers at a
    // time rather than 96
    double sum = 0.0;
    for (int s = lane; s < win; s += 32) sum += x[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const double mean = sum * inv_win;
#pragma unroll
    for (int b = 0; b < B1; ++b) {
      const int i = lane + 32 * b;
      double xe[8], xo[8], xp[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 2 * (i + j * T1);
        samples<Pairs>(x, s, s < win, win, xe[j], xo[j], xp[j]);
      }
      first_butterfly<N>(xe, xo, xp, mean, window, z, i, win);
    }
  }
  __syncwarp();
  constexpr int Q = N / 32;
  float pw[Q];  // the power of bins k = lane + 32 q < N
  if constexpr (N <= 512) {
    double2 zq[Q];  // Z[lane + 32 q]
    later_stages<N>(z, tw, lane, zq);
    // real split: Z[N - k] is Z[(32 - lane) + 32 (Q - 1 - q)], in lane
    // 32 - lane's registers (lane 0: its own Z[32 ((Q - q) mod Q)])
    const int partner = (32 - lane) & 31;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      const double2 zk = zq[q], own = zq[(Q - q) & (Q - 1)];
      const double mx = __shfl_sync(0xffffffffu, zq[Q - 1 - q].x, partner);
      const double my = __shfl_sync(0xffffffffu, zq[Q - 1 - q].y, partner);
      const double2 zm = lane == 0 ? own : cx(mx, my), w = split[k];
      const double sx = zk.x + zm.x, sy = zk.y - zm.y;
      const double2 u = cmul(cx(zk.x - zm.x, zk.y + zm.y), w);
      const double re = 0.5 * (sx + u.y), im = 0.5 * (sy - u.x);
      pw[q] = (float)(re * re + im * im);
    }
  } else {
    later_stages<N>(z, tw, lane, nullptr);
    // real split with Z[k] and Z[N - k] from the buffer
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      const double2 zk = z[slot(k)], zm = z[slot((N - k) & (N - 1))], w = split[k];
      const double sx = zk.x + zm.x, sy = zk.y - zm.y;
      const double2 u = cmul(cx(zk.x - zm.x, zk.y + zm.y), w);
      const double re = 0.5 * (sx + u.y), im = 0.5 * (sy - u.x);
      pw[q] = (float)(re * re + im * im);
    }
    __syncwarp();  // every lane's loads are done before the power overwrites z
  }
  float* power = reinterpret_cast<float*>(z);
#pragma unroll
  for (int q = 0; q < Q; ++q) power[lane + 32 * q] = pw[q];
  __syncwarp();

  // sparse mel: each lane walks its steps, a band's bins in ascending order,
  // storing the band's sum at its last bin; then the log of the frame's row
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < mel_steps; ++j) {
    const int2 e = mel[32 * j + lane];
    acc = fmaf(power[e.x & 0xffff], __int_as_float(e.y), acc);
    if (e.x >> 16) {
      row[(e.x >> 16) - 1] = acc;
      acc = 0.f;
    }
  }
  __syncwarp();
  for (int m = lane; m < n_mels; m += 32) row[m] = logf(fmaxf(row[m], kEps));
  __syncwarp();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes, of which the first `bytes` come from src and the rest are 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one of this thread's cp.async groups is pending
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Samples that the copy of a run starting at sample g takes before g: the
// distance to the 16-byte boundary at or below wave + g, or 0 when the
// waveform is not 16-byte aligned (its copies then move 4 bytes a thread).
__device__ __forceinline__ int lead(const Params& p, int64_t g) {
  return (reinterpret_cast<uintptr_t>(p.wave) & 15) == 0 ? (int)(g & 3) : 0;
}

// Frame f of the tile starting at frame t0: its first sample in the tile
// buffer `buf`.
__device__ __forceinline__ const float* frame_in_tile(const float* buf, const Params& p, int t0,
                                                      int f) {
  if (per_frame(p.win, p.shift)) {
    const int64_t g = (int64_t)(t0 + f) * p.shift;
    return buf + f * round4(p.win + 3) + lead(p, g);
  }
  return buf + lead(p, (int64_t)t0 * p.shift) + f * p.shift;
}

// Issue the copies of tile `tile`'s samples into dst (a tile buffer): the
// samples [g - lead, g + len) of one run (g its first sample) into dst + i
// * stride for each of `runs` runs, 16 bytes a thread when the waveform is
// 16-byte aligned (the last chunk of a run zero-filled past it), 4 bytes a
// thread otherwise.
template <int N>
__device__ __forceinline__ void copy_tile(float* dst, const Params& p, int tile, int tid) {
  const int t0 = tile * p.tile_frames;
  const int nf = min(p.tile_frames, p.n_frames - t0);
  const bool each = per_frame(p.win, p.shift);
  const int runs = each ? nf : 1;
  const int len = each ? p.win : (nf - 1) * p.shift + p.win;
  const int stride = each ? round4(p.win + 3) : 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.wave) & 15) == 0;
  if (aligned && !each) {
    const int64_t g = (int64_t)t0 * p.shift;
    const int ld = lead(p, g), n = ld + len;  // floats of the run from the boundary
    for (int k = tid; 4 * k < n; k += threads(N))
      cp_async16(dst + 4 * k, p.wave + g - ld + 4 * k, 4 * min(n - 4 * k, 4));
  } else if (aligned) {
    const int chunks = (len + 3 + 3) / 4;  // a run's 16-byte chunks at most
    for (int c = tid; c < runs * chunks; c += threads(N)) {
      const int r = c / chunks, k = c % chunks;
      const int64_t g = (int64_t)(t0 + r) * p.shift;
      const int ld = lead(p, g), need = ld + len - 4 * k;  // floats left in the run
      if (need > 0)
        cp_async16(dst + r * stride + 4 * k, p.wave + g - ld + 4 * k, 4 * min(need, 4));
    }
  } else {
    for (int c = tid; c < runs * len; c += threads(N)) {
      const int r = c / len, e = c % len;
      cp_async4(dst + r * stride + e, p.wave + (int64_t)(t0 + r) * p.shift + e);
    }
  }
}

// Pairs: the shift is even, so that every frame starts 8-byte aligned in its
// tile buffer (a run's lead and its frames' offsets are then even) and takes
// its samples in pairs; at an odd shift every frame takes them one by one.
// One choice a launch keeps a block's warps on one code path: with frames
// of both kinds in one block, a 2048-point window at an odd shift took 75%
// longer on an H100 (PERF.md §6; the cause is not measured).
template <int N, bool Pairs>
__global__ void __launch_bounds__(threads(N), blocks_per_sm(N)) fbank_fft_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(N, p.win, p.shift, p.n_mels, p.mel_steps, p.tile_frames);
  double2* tw = reinterpret_cast<double2*>(smem);
  double2* split = reinterpret_cast<double2*>(smem + L.split);
  float* tiles = smem + L.tiles;
  float* staged = smem + L.staged;
  double* window = reinterpret_cast<double*>(smem + L.window);
  int2* mel = reinterpret_cast<int2*>(smem + L.mel);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  double2* z = reinterpret_cast<double2*>(smem + L.zbuf) + warp * N;

  const int n_tiles = (p.n_frames + p.tile_frames - 1) / p.tile_frames;
  int tile = blockIdx.x;
  if (tile < n_tiles) copy_tile<N>(tiles, p, tile, tid);
  cp_async_commit();
  for (int i = tid; i < N; i += threads(N)) split[i] = p.split[i];
  for (int i = tid; i < stage_twiddles(N); i += threads(N)) tw[i] = p.twiddle[i];
  for (int i = tid; i < p.win; i += threads(N)) window[i] = p.window[i];
  for (int i = tid; i < 32 * p.mel_steps; i += threads(N)) mel[i] = p.mel[i];
  const double inv_win = 1.0 / p.win;

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const float* cur = tiles + (it & 1) * L.span;
    const int next = tile + gridDim.x;
    if (next < n_tiles) copy_tile<N>(tiles + ((it + 1) & 1) * L.span, p, next, tid);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this tile's samples (and the tables) are in place

    const int t0 = tile * p.tile_frames;
    const int nf = min(p.tile_frames, p.n_frames - t0);
    for (int f = warp; f < nf; f += warps(N))
      frame<N, Pairs>(frame_in_tile(cur, p, t0, f), window, tw, split, mel, z,
                      staged + f * p.n_mels, p.win, inv_win, p.n_mels, p.mel_steps, lane);
    __syncthreads();  // the staged rows are complete; `cur` may be refilled

    float* dst = p.out + (int64_t)t0 * p.n_mels;
    const int len = nf * p.n_mels;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      const int n4 = len >> 2;
      for (int c = tid; c < n4; c += threads(N))
        reinterpret_cast<float4*>(dst)[c] = reinterpret_cast<const float4*>(staged)[c];
      done = 4 * n4;
    }
    for (int e = done + tid; e < len; e += threads(N)) dst[e] = staged[e];
  }
}

template <int N, bool Pairs>
int launch(const Params& p, cudaStream_t stream) {
  const Layout L(N, p.win, p.shift, p.n_mels, p.mel_steps, p.tile_frames);
  const size_t smem = sizeof(float) * (size_t)L.total;
  cudaError_t err = cudaFuncSetAttribute(
      fbank_fft_kernel<N, Pairs>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fbank_fft_kernel<N, Pairs>,
                                                           threads(N), smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (p.n_frames + p.tile_frames - 1) / p.tile_frames;
  const int blocks = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  fbank_fft_kernel<N, Pairs><<<blocks, threads(N), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers are on the device: wave and window float32; twiddle float64
// [stage_twiddles(padded / 2)][2] and split float64 [padded / 2][2] (see
// Params); mel int32 [mel_steps][32][2] (see Params); out float32
// [n_frames][n_mels]. padded is 256, 512, 1024 or 2048, win <= padded, any
// shift >= 1, 0 < n_mels <= 128, 1 <= tile_frames <= 16 (ops/fbank.py
// fft_plan picks it so that the block's shared memory fits). Returns a
// cudaError_t.
extern "C" int cf_fbank_fft(const float* wave, const double* twiddle,
                            const double* split, const float* window, const int* mel,
                            float* out, int n_frames, int win, int shift, int padded,
                            int n_mels, int mel_steps, int tile_frames, void* stream) {
  if (n_frames == 0) return 0;
  if (win < 1 || win > padded || shift < 1 || n_mels < 1 || n_mels > 128 || mel_steps < 1 ||
      tile_frames < 1 || tile_frames > kMaxTileFrames)
    return (int)cudaErrorInvalidValue;
  const Params p{wave, reinterpret_cast<const double2*>(twiddle),
                 reinterpret_cast<const double2*>(split), window,
                 reinterpret_cast<const int2*>(mel), out, n_frames, win, shift, n_mels,
                 mel_steps, tile_frames};
  cudaStream_t st = (cudaStream_t)stream;
  const bool even = shift % 2 == 0;
  if (padded == 2048) return even ? launch<1024, true>(p, st) : launch<1024, false>(p, st);
  if (padded == 1024) return even ? launch<512, true>(p, st) : launch<512, false>(p, st);
  if (padded == 512) return even ? launch<256, true>(p, st) : launch<256, false>(p, st);
  if (padded == 256) return even ? launch<128, true>(p, st) : launch<128, false>(p, st);
  return (int)cudaErrorInvalidValue;
}
