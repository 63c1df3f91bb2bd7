// Kaldi log-mel filterbank features for Hopper (sm_90a) at padded windows
// above 4096 points: a block a frame, its 256 threads on one float64 FFT.
//
// Replaces the TPU kernel fbank_pallas (chunkformer_tpu/ops/pallas/fbank.py:43)
// for every window of more than 4096 samples (50 ms at 96 kHz or 100 ms at
// 48 kHz: 8192 points; 100 ms at 96 kHz: 16384; 100 ms at 192 kHz: 32768;
// any power of two from 8192 up): framing (snip_edges) -> per-frame DC
// removal -> preemphasis 0.97 (the first sample against itself) -> povey
// window -> power spectrum of the frame zero-padded to `padded` points ->
// Kaldi mel bank (the Nyquist column is zero) -> log(max(., 1.1920929e-07)).
// Dither is 0. Windows of up to 4096 points run fbank_fft.cu, a warp a frame;
// ops/fbank.py route sends each geometry to one of the two.
//
// Why a plan of its own: the warp plans keep a frame's N = padded / 2 complex
// float64 points in a warp's share of the block's shared memory, beside the
// split table, the window and the mel lane table. At 8192 points those
// tables alone are about 204 KB of the 227 KB a block may take, and from
// 32768 points one frame's buffer (256 KB) is more than a block can hold.
// Here the tables stay in global memory, read through the read-only cache,
// and a frame's buffer is the block's only large allocation: 64 KB of shared
// memory at 8192 points (two blocks an SM), 128 KB at 16384 (one), and
// from 32768 points a slot of a global workspace the wrapper allocates, one
// slot a resident block (N * 16 bytes: 256 KB at 32768 points, 33.8 MB for
// 132 blocks, within the H100's 50 MB L2).
//
// What bounds it on an H100: 5 N log2 N float64 operations a frame for the
// FFT (0.53 MFLOP at 16384 points), with the split and the mel sums, against
// the frame's shift of new samples read and n_mels features written: 90 to
// 200 operations a byte from 8192 to 32768 points at a 10 ms shift, far
// above the ridge of 67 TFLOP/s / 3.35 TB/s = 20. The float64 pipe
// (and the buffer's shared-memory or L2 traffic, a read and a write of the
// frame every stage) sets the least time, not DRAM.
//
// Design:
//  - Persistent blocks (ops/fbank.py fft_block_grid: 2 an SM at 8192
//    points, 1 at 16384 and with a workspace) walk the frames; block b's
//    workspace slot is b, so no two blocks share one.
//  - The frame mean: each thread sums its samples s = tid + 256 j in order,
//    the warp adds by shuffles, thread 0 of each warp leaves its sum in
//    shared memory and every thread adds the 8 in order (a fixed order: two
//    runs agree bit for bit).
//  - The FFT of z[n] = x[2n] + i x[2n+1] (DC removal, preemphasis, window
//    and zero padding applied as the samples are read from the waveform,
//    4 bytes a thread, any alignment) is an in-place decimation in
//    frequency, as the warp kernel's 4096-point plan: radix 8 while three
//    or more bits of N are left, then one stage of radix 4 or 2 (ops/fbank.py
//    fft_block_radices). A butterfly reads and writes its own R points, so a
//    thread holds one at a time, and the stages are split by __syncthreads.
//    The first stage takes its inputs from the samples. Twiddles W_N^e are
//    W_2N^2e, read from the split table. It leaves Z[k] at the digit-reversed
//    point z_pos(k).
//  - Buffer points are swizzled (slot) so that the 8 threads of a
//    quarter-warp reach 8 different 16-byte bank groups in every stage, in
//    the real split and in the mel sums: the point's bits 3-5 and its top
//    three bits (the first stage's digit, which the split's consecutive
//    bins walk) are folded into its low three.
//  - The real split X[k] = (Z[k] + conj Z[N-k]) / 2 - i W^k (Z[k] - conj
//    Z[N-k]) / 2, W = exp(-2 pi i / padded): a thread takes the pair (k, N -
//    k), reads both points, and writes both bins' powers into the real
//    parts of the same two points, which no other thread touches.
//  - The mel product: band m goes to warp m mod 8, whose 32 lanes take its
//    bins first + lane + 32 t in turn (the bins of a band are contiguous,
//    ops/fbank.py band_table), summing power * weight in float64; the warp
//    adds its lanes by shuffles, and lane 0 stores log(max(sum, eps)) as
//    float32. The powers stay float64 up to the log.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fbank_fft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// shared memory a block may opt into on sm_90 (227 KB on an H100)
constexpr int kMaxSmem = 232448;

struct BlockParams {
  const float* wave;      // [S]
  const double2* split;   // [N] exp(-2 pi i k / padded)
  const float* window;    // [win]
  const int4* bands;      // [n_mels] (first bin, bins, first weight, 0)
  const float* weights;   // the bands' weights, one after the other
  float* out;             // [n_frames][n_mels]
  double2* workspace;     // [slots][N], or null: the frame's buffer in shared memory
  int n_frames, win, shift, n_mels;
  int log_n;              // N = 2^log_n complex points, padded = 2N
};

// The buffer's slot of point c: bits 3-5 and the top three bits of c folded
// into its low three bits (top = log_n - 3)
__device__ __forceinline__ int slot(int c, int top) { return c ^ (((c >> 3) ^ (c >> top)) & 7); }

// Where the plan leaves Z[k]: its radix-8 digits, lowest first, from the top
// of the point down, and the last stage's digit (log_n mod 3 bits) at the
// bottom
__device__ __forceinline__ int z_pos(int k, int log_n) {
  int pos = 0, s = log_n;
  for (; s >= 3; s -= 3) {
    pos |= (k & 7) << (s - 3);
    k >>= 3;
  }
  return pos | k;
}

// W_N^e = W_2N^2e from the split table split[k] = W_2N^k, k < N: past the
// table it is -split[2e - N]
__device__ __forceinline__ double2 twiddle(const double2* split, int e, int n) {
  const int k = 2 * e;
  if (k < n) return __ldg(split + k);
  const double2 w = __ldg(split + k - n);
  return cx(-w.x, -w.y);
}

// One radix-R stage over blocks of ls points: butterfly u < N / R takes
// z[base + j h], h = ls / R, base = (u / h) ls + u mod h, and writes its
// R-point DFT, output q times W_ls^{(u mod h) q}, back to z[base + q h]
template <int R>
__device__ __forceinline__ void dif_stage(double2* z, const double2* split, int log_n, int ls,
                                          int tid) {
  const int n = 1 << log_n, h = ls / R, top = log_n - 3, e_step = n / ls;
  for (int u = tid; u < n / R; u += kThreads) {
    const int i = u & (h - 1), base = (u - i) * R + i;
    double2 a[R];
#pragma unroll
    for (int j = 0; j < R; ++j) a[j] = z[slot(base + j * h, top)];
    dft<R>(a);
#pragma unroll
    for (int q = 0; q < R; ++q)
      z[slot(base + q * h, top)] =
          h > 1 && q > 0 ? cmul(a[q], twiddle(split, i * q * e_step, n)) : a[q];
  }
}

// |X[k]|^2 of the real split from Z[k], Z[N - k] and W^k
__device__ __forceinline__ double split_power(double2 zk, double2 zm, double2 w) {
  const double sx = zk.x + zm.x, sy = zk.y - zm.y;
  const double2 u = cmul(cx(zk.x - zm.x, zk.y + zm.y), w);
  const double re = 0.5 * (sx + u.y), im = 0.5 * (sy - u.x);
  return re * re + im * im;
}

// Registers are capped at 128 a thread, so that two blocks share an SM where
// shared memory admits them (three at 8192 points would cap them at 85).
template <bool Shared>
__global__ void __launch_bounds__(kThreads, 2) fbank_fft_block_kernel(BlockParams p) {
  extern __shared__ __align__(16) double2 zbuf[];
  __shared__ double part[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = 1 << p.log_n, top = p.log_n - 3, t1 = n / 8;
  double2* z = Shared ? zbuf : p.workspace + (size_t)blockIdx.x * n;
  const double inv_win = 1.0 / p.win;

  for (int f = blockIdx.x; f < p.n_frames; f += gridDim.x) {
    const float* x = p.wave + (int64_t)f * p.shift;
    double sum = 0.0;
    for (int s = tid; s < p.win; s += kThreads) sum += __ldg(x + s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) part[warp] = sum;
    __syncthreads();
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w];
    const double mean = total * inv_win;

    // the first stage, radix 8 over all N points, from the samples
    for (int u = tid; u < t1; u += kThreads) {
      double2 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 2 * (u + j * t1);
        double re = 0.0, im = 0.0;
        if (s < p.win) {
          const double e = __ldg(x + s) - mean, prev = __ldg(x + (s > 0 ? s - 1 : 0)) - mean;
          re = (e - kPreemph * prev) * __ldg(p.window + s);
          if (s + 1 < p.win)
            im = (__ldg(x + s + 1) - mean - kPreemph * e) * __ldg(p.window + s + 1);
        }
        v[j] = cx(re, im);
      }
      dft8(v);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        z[slot(u + q * t1, top)] = q > 0 ? cmul(v[q], twiddle(p.split, u * q, n)) : v[q];
    }

    // the later stages: radix 8 over blocks of N / 8, N / 64, ..., then 4 or 2
    int ls = t1;
    for (int bits = p.log_n - 3; bits > 0;) {
      __syncthreads();
      if (bits >= 3) {
        dif_stage<8>(z, p.split, p.log_n, ls, tid);
        ls /= 8;
        bits -= 3;
      } else if (bits == 2) {
        dif_stage<4>(z, p.split, p.log_n, ls, tid);
        ls /= 4;
        bits -= 2;
      } else {
        dif_stage<2>(z, p.split, p.log_n, ls, tid);
        ls /= 2;
        bits -= 1;
      }
    }
    __syncthreads();

    // the real split, a pair (k, N - k) a thread; the powers overwrite the
    // real parts of the pair's own points
    for (int k = tid; k <= n / 2; k += kThreads) {
      const int m = (n - k) & (n - 1);
      const int pk = slot(z_pos(k, p.log_n), top), pm = slot(z_pos(m, p.log_n), top);
      const double2 zk = z[pk], zm = z[pm];
      const double pw = split_power(zk, zm, __ldg(p.split + k));
      if (m != k) z[pm].x = split_power(zm, zk, __ldg(p.split + m));
      z[pk].x = pw;
    }
    __syncthreads();

    // the sparse mel product and the log: a band a warp
    for (int mel = warp; mel < p.n_mels; mel += kWarps) {
      const int4 b = __ldg(p.bands + mel);
      double acc = 0.0;
      for (int t = lane; t < b.y; t += 32)
        acc += z[slot(z_pos(b.x + t, p.log_n), top)].x * (double)__ldg(p.weights + b.z + t);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0)
        p.out[(int64_t)f * p.n_mels + mel] = (float)log(fmax(acc, (double)kEps));
    }
    __syncthreads();  // the buffer and `part` are free for the next frame
  }
}

}  // namespace

// All pointers are on the device: wave and window float32; split float64
// [padded / 2][2] (exp(-2 pi i k / padded)); bands int32 [n_mels][4] (first
// bin, bins, offset of the first weight, 0) and weights float32 (ops/fbank.py
// band_table); out float32 [n_frames][n_mels]; workspace float64 [blocks]
// [padded / 2][2], or null where the frame's buffer fits shared memory
// (padded / 2 * 16 bytes, up to 16384 points: ops/fbank.py
// fft_block_in_shared). blocks is the persistent grid (ops/fbank.py
// fft_block_grid), cut to n_frames. padded is a power of two of at least
// 8192, 2 <= win <= padded, shift >= 1, n_mels >= 1. Returns a cudaError_t.
extern "C" int cf_fbank_fft_block(const float* wave, const double* split, const float* window,
                                  const int* bands, const float* weights, float* out,
                                  double* workspace, int n_frames, int win, int shift,
                                  int padded, int n_mels, int blocks, void* stream) {
  if (n_frames == 0) return 0;
  if (padded < 8192 || (padded & (padded - 1)) != 0 || win < 2 || win > padded || shift < 1 ||
      n_mels < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  int log_n = 0;
  while ((2 << log_n) < padded) ++log_n;
  const BlockParams p{wave, reinterpret_cast<const double2*>(split), window,
                      reinterpret_cast<const int4*>(bands), weights, out,
                      reinterpret_cast<double2*>(workspace), n_frames, win, shift, n_mels, log_n};
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = n_frames < blocks ? n_frames : blocks;
  if (workspace != nullptr) {
    fbank_fft_block_kernel<false><<<grid, kThreads, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(double2) << log_n;
  if (smem + kWarps * sizeof(double) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      fbank_fft_block_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fbank_fft_block_kernel<true><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}
