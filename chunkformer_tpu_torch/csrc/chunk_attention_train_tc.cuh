// What the tensor-core training attention kernels share across dtypes
// (chunk_attention_train_tc.cu for bf16, chunk_attention_train_tc_f32.cu for
// f32): the geometry, the dropout hash, the walk over the query blocks a key
// tile meets, and the backward's last two kernels, which sum the f32
// partials of dP, du and dv in a fixed order.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The dropout hash of chunk_attention_train.cu and window_keep_mask.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x2c1b3c6du;
  x ^= x >> 12;
  x *= 0x297a2d39u;
  x ^= x >> 15;
  return x;
}

struct Geom {
  int n, H, c, L, R;
  __host__ __device__ int W() const { return L + c + R; }
  __host__ __device__ int P() const { return 2 * c - 1 + L + R; }
  __host__ __device__ int T() const { return n * c; }
};

struct Drop {
  uint32_t seed, thresh;
  float scale;  // 1 / (1 - p)
  int on;
  // the tensor's head h is head h0 + h of Ht in the hash (a tensor-parallel
  // rank holds heads [h0, h0 + H) of Ht); h0 = 0, Ht = H on one process
  int h0, Ht;
};

// hash state of a query frame fq of (seed, b, h0 + h); keep key stream row
// fk iff mix32(row_state ^ fk) >= thresh
__device__ __forceinline__ uint32_t drop_row(const Drop& d, int b, int h, int fq) {
  return mix32(mix32(mix32(static_cast<uint32_t>(b * d.Ht + d.h0 + h)) ^ d.seed) ^
               static_cast<uint32_t>(fq));
}

// The next (query chunk, 64-row block) after (ci, r0) for a key tile of
// utterance len: r0 advances within the chunk while rows remain.
__device__ __forceinline__ void next_block(int& ci, int& r0, int c, int len) {
  r0 += 64;
  if (r0 >= c || ci * c + r0 >= len) {
    ++ci;
    r0 = 0;
  }
}

// first and last query chunk whose window [ci*c - L, ci*c + c + R) meets
// the key frames [f0, f0 + 64)
__device__ __forceinline__ void key_block_chunks(const Geom& g, int f0, int& ci_lo, int& ci_hi) {
  const int num = f0 - g.c - g.R;
  ci_lo = max(0, (num >= 0 ? num / g.c : -((-num + g.c - 1) / g.c)) + 1);
  ci_hi = min(g.n - 1, (f0 + 63 + g.L) / g.c);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// ------------------------------------------ backward: sum the partials

// dp = (sum over groups of the dP slabs + (sum of the band column sums) v)
// / sqrt(dk), one thread an element of dp [P, H, DK]
template <typename T>
__global__ void __launch_bounds__(256)
train_bwd_dp_tc_kernel(const float* __restrict__ dp_part, const float* __restrict__ cs_part,
                       const T* __restrict__ bias_v, T* __restrict__ dp, int groups, int H, int P,
                       int DK) {
  const float scale = rsqrtf(static_cast<float>(DK));
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<int64_t>(P) * H * DK) return;
  const int d = i % DK, h = (i / DK) % H, pr = i / (static_cast<int64_t>(DK) * H);
  float a = 0.f, cs = 0.f;
  for (int gi = 0; gi < groups; ++gi) {
    const int64_t cell = static_cast<int64_t>(gi) * H + h;
    a += dp_part[(cell * P + pr) * DK + d];
    cs += cs_part[cell * P + pr];
  }
  from_f32((a + cs * to_f32(bias_v[h * DK + d])) * scale, dp + i);
}

// du = sum over the dK/dV blocks of their partials / sqrt(dk) (blockIdx.y 1);
// dv = sum_m (sum over groups of the band column sums)[m] p[m] / sqrt(dk)
// (blockIdx.y 0); one block of 1024 threads a head, 1024 / DK threads a
// column, each summing a strided share, combined in a fixed order
template <typename T>
__global__ void __launch_bounds__(1024)
train_bwd_duv_tc_kernel(const float* __restrict__ cs_part, const float* __restrict__ du_part,
                        const T* __restrict__ pos, T* __restrict__ du, T* __restrict__ dv,
                        int groups, int blocks, int H, int P, int DK, int64_t spp, int64_t sph) {
  extern __shared__ float sm[];  // [P] column sums, then [1024] partials
  const int h = blockIdx.x, tid = threadIdx.x;
  const int parts = 1024 / DK, d = tid % DK, part = tid / DK;
  const float scale = rsqrtf(static_cast<float>(DK));
  float* red = sm + P;
  float a = 0.f;
  if (blockIdx.y == 0) {
    for (int m = tid; m < P; m += 1024) {
      float cs = 0.f;
      for (int gi = 0; gi < groups; ++gi) cs += cs_part[(static_cast<int64_t>(gi) * H + h) * P + m];
      sm[m] = cs;
    }
    __syncthreads();
    const T* ph = pos + h * sph + d;
    for (int m = part; m < P; m += parts) a = fmaf(sm[m], to_f32(ph[m * spp]), a);
  } else {
    for (int blk = part; blk < blocks; blk += parts)
      a += du_part[(static_cast<int64_t>(blk) * H + h) * DK + d];
  }
  red[tid] = a;
  __syncthreads();
  if (part == 0) {
    for (int k = 1; k < parts; ++k) a += red[k * DK + d];
    from_f32(a * scale, (blockIdx.y == 0 ? dv : du) + h * DK + d);
  }
}

// Launch the two sums: dp [P, H, DK] from the dq blocks' slabs, du and dv
// [H, DK] from the dK/dV blocks' partials and the column sums.
template <typename T>
int launch_partial_sums(const float* dp_part, const float* cs_part, const float* du_part,
                        const T* pos, const T* bias_v, T* dp, T* du, T* dv, int groups,
                        int kv_blocks, const Geom& g, int DK, int64_t spp, int64_t sph,
                        cudaStream_t stream) {
  const int64_t n_dp = static_cast<int64_t>(g.P()) * g.H * DK;
  train_bwd_dp_tc_kernel<T><<<static_cast<unsigned>((n_dp + 255) / 256), 256, 0, stream>>>(
      dp_part, cs_part, bias_v, dp, groups, g.H, g.P(), DK);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  train_bwd_duv_tc_kernel<T><<<dim3(g.H, 2), 1024, (g.P() + 1024) * sizeof(float), stream>>>(
      cs_part, du_part, pos, du, dv, groups, kv_blocks, g.H, g.P(), DK, spp, sph);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace
