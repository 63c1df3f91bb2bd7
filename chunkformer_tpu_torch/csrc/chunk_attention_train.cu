// Limited-context training attention for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels of chunkformer_tpu/ops/pallas/chunk_attention_train.py:
// the forward _attn_fwd_call (:316, kernel _fwd_kernel :78) and the backward
// _attn_core_bwd (:390, kernel _bwd_kernel :161 and the overlap-add :469-482).
//
// Function (see chunkformer_tpu_torch/ops/chunk_attention_train.py): for
// utterance b, chunk ci, head h, query row r < c and window position j < W =
// L + c + R (stream row ci*c + j, key frame f = ci*c - L + j),
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid   iff 0 <= f < len[b] and ci*c + r < len[b]
//   ctx[r]  = sum_j keep(r, j) / (1 - p_drop) * softmax_j(s[r, j] | valid) v[j]
// and the softmax statistics m (row max, clamped at -1e29) and den (row sum,
// clamped at 1e-30). Validity is one interval [lo, hi) of j per (b, ci),
// emptied for query rows at or past len.
//
// What bounds them on an H100: at the flagship train shape (B = 32, n = 4,
// c = 64, H = 8, dk = 64, L = R = 128, 199 frames) the forward reads q, the
// 512-row K|V stream, P, u, v and writes ctx, m, den (about 51 MB in bf16,
// 15.3 us at 3.35 TB/s) and does about 3.8 GFLOP over the valid keys (3.8 us
// on bf16 tensor cores): bytes bound it. The backward also reads ctx, m, den
// and dctx and writes the gradients of q, kv, P, u, v (about 102 MB, 30.4 us)
// and does 8/3 the operations (10.1 GFLOP, 10.3 us). chip_smoke.py computes
// these bounds from each run's inputs.
//
// Design (simple and right first; tensor cores, TMA and speed come later):
// - Forward: one block per (b, ci, h), as csrc/chunk_attention.cu: queries
//   (q + u)/sqrt(dk) and (q + v)/sqrt(dk) in shared memory in f32, the window
//   walked in key tiles of 32 rows read in place from the stream (no unfold)
//   with the 32 + c - 1 positional rows the rel-shift needs (row c-1-r+j),
//   an online softmax in f32, and dropout applied to the weights that enter
//   the context sum but not to the denominator. It writes ctx and the final
//   (m, den), so the backward needs no second reduction.
// - Backward, in three kernels with no atomics, so the result is
//   deterministic:
//   (a) per (b, ci, h) block: recompute A = exp(s - m)/den from the forward's
//       statistics, dA = keep * dctx . v / (1 - p), delta = rowsum(A dA)
//       (the TPU kernel's; in bf16 from a first pass over the key tiles, in
//       f32 as rowsum(dctx * ctx), FlashAttention-2's equal form), dS = A
//       (dA - delta); dq = (dS k + unshift(dS) p)
//       / sqrt(dk); per-block partials of dP = unshift(dS)^T (q + v)/sqrt(dk)
//       (a slab of its own in device memory) and of du, dv.
//   (b) per (b, 32 key frames, h) block: dK = dS^T (q + u)/sqrt(dk) and
//       dV = A_drop^T dctx, summed over the query chunks whose windows cover
//       those keys (at most ceil((L + c + R)/c) + 1). Only real frames get a
//       gradient: the L and R zero rows of the stream are dropped.
//   (c) a reduction of the dP, du and dv partials over (b, ci).
// - Any chunk and head_dim: a thread keeps at most kMaxOut = 16 outputs. The
//   forward and the dq kernel cut a chunk into slices_of(c, dk) slices of
//   rows_per_slice(c, dk) query rows (a third grid axis), each against the
//   whole window with the positional rows its own rows need; the dq kernel
//   writes one dP / du / dv partial per slice. The dK/dV kernel cuts its
//   32 x dk outputs into column slices of at most 128 (a third grid axis; each
//   recomputes the tile's weights) and, past 200-odd dk, walks the queries
//   in tiles of 16 rows so that its shared memory fits. Every output is
//   summed in the same order whatever the slicing, and the shapes that fit
//   one block (c * dk <= 4096, dk <= 128) run instantiations whose slice is
//   the whole chunk (and the query tile 32 rows) at compile time: the
//   kernels as they were before slicing, bit for bit and in time.
// - Dropout: keep iff a counter-based hash of (seed, b, h, query frame, key
//   stream row) >= threshold, so every kernel and the plain version
//   regenerate the same mask from absolute positions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;       // keys (or query rows) per tile == warp width
constexpr int kMaxOut = 16;     // outputs per thread: (rows of a slice) * dk <= 4096

// Query rows of a chunk a forward or dq block takes, and the slices of a
// chunk: at most 4096 / dk rows each, as even as the count of slices allows.
__host__ __device__ inline int slices_of(int c, int dk) {
  const int most = 4096 / dk;
  return (c + most - 1) / most;
}
__host__ __device__ inline int rows_per_slice(int c, int dk) {
  const int s = slices_of(c, dk);
  return (c + s - 1) / s;
}
// Column slices of the dK/dV kernel's 32 x dk outputs: at most 128 columns.
__host__ __device__ inline int col_slices(int dk) { return (dk + 127) / 128; }
__host__ __device__ inline int cols_per_slice(int dk) {
  const int s = col_slices(dk);
  return (dk + s - 1) / s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x2c1b3c6du;
  x ^= x >> 12;
  x *= 0x297a2d39u;
  x ^= x >> 15;
  return x;
}


__device__ __forceinline__ bool keep(uint32_t state, int fq, int fk, uint32_t thresh) {
  return mix32(mix32(state ^ (uint32_t)fq) ^ (uint32_t)fk) >= thresh;
}

struct Geom {
  int n, H, c, dk, L, R;
  // the dropout hash's head offset and head count: the tensor's head h is
  // head h0 + h of Ht (a tensor-parallel rank holds heads [h0, h0 + H))
  int h0, Ht;
  __host__ __device__ int W() const { return L + c + R; }
  __host__ __device__ int P() const { return 2 * c - 1 + L + R; }
  __host__ __device__ int T() const { return n * c; }
};

// Hash state of (seed, b, h): mix(mix(b*Ht + h0 + h) ^ seed).
__device__ __forceinline__ uint32_t drop_state(uint32_t seed, int b, int h, const Geom& g) {
  return mix32(mix32((uint32_t)(b * g.Ht + g.h0 + h)) ^ seed);
}

// ---------------------------------------------------------------- forward

template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                 const T* __restrict__ pos, const T* __restrict__ bias_u,
                 const T* __restrict__ bias_v, const int* __restrict__ lens,
                 T* __restrict__ ctx, float* __restrict__ m_out,
                 float* __restrict__ den_out, Geom g, uint32_t seed, uint32_t thresh,
                 float drop_scale, int use_drop,
                 int64_t sqb, int64_t sqt, int64_t sqh,
                 int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / g.n, ci = blockIdx.x % g.n, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = g.c, dk = g.dk, W = g.W(), ld = dk + 1;
  // this block's query rows [r0, r0 + cs) of the chunk; local row r is r0 + r
  const int cmax = kSliced ? rows_per_slice(c, dk) : c;
  const int r0 = kSliced ? (int)blockIdx.z * cmax : 0;
  const int cs = kSliced ? min(cmax, c - r0) : c;
  const int p_rows = kTile + cs - 1;
  const int p0 = kSliced ? c - r0 - cs : 0;  // first positional row of the slice at j = 0

  float* qu = smem;                      // [cs][ld]
  float* qv = qu + cs * ld;              // [cs][ld]
  float* ks = qv + cs * ld;              // [kTile][ld]
  float* vs = ks + kTile * ld;           // [kTile][ld]
  float* ps = vs + kTile * ld;           // [p_rows][ld]
  float* sc = ps + p_rows * ld;          // [cs][kTile + 1] weights of this tile
  float* row_m = sc + cs * (kTile + 1);  // [cs] running max
  float* row_l = row_m + cs;             // [cs] running sum
  float* row_a = row_l + cs;             // [cs] rescale factor of this tile

  const float scale = rsqrtf((float)dk);
  const int len = lens[b];
  const int lo = max(0, g.L - ci * c);
  const int hi = min(W, len - ci * c + g.L);
  const int rows = min(cs, max(0, len - ci * c - r0));   // valid query rows of the slice
  const uint32_t st = drop_state(seed, b, h, g);
  const int64_t fq0 = (int64_t)ci * c + r0;   // the slice's first query frame

  const T* qb = q + (int64_t)b * sqb + fq0 * sqt + (int64_t)h * sqh;
  for (int i = tid; i < cs * dk; i += kThreads) {
    const int r = i / dk, d = i % dk;
    const float x = to_f32(qb[(int64_t)r * sqt + d]);
    qu[r * ld + d] = (x + to_f32(bias_u[h * dk + d])) * scale;
    qv[r * ld + d] = (x + to_f32(bias_v[h * dk + d])) * scale;
  }
  for (int r = tid; r < cs; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }

  const int n_out = (cs * dk + kThreads - 1) / kThreads;
  float acc[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) acc[k] = 0.f;

  const T* kvb = kv + (int64_t)b * skb + (int64_t)ci * c * skt + (int64_t)h * skh;
  const T* pb = pos + (int64_t)h * sph;

  for (int j0 = (lo / kTile) * kTile; j0 < hi && rows > 0; j0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * dk; i += kThreads) {
      const int jj = i / dk, d = i % dk, j = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (j < W) {
        const T* row = kvb + (int64_t)j * skt;
        kx = to_f32(row[d]);
        vx = to_f32(row[dk + d]);
      }
      ks[jj * ld + d] = kx;
      vs[jj * ld + d] = vx;
    }
    for (int i = tid; i < p_rows * dk; i += kThreads) {
      const int pr = i / dk, d = i % dk, pidx = j0 + p0 + pr;
      ps[pr * ld + d] = pidx < g.P() ? to_f32(pb[(int64_t)pidx * spp + d]) : 0.f;
    }
    __syncthreads();

    for (int r = warp; r < cs; r += kThreads / 32) {
      const int j = j0 + lane;
      float s = -INFINITY;
      if (r < rows && j >= lo && j < hi) {
        const float* a = qu + r * ld;
        const float* bk = ks + lane * ld;
        const float* e = qv + r * ld;
        const float* f = ps + (cs - 1 - r + lane) * ld;
        float ac = 0.f, bd = 0.f;
        for (int d = 0; d < dk; ++d) {
          ac = fmaf(a[d], bk[d], ac);
          bd = fmaf(e[d], f[d], bd);
        }
        s = ac + bd;
      }
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, tmax);
      const float pr = (s == -INFINITY) ? 0.f : expf(s - m_new);
      float psum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      float pw = pr;
      if (use_drop) pw = keep(st, ci * c + r0 + r, ci * c + j, thresh) ? pr * drop_scale : 0.f;
      sc[r * (kTile + 1) + lane] = pw;
      if (lane == 0) {
        const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
        row_a[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      if (k < n_out) {
        const int i = tid + k * kThreads;
        if (i < cs * dk) {
          const int r = i / dk, d = i % dk;
          const float* prow = sc + r * (kTile + 1);
          float a = acc[k] * row_a[r];
          for (int jj = 0; jj < kTile; ++jj) a = fmaf(prow[jj], vs[jj * ld + d], a);
          acc[k] = a;
        }
      }
    }
  }
  __syncthreads();

  const int64_t t0 = (int64_t)b * g.T() + fq0;   // first frame of the slice
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k < n_out) {
      const int i = tid + k * kThreads;
      if (i < cs * dk) {
        const int r = i / dk, d = i % dk;
        const float l = row_l[r];
        store(ctx + ((t0 + r) * g.H + h) * dk + d, l > 0.f ? acc[k] / l : 0.f);
      }
    }
  }
  for (int r = tid; r < cs; r += kThreads) {
    const int64_t o = ((int64_t)b * g.H + h) * g.T() + fq0 + r;
    m_out[o] = fmaxf(row_m[r], -1e29f);
    den_out[o] = fmaxf(row_l[r], 1e-30f);
  }
}

// ------------------------------------------------------- backward (a): dq

template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
train_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                    const T* __restrict__ pos, const T* __restrict__ bias_u,
                    const T* __restrict__ bias_v, const int* __restrict__ lens,
                    const T* __restrict__ ctx, const float* __restrict__ m_in,
                    const float* __restrict__ den_in, const T* __restrict__ dctx,
                    float* __restrict__ delta_out, T* __restrict__ dq,
                    float* __restrict__ dp_part, float* __restrict__ duv_part, Geom g,
                    uint32_t seed, uint32_t thresh, float drop_scale, int use_drop,
                    int64_t sqb, int64_t sqt, int64_t sqh,
                    int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / g.n, ci = blockIdx.x % g.n, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = g.c, dk = g.dk, W = g.W(), P = g.P(), ld = dk + 1;
  // this block's query rows [r0, r0 + cs) of the chunk; local row r is r0 + r
  const int cmax = kSliced ? rows_per_slice(c, dk) : c;
  const int r0 = kSliced ? (int)blockIdx.z * cmax : 0;
  const int cs = kSliced ? min(cmax, c - r0) : c;
  const int p_rows = kTile + cs - 1;
  const int p0 = kSliced ? c - r0 - cs : 0;  // first positional row of the slice at j = 0

  float* qu = smem;                      // [cs][ld]
  float* qv = qu + cs * ld;              // [cs][ld]
  float* gs = qv + cs * ld;              // [cs][ld] dctx
  float* ks = gs + cs * ld;              // [kTile][ld]
  float* vs = ks + kTile * ld;           // [kTile][ld]
  float* ps = vs + kTile * ld;           // [p_rows][ld]
  float* ds = ps + p_rows * ld;          // [cs][kTile + 1]
  float* row_m = ds + cs * (kTile + 1);  // [cs]
  float* row_den = row_m + cs;           // [cs]
  float* row_delta = row_den + cs;       // [cs]

  const float scale = rsqrtf((float)dk);
  const int len = lens[b];
  const int lo = max(0, g.L - ci * c);
  const int hi = min(W, len - ci * c + g.L);
  const int rows = min(cs, max(0, len - ci * c - r0));   // valid query rows of the slice
  const uint32_t st = drop_state(seed, b, h, g);
  const int64_t fq0 = (int64_t)ci * c + r0;   // the slice's first query frame
  // partials of cell (b, ci, slice), in that order
  const int64_t blk = (kSliced ? (int64_t)blockIdx.x * gridDim.z + blockIdx.z
                               : (int64_t)blockIdx.x) * g.H + h;
  float* slab = dp_part + blk * P * dk;
  const int64_t t0 = (int64_t)b * g.T() + fq0;
  const int64_t s0 = ((int64_t)b * g.H + h) * g.T() + fq0;

  const T* qb = q + (int64_t)b * sqb + fq0 * sqt + (int64_t)h * sqh;
  for (int i = tid; i < cs * dk; i += kThreads) {
    const int r = i / dk, d = i % dk;
    const float x = to_f32(qb[(int64_t)r * sqt + d]);
    qu[r * ld + d] = (x + to_f32(bias_u[h * dk + d])) * scale;
    qv[r * ld + d] = (x + to_f32(bias_v[h * dk + d])) * scale;
    gs[r * ld + d] = to_f32(dctx[((t0 + r) * g.H + h) * dk + d]);
  }
  for (int i = tid; i < P * dk; i += kThreads) slab[i] = 0.f;
  // delta: with an f32 ctx rowsum(dctx * ctx) (FlashAttention-2), equal to
  // rowsum(A dA) up to f32 rounding; with a bf16 ctx its rounding dominates
  // dS where attention is flat, so there the first pass below takes
  // rowsum(A dA) in f32 from the scores and dA of the second (as the TPU
  // kernel does)
  constexpr bool kExactDelta = !std::is_same<T, float>::value;
  for (int r = warp; r < cs; r += kThreads / 32) {
    float a = 0.f;
    if (!kExactDelta) {
      const T* cr = ctx + ((t0 + r) * g.H + h) * dk;
      const T* gr = dctx + ((t0 + r) * g.H + h) * dk;
      for (int d = lane; d < dk; d += 32) a = fmaf(to_f32(gr[d]), to_f32(cr[d]), a);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    }
    if (lane == 0) {
      row_delta[r] = a;
      row_m[r] = m_in[s0 + r];
      row_den[r] = den_in[s0 + r];
    }
  }

  const int n_out = (cs * dk + kThreads - 1) / kThreads;
  float dqu[kMaxOut], dqv[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) dqu[k] = dqv[k] = 0.f;

  const T* kvb = kv + (int64_t)b * skb + (int64_t)ci * c * skt + (int64_t)h * skh;
  const T* pb = pos + (int64_t)h * sph;

  // the key tile at window position j0 and its positional rows
  auto load_tile = [&](int j0) {
    for (int i = tid; i < kTile * dk; i += kThreads) {
      const int jj = i / dk, d = i % dk, j = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (j < W) {
        const T* row = kvb + (int64_t)j * skt;
        kx = to_f32(row[d]);
        vx = to_f32(row[dk + d]);
      }
      ks[jj * ld + d] = kx;
      vs[jj * ld + d] = vx;
    }
    for (int i = tid; i < p_rows * dk; i += kThreads) {
      const int pr = i / dk, d = i % dk, pidx = j0 + p0 + pr;
      ps[pr * ld + d] = pidx < P ? to_f32(pb[(int64_t)pidx * spp + d]) : 0.f;
    }
  };
  // A and dA (times keep / (1 - p)) of query row r and key j0 + lane; false
  // where the pair is not valid
  auto weight = [&](int r, int j0, float& att, float& da) {
    const int j = j0 + lane;
    if (!(r < rows && j >= lo && j < hi)) return false;
    const float* a = qu + r * ld;
    const float* bk = ks + lane * ld;
    const float* e = qv + r * ld;
    const float* f = ps + (cs - 1 - r + lane) * ld;
    const float* gr = gs + r * ld;
    const float* vr = vs + lane * ld;
    float ac = 0.f, bd = 0.f;
    da = 0.f;
    for (int d = 0; d < dk; ++d) {
      ac = fmaf(a[d], bk[d], ac);
      bd = fmaf(e[d], f[d], bd);
      da = fmaf(gr[d], vr[d], da);
    }
    att = expf(ac + bd - row_m[r]) / row_den[r];
    if (use_drop) da = keep(st, ci * c + r0 + r, ci * c + j, thresh) ? da * drop_scale : 0.f;
    return true;
  };

  if (kExactDelta) {
    for (int j0 = (lo / kTile) * kTile; j0 < hi && rows > 0; j0 += kTile) {
      __syncthreads();
      load_tile(j0);
      __syncthreads();
      for (int r = warp; r < cs; r += kThreads / 32) {
        float att, da, a = 0.f;
        if (weight(r, j0, att, da)) a = att * da;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) row_delta[r] += a;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < cs; r += kThreads) delta_out[s0 + r] = row_delta[r];

  for (int j0 = (lo / kTile) * kTile; j0 < hi && rows > 0; j0 += kTile) {
    __syncthreads();
    load_tile(j0);
    __syncthreads();

    for (int r = warp; r < cs; r += kThreads / 32) {
      float att, da, dsv = 0.f;
      if (weight(r, j0, att, da)) dsv = att * (da - row_delta[r]);
      ds[r * (kTile + 1) + lane] = dsv;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      if (k < n_out) {
        const int i = tid + k * kThreads;
        if (i < cs * dk) {
          const int r = i / dk, d = i % dk;
          const float* drow = ds + r * (kTile + 1);
          const float* prow = ps + (cs - 1 - r) * ld + d;
          float au = dqu[k], av = dqv[k];
          for (int jj = 0; jj < kTile; ++jj) {
            au = fmaf(drow[jj], ks[jj * ld + d], au);
            av = fmaf(drow[jj], prow[jj * ld], av);
          }
          dqu[k] = au;
          dqv[k] = av;
        }
      }
    }
    // dP rows j0 + p0 + pr: sum over r of dS[r, pr - (cs - 1) + r] * qv[r]
    for (int i = tid; i < p_rows * dk; i += kThreads) {
      const int pr = i / dk, d = i % dk;
      if (j0 + p0 + pr >= P) continue;
      const int r_lo = max(0, cs - 1 - pr), r_hi = min(rows, cs - 1 - pr + kTile);
      float a = 0.f;
      for (int r = r_lo; r < r_hi; ++r)
        a = fmaf(ds[r * (kTile + 1) + pr - (cs - 1) + r], qv[r * ld + d], a);
      slab[(int64_t)(j0 + p0 + pr) * dk + d] += a;
    }
  }
  __syncthreads();

  // dq, and the per-block du / dv partials through shared memory (qu, qv reused)
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k < n_out) {
      const int i = tid + k * kThreads;
      if (i < cs * dk) {
        const int r = i / dk, d = i % dk;
        store(dq + ((t0 + r) * g.H + h) * dk + d, (dqu[k] + dqv[k]) * scale);
        qu[r * ld + d] = dqu[k] * scale;
        qv[r * ld + d] = dqv[k] * scale;
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < dk; d += kThreads) {
    float su = 0.f, sv = 0.f;
    for (int r = 0; r < cs; ++r) {
      su += qu[r * ld + d];
      sv += qv[r * ld + d];
    }
    duv_part[blk * 2 * dk + d] = su;
    duv_part[blk * 2 * dk + dk + d] = sv;
  }
}

// -------------------------------------------------- backward (b): dk, dv

template <typename T, int QT, bool kColSliced>
__global__ void __launch_bounds__(kThreads)
train_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                     const T* __restrict__ pos, const T* __restrict__ bias_u,
                     const T* __restrict__ bias_v, const int* __restrict__ lens,
                     const float* __restrict__ m_in, const float* __restrict__ den_in,
                     const float* __restrict__ delta_in, const T* __restrict__ dctx,
                     T* __restrict__ dkv, Geom g, uint32_t seed, uint32_t thresh,
                     float drop_scale, int use_drop,
                     int64_t sqb, int64_t sqt, int64_t sqh,
                     int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                     int64_t sdb, int64_t sdt, int64_t sdh) {
  constexpr int qt = QT;                 // query rows a tile (32, or 16 at large dk)
  extern __shared__ float smem[];
  const int tiles = (g.T() + kTile - 1) / kTile;
  const int b = blockIdx.x / tiles, f0 = (blockIdx.x % tiles) * kTile, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = g.c, dk = g.dk, W = g.W(), P = g.P(), ld = dk + 1;
  const int p_rows = qt + kTile - 1;
  // this block's output columns [d0, d0 + dn) of dK and dV
  const int d0 = kColSliced ? (int)blockIdx.z * cols_per_slice(dk) : 0;
  const int dn = kColSliced ? min(cols_per_slice(dk), dk - d0) : dk;

  float* ks = smem;                      // [kTile][ld] keys of this block
  float* vs = ks + kTile * ld;           // [kTile][ld]
  float* qu = vs + kTile * ld;           // [qt][ld] query tile
  float* qv = qu + qt * ld;              // [qt][ld]
  float* gs = qv + qt * ld;              // [qt][ld] dctx
  float* ps = gs + qt * ld;              // [p_rows][ld]
  float* as = ps + p_rows * ld;          // [qt][kTile + 1] dropped weights
  float* ds = as + qt * (kTile + 1);     // [qt][kTile + 1]
  float* row_m = ds + qt * (kTile + 1);
  float* row_den = row_m + qt;
  float* row_delta = row_den + qt;

  const float scale = rsqrtf((float)dk);
  const int len = lens[b];
  const uint32_t st = drop_state(seed, b, h, g);

  const T* kvb = kv + (int64_t)b * skb + (int64_t)h * skh;
  for (int i = tid; i < kTile * dk; i += kThreads) {
    const int jj = i / dk, d = i % dk, f = f0 + jj;
    float kx = 0.f, vx = 0.f;
    if (f < g.T()) {
      const T* row = kvb + (int64_t)(g.L + f) * skt;
      kx = to_f32(row[d]);
      vx = to_f32(row[dk + d]);
    }
    ks[jj * ld + d] = kx;
    vs[jj * ld + d] = vx;
  }

  const int n_out = (kTile * dn + kThreads - 1) / kThreads;
  float dka[kMaxOut], dva[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) dka[k] = dva[k] = 0.f;

  // query chunks whose window [ci*c - L, ci*c + c + R) meets [f0, f0 + kTile)
  const int num = f0 - c - g.R;
  const int ci_lo = max(0, (num >= 0 ? num / c : -((-num + c - 1) / c)) + 1);
  const int ci_hi = min(g.n - 1, (f0 + kTile - 1 + g.L) / c);
  const T* pb = pos + (int64_t)h * sph;

  for (int ci = ci_lo; ci <= ci_hi && f0 < len; ++ci) {
    for (int r0 = 0; r0 < c && ci * c + r0 < len; r0 += qt) {
      __syncthreads();
      const T* qb = q + (int64_t)b * sqb + (int64_t)(ci * c + r0) * sqt + (int64_t)h * sqh;
      const int64_t t0 = (int64_t)b * g.T() + ci * c + r0;
      for (int i = tid; i < qt * dk; i += kThreads) {
        const int rr = i / dk, d = i % dk;
        float x = 0.f, gx = 0.f;
        if (r0 + rr < c) {
          x = to_f32(qb[(int64_t)rr * sqt + d]);
          gx = to_f32(dctx[((t0 + rr) * g.H + h) * dk + d]);
        }
        qu[rr * ld + d] = (x + to_f32(bias_u[h * dk + d])) * scale;
        qv[rr * ld + d] = (x + to_f32(bias_v[h * dk + d])) * scale;
        gs[rr * ld + d] = gx;
      }
      // positional rows c-1-(r0+rr)+j for j = L + f0 + jj - ci*c: base at rr = qt-1, jj = 0
      const int pbase = c - 1 - (r0 + qt - 1) + g.L + f0 - ci * c;
      for (int i = tid; i < p_rows * dk; i += kThreads) {
        const int pr = i / dk, d = i % dk, pidx = pbase + pr;
        ps[pr * ld + d] = (pidx >= 0 && pidx < P) ? to_f32(pb[(int64_t)pidx * spp + d]) : 0.f;
      }
      for (int rr = tid; rr < qt; rr += kThreads) {
        const int64_t o = ((int64_t)b * g.H + h) * g.T() + ci * c + r0 + rr;
        const bool in = r0 + rr < c;
        row_m[rr] = in ? m_in[o] : 0.f;
        row_den[rr] = in ? den_in[o] : 1.f;
        row_delta[rr] = in ? delta_in[o] : 0.f;
      }
      __syncthreads();

      for (int rr = warp; rr < qt; rr += kThreads / 32) {
        const int r = r0 + rr, f = f0 + lane, j = g.L + f - ci * c;
        float av = 0.f, dsv = 0.f;
        if (r < c && ci * c + r < len && f < len && j >= 0 && j < W) {
          const float* a = qu + rr * ld;
          const float* bk = ks + lane * ld;
          const float* e = qv + rr * ld;
          const float* pp = ps + (qt - 1 - rr + lane) * ld;
          const float* gr = gs + rr * ld;
          const float* vr = vs + lane * ld;
          float ac = 0.f, bd = 0.f, da = 0.f;
          for (int d = 0; d < dk; ++d) {
            ac = fmaf(a[d], bk[d], ac);
            bd = fmaf(e[d], pp[d], bd);
            da = fmaf(gr[d], vr[d], da);
          }
          const float att = expf(ac + bd - row_m[rr]) / row_den[rr];
          av = att;
          if (use_drop) {
            const bool kp = keep(st, ci * c + r, ci * c + j, thresh);
            av = kp ? att * drop_scale : 0.f;
            da = kp ? da * drop_scale : 0.f;
          }
          dsv = att * (da - row_delta[rr]);
        }
        as[rr * (kTile + 1) + lane] = av;
        ds[rr * (kTile + 1) + lane] = dsv;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kMaxOut; ++k) {
        if (k < n_out) {
          const int i = tid + k * kThreads;
          if (i < kTile * dn) {
            const int jj = i / dn, d = d0 + i % dn;
            float ak = dka[k], avv = dva[k];
            for (int rr = 0; rr < qt; ++rr) {
              ak = fmaf(ds[rr * (kTile + 1) + jj], qu[rr * ld + d], ak);
              avv = fmaf(as[rr * (kTile + 1) + jj], gs[rr * ld + d], avv);
            }
            dka[k] = ak;
            dva[k] = avv;
          }
        }
      }
    }
  }

  T* ob = dkv + (int64_t)b * sdb + (int64_t)h * sdh;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k < n_out) {
      const int i = tid + k * kThreads;
      if (i < kTile * dn) {
        const int jj = i / dn, d = d0 + i % dn, f = f0 + jj;
        if (f < g.T()) {
          T* row = ob + (int64_t)(g.L + f) * sdt;
          store(row + d, dka[k]);
          store(row + dk + d, dva[k]);
        }
      }
    }
  }
}

// ------------------------------------------ backward (c): sum the partials

template <typename T>
__global__ void __launch_bounds__(kThreads)
train_bwd_reduce_kernel(const float* __restrict__ dp_part, const float* __restrict__ duv_part,
                        T* __restrict__ dp, T* __restrict__ du, T* __restrict__ dv,
                        int cells, Geom g) {
  const int dk = g.dk, P = g.P(), H = g.H;
  const int64_t n_dp = (int64_t)P * H * dk;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_dp) {                        // dp [P, H, dk]
    const int d = i % dk, h = (i / dk) % H, pr = i / ((int64_t)dk * H);
    float a = 0.f;
    for (int cell = 0; cell < cells; ++cell)
      a += dp_part[(((int64_t)cell * H + h) * P + pr) * dk + d];
    store(dp + i, a);
  } else if (i < n_dp + 2 * H * dk) {    // du, dv [H, dk]
    const int e = i - n_dp, which = e / (H * dk), h = (e / dk) % H, d = e % dk;
    float a = 0.f;
    for (int cell = 0; cell < cells; ++cell)
      a += duv_part[((int64_t)cell * H + h) * 2 * dk + which * dk + d];
    store((which ? dv : du) + h * dk + d, a);
  }
}

size_t fwd_smem(const Geom& g) {
  const int ld = g.dk + 1, cs = rows_per_slice(g.c, g.dk);
  return sizeof(float) * ((size_t)2 * cs * ld + 2 * kTile * ld + (size_t)(kTile + cs - 1) * ld +
                          (size_t)cs * (kTile + 1) + 3 * cs);
}

size_t dq_smem(const Geom& g) {
  const int ld = g.dk + 1, cs = rows_per_slice(g.c, g.dk);
  return sizeof(float) * ((size_t)3 * cs * ld + 2 * kTile * ld + (size_t)(kTile + cs - 1) * ld +
                          (size_t)cs * (kTile + 1) + 3 * cs);
}

size_t dkv_smem(const Geom& g, int qt) {
  const int ld = g.dk + 1;
  return sizeof(float) * ((size_t)(2 * kTile + 3 * qt) * ld + (size_t)(qt + kTile - 1) * ld +
                          (size_t)2 * qt * (kTile + 1) + 3 * qt);
}

// The dK/dV kernel's query tile: 32 rows where its shared memory fits a
// block, else 16 (past about dk = 249 on an H100).
int dkv_query_tile(const Geom& g, int* qt) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *qt = dkv_smem(g, kTile) <= (size_t)most ? kTile : kTile / 2;
  return (int)err;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool kSliced>
int launch_fwd_as(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, void* ctx, float* m, float* den, int B, Geom g,
               uint32_t seed, uint32_t thresh, float drop_scale, int use_drop,
               const int64_t* s, cudaStream_t stream) {
  const size_t smem = fwd_smem(g);
  int err = set_smem(train_fwd_kernel<T, kSliced>, smem);
  if (err) return err;
  train_fwd_kernel<T, kSliced><<<dim3(B * g.n, g.H, slices_of(g.c, g.dk)), kThreads, smem,
                                 stream>>>(
      (const T*)q, (const T*)kv, (const T*)pos, (const T*)u, (const T*)v, lens, (T*)ctx, m,
      den, g, seed, thresh, drop_scale, use_drop, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, void* ctx, float* m, float* den, int B, Geom g,
               uint32_t seed, uint32_t thresh, float drop_scale, int use_drop,
               const int64_t* s, cudaStream_t stream) {
  auto go = slices_of(g.c, g.dk) > 1 ? launch_fwd_as<T, true> : launch_fwd_as<T, false>;
  return go(q, kv, pos, u, v, lens, ctx, m, den, B, g, seed, thresh, drop_scale, use_drop, s,
            stream);
}

template <typename T, bool kSliced>
int launch_dq(const void* q, const void* kv, const void* pos, const void* u, const void* v,
              const int* lens, const void* ctx, const float* m, const float* den,
              const void* dctx, float* delta, void* dq, float* dp_part, float* duv_part, int B,
              Geom g, uint32_t seed, uint32_t thresh, float drop_scale, int use_drop,
              const int64_t* s, cudaStream_t stream) {
  const size_t smem = dq_smem(g);
  int err = set_smem(train_bwd_dq_kernel<T, kSliced>, smem);
  if (err) return err;
  train_bwd_dq_kernel<T, kSliced><<<dim3(B * g.n, g.H, slices_of(g.c, g.dk)), kThreads, smem,
                                    stream>>>(
      (const T*)q, (const T*)kv, (const T*)pos, (const T*)u, (const T*)v, lens, (const T*)ctx,
      m, den, (const T*)dctx, delta, (T*)dq, dp_part, duv_part, g, seed, thresh, drop_scale,
      use_drop, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return (int)cudaGetLastError();
}

template <typename T, int QT, bool kColSliced>
int launch_dkv(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, const float* m, const float* den, const float* delta,
               const void* dctx, void* dkv, int B, Geom g, uint32_t seed, uint32_t thresh,
               float drop_scale, int use_drop, const int64_t* s, cudaStream_t stream) {
  const size_t smem = dkv_smem(g, QT);
  int err = set_smem(train_bwd_dkv_kernel<T, QT, kColSliced>, smem);
  if (err) return err;
  const int tiles = (g.T() + kTile - 1) / kTile;
  train_bwd_dkv_kernel<T, QT, kColSliced><<<dim3(B * tiles, g.H, col_slices(g.dk)), kThreads,
                                            smem, stream>>>(
      (const T*)q, (const T*)kv, (const T*)pos, (const T*)u, (const T*)v, lens, m, den, delta,
      (const T*)dctx, (T*)dkv, g, seed, thresh, drop_scale, use_drop, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], s[9], s[10]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, const void* ctx, const float* m, const float* den,
               const void* dctx, float* delta, void* dq, void* dkv, float* dp_part,
               float* duv_part, void* dp, void* du, void* dv, int B, Geom g, uint32_t seed,
               uint32_t thresh, float drop_scale, int use_drop, const int64_t* s,
               cudaStream_t stream) {
  auto dq_go = slices_of(g.c, g.dk) > 1 ? launch_dq<T, true> : launch_dq<T, false>;
  int err = dq_go(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq, dp_part, duv_part, B,
                  g, seed, thresh, drop_scale, use_drop, s, stream);
  if (err) return err;

  int qt = kTile;
  if ((err = dkv_query_tile(g, &qt))) return err;
  auto dkv_go = col_slices(g.dk) == 1 ? launch_dkv<T, kTile, false>
                : qt == kTile         ? launch_dkv<T, kTile, true>
                                      : launch_dkv<T, kTile / 2, true>;
  err = dkv_go(q, kv, pos, u, v, lens, m, den, delta, dctx, dkv, B, g, seed, thresh, drop_scale,
               use_drop, s, stream);
  if (err) return err;

  const int64_t outs = (int64_t)g.P() * g.H * g.dk + 2 * g.H * g.dk;
  train_bwd_reduce_kernel<T><<<(unsigned)((outs + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      dp_part, duv_part, (T*)dp, (T*)du, (T*)dv, B * g.n * slices_of(g.c, g.dk), g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Return a cudaError_t (0 = launched).
// Shapes are checked by the Python wrapper (any c; dk up to the shared memory
// a block may take, 256 and more on an H100); ctx, dctx, dq are contiguous
// [B, n*c, H, dk], m, den, delta contiguous [B, H, n*c]. dp_part holds
// B * n * slices_of(c, dk) * H slabs [P, dk] and duv_part as many [2, dk].
// Strides: q (b, t, h), kv (b, t, h), p (p, h), dkv (b, t, h). h0, Ht: the
// tensor's head h is head h0 + h of Ht in the dropout hash (0 and H on one
// process).
extern "C" int cf_chunk_train_attn_fwd(int dtype, const void* q, const void* kv,
                                       const void* pos, const void* u, const void* v,
                                       const int* lens, void* ctx, float* m, float* den,
                                       int B, int n, int H, int c, int dk, int L, int R,
                                       uint32_t seed, uint32_t thresh, float drop_scale,
                                       int use_drop, int h0, int Ht, int64_t sqb, int64_t sqt,
                                       int64_t sqh,
                                       int64_t skb, int64_t skt, int64_t skh, int64_t spp,
                                       int64_t sph, void* stream) {
  if (B == 0 || n == 0) return 0;
  const Geom g{n, H, c, dk, L, R, h0, Ht};
  const int64_t s[8] = {sqb, sqt, sqh, skb, skt, skh, spp, sph};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd<float>(q, kv, pos, u, v, lens, ctx, m, den, B, g, seed, thresh,
                             drop_scale, use_drop, s, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, kv, pos, u, v, lens, ctx, m, den, B, g, seed, thresh,
                                     drop_scale, use_drop, s, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int cf_chunk_train_attn_bwd(int dtype, const void* q, const void* kv,
                                       const void* pos, const void* u, const void* v,
                                       const int* lens, const void* ctx, const float* m,
                                       const float* den, const void* dctx, float* delta,
                                       void* dq, void* dkv, float* dp_part, float* duv_part,
                                       void* dp, void* du, void* dv, int B, int n, int H,
                                       int c, int dk, int L, int R, uint32_t seed,
                                       uint32_t thresh, float drop_scale, int use_drop, int h0,
                                       int Ht,
                                       int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
                                       int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                       int64_t sdb, int64_t sdt, int64_t sdh, void* stream) {
  if (B == 0 || n == 0) return 0;
  const Geom g{n, H, c, dk, L, R, h0, Ht};
  const int64_t s[11] = {sqb, sqt, sqh, skb, skt, skh, spp, sph, sdb, sdt, sdh};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq, dkv,
                             dp_part, duv_part, dp, du, dv, B, g, seed, thresh, drop_scale,
                             use_drop, s, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq,
                                     dkv, dp_part, duv_part, dp, du, dv, B, g, seed, thresh,
                                     drop_scale, use_drop, s, st);
  return (int)cudaErrorInvalidValue;
}
