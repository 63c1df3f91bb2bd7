// Masked-batch relative-position chunk attention for Hopper (sm_90a).
//
// Replaces the TPU kernel chunk_attention_pallas_union_hmajor
// (chunkformer_tpu/ops/pallas/chunk_attention.py:335), and with it the
// per-chunk and G-batched variants of the same function (:32, :158): this
// kernel takes any number of chunk rows N and any strides, so one kernel
// serves the row-major and the head-major contracts. It is the CUDA-core
// route: since the tensor-core kernels (chunk_attention_tc.cu for bf16,
// chunk_attention_tc_f32.cu for f32) took f32 and bf16 at head_dim 64 or
// 128 with 16-byte rows at any chunk size, it computes the other head dims
// and the rows off the 16-byte grid, and it is their yardstick in
// chip_smoke.py at every chunk size.
//
// Function, for chunk row n, head h, query row r < c, window position j < W
// (W = L + c + R), the window being KV stream rows [n*c, n*c + W):
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid(j)  iff  -offset[n] <= chunk_idx[n]*c - L + j < max_len[n]
//   out[r]    = softmax_j(s[r, j] | valid) . v[j]      (all-masked row -> 0)
// Validity depends on n and j only, so it is one interval [lo, hi) of j per
// block; key tiles outside it are skipped.
//
// What bounds it on an H100: at the ChunkFormer-large segment (N = 209,
// H = 8, c = 64, dk = 64, W = 320) one call moves about 60 MB in bf16
// (q, KV stream, out: each read or written once), about 18 us at 3.35 TB/s,
// and does about 6.6 GFLOP, about 7 us on bf16 tensor cores: it is bound by
// bytes. The TPU kernel's layout tricks (rr-major query scratch, g = 8 union
// groups, one [t1, union] score slab) exist for VMEM/MXU tiling and are not
// carried over.
//
// Design (simple and right first): one block per (row n, head h), 256
// threads. 1/sqrt(dk) is folded into the queries in f32 before the products
// (as the union kernel folds it, but without its bf16 rounding of q + u):
// qu = (q + u)/sqrt(dk) and qv = (q + v)/sqrt(dk) stay in shared memory.
// The loop walks the window in key tiles of 32 rows read straight from the
// stream (no unfold), with the 32 + c - 1 positional rows the tile's
// rel-shift needs. Scores, an online (flash-style) softmax and the context
// sum run in f32 on CUDA cores from shared memory; inputs are f32 or bf16.
// Rows of shared tiles are padded to dk + 1 floats so that lanes reading
// neighbouring rows hit different banks.
//
// Any chunk: a thread keeps at most kMaxOut = 16 outputs, so one block takes
// at most 4096 / dk query rows. A third grid axis cuts the chunk into
// slices_of(c, dk) slices of rows_per_slice(c, dk) rows; a block computes
// its slice's rows against the whole window, with the positional rows its
// own rows need. Each output is summed in the same order as with one slice,
// and the shapes that fit one block (c * dk <= 4096) run the instantiation
// kSliced = false, whose slice is the whole chunk at compile time: the
// kernel as it was before slicing, bit for bit and in time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;      // keys per tile == warp width
constexpr int kMaxOut = 16;     // outputs per thread: (rows of a slice) * dk <= 4096

// Query rows of a chunk a block takes, and the slices of a chunk: at most
// 4096 / dk rows each, as even as the count of slices allows.
__host__ __device__ inline int slices_of(int c, int dk) {
  const int most = 4096 / dk;
  return (c + most - 1) / most;
}
__host__ __device__ inline int rows_per_slice(int c, int dk) {
  const int s = slices_of(c, dk);
  return (c + s - 1) / s;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, bool kSliced>
__global__ void __launch_bounds__(kThreads)
chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                       const T* __restrict__ pos, const T* __restrict__ bias_u,
                       const T* __restrict__ bias_v,
                       const int* __restrict__ chunk_idx,
                       const int* __restrict__ offsets,
                       const int* __restrict__ max_lens, T* __restrict__ out,
                       int c, int dk, int L, int R,
                       int64_t sqn, int64_t sqr, int64_t sqh,
                       int64_t skt, int64_t skh,
                       int64_t spp, int64_t sph,
                       int64_t son, int64_t sor, int64_t soh) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int W = L + c + R;
  const int ld = dk + 1;                 // padded row length
  // this block's query rows [r0, r0 + cs) of the chunk; local row r is r0 + r
  const int cmax = kSliced ? rows_per_slice(c, dk) : c;
  const int r0 = kSliced ? (int)blockIdx.z * cmax : 0;
  const int cs = kSliced ? min(cmax, c - r0) : c;
  const int p_rows = kTileK + cs - 1;    // positional rows per key tile
  const int p0 = kSliced ? c - r0 - cs : 0;  // first positional row of the slice at j = 0

  float* qu = smem;                      // [cs][ld]
  float* qv = qu + cs * ld;              // [cs][ld]
  float* ks = qv + cs * ld;              // [kTileK][ld]
  float* vs = ks + kTileK * ld;          // [kTileK][ld]
  float* ps = vs + kTileK * ld;          // [p_rows][ld]
  float* sc = ps + p_rows * ld;          // [cs][kTileK + 1] scores, then probs
  float* row_m = sc + cs * (kTileK + 1); // [cs] running max
  float* row_l = row_m + cs;             // [cs] running sum
  float* row_a = row_l + cs;             // [cs] rescale factor of this tile

  const float scale = rsqrtf((float)dk);
  const int ci = chunk_idx[n];
  const int lo = max(0, L - ci * c - offsets[n]);
  const int hi = min(W, max_lens[n] - ci * c + L);

  const T* qb = q + (int64_t)n * sqn + (int64_t)r0 * sqr + (int64_t)h * sqh;
  for (int i = tid; i < cs * dk; i += kThreads) {
    const int r = i / dk, d = i % dk;
    const float x = to_f32(qb[(int64_t)r * sqr + d]);
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

  const T* kvb = kv + (int64_t)n * c * skt + (int64_t)h * skh;
  const T* pb = pos + (int64_t)h * sph;
  const int warp = tid / 32, lane = tid % 32;

  for (int j0 = (lo / kTileK) * kTileK; j0 < hi; j0 += kTileK) {
    __syncthreads();  // previous tile's reads of ks/vs/ps/sc are done
    for (int i = tid; i < kTileK * dk; i += kThreads) {
      const int jj = i / dk, d = i % dk;
      const int j = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (j < W) {
        const T* row = kvb + (int64_t)j * skt;
        kx = to_f32(row[d]);
        vx = to_f32(row[dk + d]);
      }
      ks[jj * ld + d] = kx;
      vs[jj * ld + d] = vx;
    }
    // positional rows [j0 + p0, j0 + p0 + kTileK + cs - 1) cover c-1-(r0+r)+j
    // for this tile and slice
    for (int i = tid; i < p_rows * dk; i += kThreads) {
      const int pr = i / dk, d = i % dk;
      const int pidx = j0 + p0 + pr;
      ps[pr * ld + d] = pidx < W + c - 1 ? to_f32(pb[(int64_t)pidx * spp + d]) : 0.f;
    }
    __syncthreads();

    // scores: one warp per query row, one lane per key
    for (int r = warp; r < cs; r += kThreads / 32) {
      const int j = j0 + lane;
      float s = -INFINITY;
      if (j >= lo && j < hi) {
        const float* a = qu + r * ld;
        const float* b = ks + lane * ld;
        const float* e = qv + r * ld;
        const float* f = ps + (cs - 1 - r + lane) * ld;
        float ac = 0.f, bd = 0.f;
        for (int d = 0; d < dk; ++d) {
          ac = fmaf(a[d], b[d], ac);
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
      sc[r * (kTileK + 1) + lane] = pr;
      if (lane == 0) {
        const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
        row_a[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
      }
    }
    __syncthreads();

    // context: thread owns outputs i = tid + k*kThreads, (r, d) = (i/dk, i%dk)
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      if (k < n_out) {
        const int i = tid + k * kThreads;
        if (i < cs * dk) {
          const int r = i / dk, d = i % dk;
          const float* prow = sc + r * (kTileK + 1);
          float a = acc[k] * row_a[r];
          for (int jj = 0; jj < kTileK; ++jj) a = fmaf(prow[jj], vs[jj * ld + d], a);
          acc[k] = a;
        }
      }
    }
  }
  __syncthreads();

  T* ob = out + (int64_t)n * son + (int64_t)r0 * sor + (int64_t)h * soh;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    if (k < n_out) {
      const int i = tid + k * kThreads;
      if (i < cs * dk) {
        const int r = i / dk, d = i % dk;
        const float l = row_l[r];
        store(ob + (int64_t)r * sor + d, l > 0.f ? acc[k] / l : 0.f);
      }
    }
  }
}

template <typename T, bool kSliced>
int launch_as(const void* q, const void* kv, const void* pos, const void* u,
           const void* v, const int* ci, const int* off, const int* ml,
           void* out, int N, int H, int c, int dk, int L, int R,
           int64_t sqn, int64_t sqr, int64_t sqh, int64_t skt, int64_t skh,
           int64_t spp, int64_t sph, int64_t son, int64_t sor, int64_t soh,
           cudaStream_t stream) {
  const int ld = dk + 1;
  const int cs = rows_per_slice(c, dk);
  const size_t smem = sizeof(float) *
      ((size_t)2 * cs * ld + 2 * kTileK * ld + (size_t)(kTileK + cs - 1) * ld +
       (size_t)cs * (kTileK + 1) + 3 * cs);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_attention_kernel<T, kSliced>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N, H, slices_of(c, dk));
  chunk_attention_kernel<T, kSliced><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kv, (const T*)pos, (const T*)u, (const T*)v, ci, off, ml,
      (T*)out, c, dk, L, R, sqn, sqr, sqh, skt, skh, spp, sph, son, sor, soh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kv, const void* pos, const void* u,
           const void* v, const int* ci, const int* off, const int* ml,
           void* out, int N, int H, int c, int dk, int L, int R,
           int64_t sqn, int64_t sqr, int64_t sqh, int64_t skt, int64_t skh,
           int64_t spp, int64_t sph, int64_t son, int64_t sor, int64_t soh,
           cudaStream_t stream) {
  auto go = slices_of(c, dk) > 1 ? launch_as<T, true> : launch_as<T, false>;
  return go(q, kv, pos, u, v, ci, off, ml, out, N, H, c, dk, L, R, sqn, sqr, sqh, skt, skh,
            spp, sph, son, sor, soh, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// Shapes and strides are checked by the Python wrapper. Any c; dk up to
// the shared memory a block may take (about 256 at f32 rows).
extern "C" int cf_chunk_attention(int dtype, const void* q, const void* kv,
                                  const void* pos, const void* u, const void* v,
                                  const int* chunk_idx, const int* offsets,
                                  const int* max_lens, void* out, int N, int H,
                                  int c, int dk, int L, int R,
                                  int64_t sqn, int64_t sqr, int64_t sqh,
                                  int64_t skt, int64_t skh, int64_t spp,
                                  int64_t sph, int64_t son, int64_t sor,
                                  int64_t soh, void* stream) {
  if (N == 0) return 0;
  if (dk < 1 || dk > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kv, pos, u, v, chunk_idx, offsets, max_lens, out, N, H, c,
                         dk, L, R, sqn, sqr, sqh, skt, skh, spp, sph, son, sor, soh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kv, pos, u, v, chunk_idx, offsets, max_lens, out, N,
                                 H, c, dk, L, R, sqn, sqr, sqh, skt, skh, spp, sph, son,
                                 sor, soh, s);
  return (int)cudaErrorInvalidValue;
}
