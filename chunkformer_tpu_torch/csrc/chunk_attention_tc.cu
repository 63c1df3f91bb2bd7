// Relative-position chunk attention for decode on Hopper tensor cores
// (sm_90a), bf16.
//
// Replaces the TPU kernel chunk_attention_pallas_union_hmajor
// (chunkformer_tpu/ops/pallas/chunk_attention.py:335), with its row-major
// wrapper (:306) and the per-chunk and G-batched variants (:32, :158), for
// bf16 inputs with head_dim 64 or 128 at any chunk size. f32 at the same
// shapes takes the 3xTF32 kernel of chunk_attention_tc_f32.cu (this file's
// C entry dispatches by dtype), and other head dims, dtypes and strides the
// CUDA-core kernel of chunk_attention.cu; ops/chunk_attention.py routes by
// dtype, shape and stride alone. The function is that of chunk_attention.cu:
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid(j)  iff  -offset[n] <= chunk_idx[n]*c - L + j < max_len[n]
//   out[r]    = softmax_j(s[r, j] | valid) . v[j]      (all-masked row -> 0)
// over the window of KV stream rows [n*c, n*c + L + c + R).
//
// What bounds it on an H100: at the ChunkFormer-large segment (N = 209,
// H = 8, c = 64, dk = 64, L = R = 128) one call must move about 55 MB (q,
// the KV stream and the output once each), 16.6 us at 3.35 TB/s; its
// products (content, position, context: 6.6 GFLOP over the valid keys) take
// about 7 us at the bf16 tensor-core peak. It is bound by bytes, and the
// CUDA-core kernel was 134x above that bound because every FMA read both
// operands from shared memory and no copy overlapped compute.
//
// Design: one block of one warpgroup (128 threads) per (chunk row n, head h,
// tile of 64 query rows), ceil(c / 64) tiles a chunk; c = 64 gives exactly
// one wgmma M of 64. The key window [lo, hi) of the block is walked in
// tiles of 64 keys.
// - Partial tiles. The last tile of a chunk whose size is not a multiple of
//   64 holds c - r0 query rows (r0 = 64 * tile; at c < 64 the only tile).
//   Its rows past the chunk load as zeros, run through the products and the
//   softmax like the others (their scores are the bias terms alone, finite),
//   and are not stored. Nothing else depends on the row count: the rel-shift
//   row of query r and key j is c - 1 - r + j whatever the tile, so the
//   positional base pb0 = lo + c - 64 - r0 below and the skew hold for a
//   partial tile too, and its rows past the chunk read positional rows below
//   0, which the copies zero-fill. The key window and the valid(j) mask do
//   not depend on the row at all. A partial tile computes 64 rows for
//   c - r0 (at c = 96, 128 rows for 96; at c = 48, 64 for 48); two chunk
//   rows cannot share a tile because their key windows differ.
// - Tensor cores. wgmma products from shared memory with bf16 inputs and f32
//   accumulators: per tile S = Q K^T (64 x 64), and the position scores
//   BD' = Q P^T over 64-row positional blocks. Key tile t needs blocks t and
//   t + 1 (the 127 rows of its rel-shift), so each block's 64 x 64 product is
//   computed once, by the tile before the one that first needs it, and kept
//   in one of two f32 staging slots. The bias terms use the split form
//   (q + u).k = q.k + u.k and (q + v).p = q.p + v.p, so one bare bf16 Q tile
//   serves both products and u, v never round to bf16 sums; u.k_j and v.p_m
//   are f32 dot products, one per key and per positional row, computed while
//   the products run.
// - Rel-shift. The staged BD' (+ v.p) is read skewed across the two slots:
//   S_bd[r, j] = BD'[r, 63 - r + j].
// - Online softmax in the accumulator registers (exp2, f32 row max and sum);
//   the probabilities become bf16 A fragments in registers for O += P V,
//   whose B operand is the V tile as it was loaded (MN-major, transposed).
// - Asynchronous copies. Tiles arrive by cp.async (16 bytes a thread, zero
//   fill past the window) in commit groups, double-buffered: tile t + 1's K
//   and V and positional block t + 2 load while tile t computes. cp.async
//   rather than TMA: it takes the row-major and head-major layouts by
//   strides, with no per-call tensor maps and no driver entry point.
// - Shared tiles are [64 rows][64 bf16] sub-tiles of 128-byte rows in the
//   128-byte swizzle that wgmma's descriptors name (16-byte chunk index XOR
//   row % 8), so the copies and the tensor cores meet no bank conflicts.
// Shared memory: 94 KB a block at dk = 64 (two blocks an SM), 150 KB at 128.
// The PTX helpers, tile copies and staging are in hopper_tc.cuh, shared with
// the training kernels of chunk_attention_train_tc.cu.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): about 0.11 ms
// at the shape above, 6.6x its byte bound and 20x faster than the CUDA-core
// kernel. Computing each positional product once instead of twice cut a
// quarter of the products and barely moved the time, so what holds it is
// latency (two warpgroups an SM, three block-wide barriers a key tile) and
// the tiles each block reloads through L2 (about 230 MB a call against the
// 55 MB of distinct bytes), not the tensor cores.

#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup

template <int DK>
struct Smem {
  static constexpr int kTile = 64 * DK * 2;  // bytes of a [64][DK] bf16 tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;      // 2 stages
  static constexpr int kV = kK + 2 * kTile;  // 2 stages
  static constexpr int kP = kV + 2 * kTile;  // 2 positional blocks
  static constexpr int kStg = kP + 2 * kTile;                       // f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;            // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                          // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                          // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                          // f32 v.p [64]
  static constexpr int kBytes = kVp + 64 * 4 + 1024;                // + 1024-byte alignment
};

// ---------------------------------------------------------------- kernel

template <int DK>
__global__ void __launch_bounds__(kThreads)
chunk_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                          const bf16* __restrict__ pos, const bf16* __restrict__ bias_u,
                          const bf16* __restrict__ bias_v,
                          const int* __restrict__ chunk_idx, const int* __restrict__ offsets,
                          const int* __restrict__ max_lens, bf16* __restrict__ out,
                          int c, int L, int R,
                          int64_t sqn, int64_t sqr, int64_t sqh,
                          int64_t skt, int64_t skh,
                          int64_t spp, int64_t sph,
                          int64_t son, int64_t sor, int64_t soh) {
  using S = Smem<DK>;
  constexpr int kTile = S::kTile;
  constexpr int kSlot = 64 * kStage;  // floats of a staging slot
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem + S::kQ;
  uint8_t* sK = smem + S::kK;
  uint8_t* sV = smem + S::kV;
  uint8_t* sP = smem + S::kP;
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);

  const int n = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * 64;
  const int rows = min(64, c - r0);  // query rows of this tile in the chunk
  const int tid = threadIdx.x;
  const int W = L + c + R;
  const int p_rows = 2 * c - 1 + L + R;
  const int ci = chunk_idx[n];
  const int lo = max(0, L - ci * c - offsets[n]);
  const int hi = min(W, max_lens[n] - ci * c + L);
  // accumulator layout: this thread holds rows ra and ra + 8 of the 64, at
  // columns 8i + cb and 8i + cb + 1 of every 8-column group i
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  bf16* ob = out + n * son + h * soh + static_cast<int64_t>(r0) * sor;

  if (hi <= lo) {  // no valid key: the rows are 0
    for (int i = tid; i < rows * DK / 2; i += kThreads) {
      const int r = i / (DK / 2), d = 2 * (i % (DK / 2));
      *reinterpret_cast<__nv_bfloat162*>(ob + r * sor + d) = __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }
  const int n_tiles = (hi - lo + 63) / 64;
  // positional block b holds rows [pb0 + 64b, pb0 + 64b + 64); key tile t
  // needs blocks t and t + 1, and S_bd[r, j] = BD'[r, 63 - r + j] over them
  // (in a partial tile pb0 may be negative: those rows zero-fill)
  const int pb0 = lo + c - 64 - r0;

  const bf16* qb = q + n * sqn + h * sqh + static_cast<int64_t>(r0) * sqr;
  const bf16* kb = kv + static_cast<int64_t>(n) * c * skt + h * skh;
  const bf16* pb = pos + h * sph;

  for (int d = tid; d < DK; d += kThreads) {
    uf[d] = __bfloat162float(bias_u[h * DK + d]);
    vf[d] = __bfloat162float(bias_v[h * DK + d]);
  }
  // prologue: Q (rows past the chunk zero-filled), tile 0's K and V,
  // positional blocks 0 and 1
  load_tile<DK>(smem_u32(sQ), qb, sqr, 0, rows, tid);
  load_tile<DK>(smem_u32(sK), kb, skt, lo, W, tid);
  load_tile<DK>(smem_u32(sV), kb + DK, skt, lo, W, tid);
  load_tile<DK>(smem_u32(sP), pb, spp, pb0, p_rows, tid);
  load_tile<DK>(smem_u32(sP + kTile), pb, spp, pb0 + 64, p_rows, tid);
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_addr = smem_u32(sQ);
  float b[32];
  // block 0's product into staging slot 0; each later block's is computed
  // once, by the tile before the one that first needs it
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    wgmma_ss_n64(b, desc_kmajor(q_addr, kk), desc_kmajor(smem_u32(sP), kk), kk > 0);
  wgmma_commit();
  if (tid >= 64) vp[tid - 64] = dot_row<DK>(sP, tid - 64, vf);
  __syncthreads();
  wgmma_wait_all();
  fence_regs(b);
  stage_block(b, stg, vp, ra, cb);

  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = 1.4426950408889634f * rsqrtf(static_cast<float>(DK));

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + 64 * t;
    cp_async_wait_all();  // tile t and block t + 1 have landed
    fence_async_smem();
    __syncthreads();      // ... for every thread; tile t - 1's buffers are free
    if (t + 1 < n_tiles) {
      const int st = (t + 1) & 1;
      load_tile<DK>(smem_u32(sK + st * kTile), kb, skt, j0 + 64, W, tid);
      load_tile<DK>(smem_u32(sV + st * kTile), kb + DK, skt, j0 + 64, W, tid);
      load_tile<DK>(smem_u32(sP + (t & 1) * kTile), pb, spp, pb0 + 64 * (t + 2), p_rows, tid);
    }
    cp_async_commit();

    const uint8_t* tK = sK + (t & 1) * kTile;
    const uint8_t* tV = sV + (t & 1) * kTile;
    const uint8_t* tP = sP + ((t + 1) & 1) * kTile;  // block t + 1

    float s[32];
    fence_regs(s);
    fence_regs(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint64_t da = desc_kmajor(q_addr, kk);
      wgmma_ss_n64(s, da, desc_kmajor(smem_u32(tK), kk), kk > 0);
      wgmma_ss_n64(b, da, desc_kmajor(smem_u32(tP), kk), kk > 0);
    }
    wgmma_commit();

    // while the products run: u.k for the tile's keys (warps 0-1) and v.p
    // for block t + 1 (warps 2-3)
    if (tid < 64)
      uk[tid] = dot_row<DK>(tK, tid, uf);
    else
      vp[tid - 64] = dot_row<DK>(tP, tid - 64, vf);
    __syncthreads();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(b);
    stage_block(b, stg + ((t + 1) & 1) * kSlot, vp, ra, cb);
    __syncthreads();

    // scores, the online softmax over the tile and o's rescale; s now holds
    // the tile's unnormalised probabilities
    softmax_tile<DK>(s, o, m_run, l_run, stg + (t & 1) * kSlot, stg + ((t + 1) & 1) * kSlot,
                     uk, ra, cb, j0, hi, scale_log2);

    // P (bf16, registers) times V: k-step kk takes keys [16kk, 16kk + 16)
    uint32_t a[4][4];
    acc_to_a(s, a);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(o, a[kk], desc_mnmajor(smem_u32(tV), kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float l = l_run[x];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[x] = l > 0.f ? 1.f / l : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (ra + 8 * x < rows)  // rows past the chunk are not stored
        *reinterpret_cast<__nv_bfloat162*>(ob + (ra + 8 * x) * sor + 8 * i + cb) =
            __floats2bfloat162_rn(o[4 * i + 2 * x] * inv[x], o[4 * i + 2 * x + 1] * inv[x]);
    }
  }
}

template <int DK>
int launch(const void* q, const void* kv, const void* pos, const void* u, const void* v,
           const int* ci, const int* off, const int* ml, void* out, int N, int H, int c,
           int L, int R, int64_t sqn, int64_t sqr, int64_t sqh, int64_t skt, int64_t skh,
           int64_t spp, int64_t sph, int64_t son, int64_t sor, int64_t soh,
           cudaStream_t stream) {
  const int smem = Smem<DK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(chunk_attention_tc_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N, H, (c + 63) / 64);  // the last tile of a chunk may be partial
  chunk_attention_tc_kernel<DK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const bf16*>(pos), static_cast<const bf16*>(u),
      static_cast<const bf16*>(v), ci, off, ml, static_cast<bf16*>(out), c, L, R, sqn, sqr,
      sqh, skt, skh, spp, sph, son, sor, soh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 kernel's entry (chunk_attention_tc_f32.cu).
extern "C" int cf_chunk_attention_tc_f32(const void* q, const void* kv, const void* pos,
                                         const void* u, const void* v, const int* chunk_idx,
                                         const int* offsets, const int* max_lens, void* out,
                                         int N, int H, int c, int dk, int L, int R,
                                         int64_t sqn, int64_t sqr, int64_t sqh,
                                         int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                         int64_t son, int64_t sor, int64_t soh, void* stream);

// dtype: 0 = float32 (the 3xTF32 kernel of chunk_attention_tc_f32.cu), 1 =
// bfloat16 (this file's kernel); dk 64 or 128; any c >= 1; every row
// 16-byte aligned (checked by the Python wrapper). Returns a cudaError_t
// (0 = launched).
extern "C" int cf_chunk_attention_tc(int dtype, const void* q, const void* kv, const void* pos,
                                     const void* u, const void* v, const int* chunk_idx,
                                     const int* offsets, const int* max_lens, void* out,
                                     int N, int H, int c, int dk, int L, int R,
                                     int64_t sqn, int64_t sqr, int64_t sqh,
                                     int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                     int64_t son, int64_t sor, int64_t soh, void* stream) {
  if (dtype == 0)
    return cf_chunk_attention_tc_f32(q, kv, pos, u, v, chunk_idx, offsets, max_lens, out, N, H,
                                     c, dk, L, R, sqn, sqr, sqh, skt, skh, spp, sph, son, sor,
                                     soh, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == 64)
    return launch<64>(q, kv, pos, u, v, chunk_idx, offsets, max_lens, out, N, H, c, L, R,
                      sqn, sqr, sqh, skt, skh, spp, sph, son, sor, soh, s);
  if (dk == 128)
    return launch<128>(q, kv, pos, u, v, chunk_idx, offsets, max_lens, out, N, H, c, L, R,
                       sqn, sqr, sqh, skt, skh, spp, sph, son, sor, soh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
