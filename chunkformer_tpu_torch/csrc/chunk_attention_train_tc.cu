// Limited-context training attention on Hopper tensor cores (sm_90a), bf16:
// forward and backward.
//
// Replaces, for bf16 with head_dim 64 or 128 at any chunk size, the TPU
// kernels of chunkformer_tpu/ops/pallas/chunk_attention_train.py:
// the forward _attn_fwd_call (:316; its pallas_call at :359, kernel
// _fwd_kernel :78) and the backward _attn_core_bwd (:390; its pallas_call at
// :448, kernel _bwd_kernel :161, overlap-add :469-482). f32 at these shapes
// goes to chunk_attention_train_tc_f32.cu (this file's C entries dispatch it
// there), other shapes to the CUDA-core kernels of chunk_attention_train.cu;
// ops/chunk_attention_train.py routes by dtype, shape and stride alone. The
// function is that of chunk_attention_train.cu: for utterance b, chunk ci,
// head h, query row r and window position j < W = L + c + R (stream row
// ci*c + j, key frame f = ci*c - L + j),
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid   iff 0 <= f < len[b] and ci*c + r < len[b]
//   ctx[r]  = sum_j keep(r, j) / (1 - p_drop) * softmax_j(s[r, j] | valid) v[j]
// with m = max(row max, -1e29) and den = max(row sum, 1e-30) per query row.
//
// What bounds them on an H100: at the flagship train shape (B = 32, n = 4,
// c = 64, H = 8, dk = 64, L = R = 128, 199 frames) the forward must read the
// query rows and key stream rows of the 199 valid frames (the pad rows and
// the frames past the length enter no valid window) and write ctx, m and den
// whole: about 29 MB (8.6 us at 3.35 TB/s) for 3.8 GFLOP of products (3.8 us
// at the bf16 tensor-core peak); the backward about 76 MB (22.6 us) for
// 10.1 GFLOP (10.3 us): bytes bound both. The CUDA-core kernels are about
// 116x and 121x above those bounds: every FMA reads both operands from shared
// memory, nothing overlaps the copies, the backward rebuilds the scores in
// two kernels on CUDA cores and moves 100 MB of f32 dP partials.
//
// Design (the decode kernel's, chunk_attention_tc.cu, with (b, ci) where
// decode has the chunk row n; the PTX helpers are in hopper_tc.cuh):
// - One warpgroup (128 threads) per 64 query rows, ceil(c / 64) blocks a
//   chunk; c = 64 is one wgmma M. Key intervals [lo, hi) come from lens[b];
//   a query row at or past lens[b] has none and gets ctx 0, m = -1e29,
//   den = 1e-30.
// - Partial blocks (as the decode kernel's partial tiles,
//   chunk_attention_tc.cu). The last 64-row block of a chunk that 64 does
//   not divide holds crows = c - r0 rows. Its rows past the chunk load as
//   zeros (load_tile's row bound: they are the next chunk's rows, or past
//   the tensor), take no valid key (masked like rows past lens[b]), so
//   their weights and dS are 0, and are never stored: no ctx, m, den,
//   delta or dq row, and, being zero, nothing into the dP slab, the band's
//   column sums, dK or dV. The rel-shift row of query r and key j is c - 1
//   - r + j whatever the block, so the positional base pb0 = lo + c - 64 -
//   r0 and the skew hold; a partial block's rows past the chunk read
//   positional rows below 0, which the copies zero-fill and the dP slab
//   update skips. The dK/dV kernel takes ceil(T / 64) key blocks (T = n c);
//   the last holds T - f0 frames, its rows past T load as zeros and are not
//   stored. At c = 96 a chunk computes 128 query rows for 96.
// - Scores: S = Q K^T and the positional blocks BD = Q P^T by wgmma (bf16
//   in, f32 accumulators), with the split bias form (q + u).k = q.k + u.k,
//   (q + v).p = q.p + v.p (u.k and v.p are f32 dot products). Each 64-row
//   positional block is computed once and staged in f32 shared memory, then
//   read skewed for the rel-shift: S_bd[r, j] = BD[r, 63 - r + j] over two
//   consecutive blocks.
// - Dropout: keep iff a counter-based hash of (seed, b, h, query frame, key
//   stream row) >= threshold, per accumulator element from absolute
//   positions, so its bits equal the CUDA-core kernels' and the plain
//   version's (window_keep_mask).
// - Tiles arrive by cp.async (16 bytes a thread, zero fill outside the
//   operand), double-buffered: the next key tile and positional block load
//   while the current tile computes.
//
// Forward (train_fwd_tc_kernel), per (b, ci, h, 64 query rows): online
// softmax in registers (exp2, f32 row max and sum); the probabilities, times
// the keep mask, become bf16 A fragments for O += P V (V as it landed:
// MN-major); it writes ctx and the final (m, den).
//
// Backward, FlashAttention-2 style, deterministic (no floating-point
// atomics: every sum has one owner and a fixed order), in four kernels:
// (a) train_bwd_dq_tc_kernel, one block per (group of G utterances, h),
//     walking each utterance's chunks and 64-row query blocks in order and
//     their key tiles twice: a first pass recomputes S from (m, den) and
//     dA = dctx V^T on the tensor cores, times keep / (1 - p), for
//     delta = rowsum(A dA) in f32 (as the TPU kernel; rowsum(dctx * ctx) of
//     the bf16 ctx is off by ctx's rounding, which dominates dS where
//     attention is flat); the second recomputes them for
//     dS = A (dA - delta), kept in f32 registers. dq = dS K + unshift(dS) P:
//     dS K from registers (bf16 A fragments); unshift(dS) is written skewed
//     in f32 into a [64][128] band over the two positional blocks of the
//     tile (columns 63 - r + j), rounded to a swizzled bf16 copy and
//     multiplied by them. dP = unshift(dS)^T (q + v): band^T Q on the tensor
//     cores, added into the group's f32 slab [P][dk] in device memory, which
//     only this block touches, between block-wide barriers, with the band's
//     f32 column sums (its v term, and dv's) into a slab [P] beside it. G is
//     chosen by the wrapper so the slabs stay small (12.5 MB at the flagship
//     shape, against 100 MB of per-(b, ci) partials on the CUDA cores).
//     Where G is 1 and the budget holds more slabs than utterances (a small
//     batch), an utterance's chunks are cut into up to n ranges, a block and
//     a slab each (ops/chunk_attention_train.py dp_splits), so that more of
//     the card's SMs run this latency-bound kernel.
// (b) train_bwd_dkv_tc_kernel, one block per (b, 64 key frames, h): for every
//     query chunk and 64-row block whose window covers those keys, recompute
//     S (two positional blocks) and dA, then dV += A_drop^T dctx and
//     dK += dS^T Q on the tensor cores (A_drop and dS through shared memory
//     as MN-major A operands), and the f32 column sums of dS: the u term of
//     dK and, against the block's keys, a du partial. Only real frames get a
//     gradient; the L and R pad rows stay 0.
// (c) train_bwd_dp_tc_kernel: dp = (sum of the slabs + (sum of the column
//     sums) v) / sqrt(dk); (d) train_bwd_duv_tc_kernel: du and dv, the f32
//     sums of their partials.
// The key, value and per-step tiles of (a) and (b) are single-buffered, so
// two blocks fit an SM (one block's copies overlap the other's products)
// where the grid has enough blocks.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, flagship shape,
// p = 0): forward about 0.06 ms (7x its byte bound, 15x faster than the
// CUDA-core kernel); backward about 0.40 ms (18x its byte bound, 7x faster
// than the CUDA-core kernels), of which (a) 0.23 ms, (b) 0.12 ms. What holds
// (a) is latency: 128 blocks, one warpgroup an SM, and per tile seven
// products, five block-wide barriers and the read-modify-write of the slab
// rows; the 25 MB budget of partials caps its blocks at H x B / 2.

#include "chunk_attention_train_tc.cuh"
#include "hopper_tc.cuh"

namespace {

constexpr int kThreads = 128;  // one warpgroup

// ---------------------------------------------------------------- forward

template <int DK>
struct FwdSmem {
  static constexpr int kTile = 64 * DK * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;      // 2 stages
  static constexpr int kV = kK + 2 * kTile;  // 2 stages
  static constexpr int kP = kV + 2 * kTile;  // 2 positional blocks
  static constexpr int kStg = kP + 2 * kTile;             // f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                // f32 v.p [64]
  static constexpr int kBytes = kVp + 64 * 4 + 1024;      // + 1024-byte alignment
};

template <int DK>
__global__ void __launch_bounds__(kThreads)
train_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                    const bf16* __restrict__ pos, const bf16* __restrict__ bias_u,
                    const bf16* __restrict__ bias_v, const int* __restrict__ lens,
                    bf16* __restrict__ ctx, float* __restrict__ m_out,
                    float* __restrict__ den_out, Geom g, Drop drop,
                    int64_t sqb, int64_t sqt, int64_t sqh,
                    int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  using S = FwdSmem<DK>;
  constexpr int kTile = S::kTile;
  constexpr int kSlot = 64 * kStage;
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

  const int b = blockIdx.x / g.n, ci = blockIdx.x % g.n, h = blockIdx.y;
  const int r0 = blockIdx.z * 64;
  const int tid = threadIdx.x, c = g.c, H = g.H;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int len = lens[b];
  const int lo = max(0, g.L - ci * c);
  const int hi = min(W, len - ci * c + g.L);
  const int crows = min(64, c - r0);                // query rows of the block in the chunk
  const int rows = min(crows, len - ci * c - r0);   // valid query rows of the block
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;  // first frame of the block
  bf16* ob = ctx + (t0 * H + h) * DK;
  const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0;

  if (hi <= lo || rows <= 0) {  // no valid (query, key) pair: ctx 0, empty statistics
    for (int i = tid; i < crows * DK / 2; i += kThreads) {
      const int r = i / (DK / 2), d = 2 * (i % (DK / 2));
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(r) * H * DK + d) =
          __floats2bfloat162_rn(0.f, 0.f);
    }
    if (tid < crows) {
      m_out[so + tid] = -1e29f;
      den_out[so + tid] = 1e-30f;
    }
    return;
  }
  const int n_tiles = (hi - lo + 63) / 64;
  const int pb0 = lo + c - 64 - r0;  // positional block t: rows [pb0 + 64t, pb0 + 64t + 64)

  const bf16* qb = q + b * sqb + static_cast<int64_t>(ci * c + r0) * sqt + h * sqh;
  const bf16* kb = kv + b * skb + static_cast<int64_t>(ci) * c * skt + h * skh;
  const bf16* pb = pos + h * sph;

  for (int d = tid; d < DK; d += kThreads) {
    uf[d] = __bfloat162float(bias_u[h * DK + d]);
    vf[d] = __bfloat162float(bias_v[h * DK + d]);
  }
  load_tile<DK>(smem_u32(sQ), qb, sqt, 0, crows, tid);  // rows past the chunk: zeros
  load_tile<DK>(smem_u32(sK), kb, skt, lo, W, tid);
  load_tile<DK>(smem_u32(sV), kb + DK, skt, lo, W, tid);
  load_tile<DK>(smem_u32(sP), pb, spp, pb0, p_rows, tid);
  load_tile<DK>(smem_u32(sP + kTile), pb, spp, pb0 + 64, p_rows, tid);
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  const uint32_t q_addr = smem_u32(sQ);
  {  // block 0's product into staging slot 0
    float b0[32];
    fence_regs(b0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(b0, desc_kmajor(q_addr, kk), desc_kmajor(smem_u32(sP), kk), kk > 0);
    wgmma_commit();
    if (tid >= 64) vp[tid - 64] = dot_row<DK>(sP, tid - 64, vf);
    __syncthreads();
    wgmma_wait_all();
    fence_regs(b0);
    stage_block(b0, stg, vp, ra, cb);
  }

  bool row_ok[2];
  uint32_t row_hash[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    row_ok[x] = ra + 8 * x < rows;
    row_hash[x] = drop_row(drop, b, h, ci * c + r0 + ra + 8 * x);
  }
  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = kLog2e * rsqrtf(static_cast<float>(DK));

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = lo + 64 * t;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
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

    float s[32], bacc[32];
    fence_regs(s);
    fence_regs(bacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint64_t da = desc_kmajor(q_addr, kk);
      wgmma_ss_n64(s, da, desc_kmajor(smem_u32(tK), kk), kk > 0);
      wgmma_ss_n64(bacc, da, desc_kmajor(smem_u32(tP), kk), kk > 0);
    }
    wgmma_commit();
    if (tid < 64)
      uk[tid] = dot_row<DK>(tK, tid, uf);
    else
      vp[tid - 64] = dot_row<DK>(tP, tid - 64, vf);
    __syncthreads();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(bacc);
    stage_block(bacc, stg + ((t + 1) & 1) * kSlot, vp, ra, cb);
    __syncthreads();

    // scores in the log2 domain; s[4i + 2x + e] is row ra + 8x, column 8i + cb + e
    const int slot_lo = (t & 1) * kSlot, slot_hi = ((t + 1) & 1) * kSlot;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 ukj = *reinterpret_cast<const float2*>(uk + 8 * i + cb);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 8 * i + cb + e;
        const bool key_ok = j0 + jj < hi;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int rr = ra + 8 * x;
          const int idx = 63 - rr + jj;
          const float bd = stg[(idx < 64 ? slot_lo : slot_hi) + rr * kStage + (idx & 63)];
          const float v = (s[4 * i + 2 * x + e] + (e ? ukj.y : ukj.x) + bd) * scale_log2;
          s[4 * i + 2 * x + e] = key_ok && row_ok[x] ? v : -INFINITY;
          mx[x] = fmaxf(mx[x], s[4 * i + 2 * x + e]);
        }
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m_run[x], mx[x]);
      m_use[x] = m_new == -INFINITY ? 0.f : m_new;  // a row with no valid key yet
      alpha[x] = exp2f(m_run[x] - m_use[x]);
      m_run[x] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pr = exp2f(s[4 * i + 2 * x + e] - m_use[x]);
          ls[x] += pr;
          if (drop.on) {
            const uint32_t fk = static_cast<uint32_t>(ci * c + j0 + 8 * i + cb + e);
            pr = mix32(row_hash[x] ^ fk) >= drop.thresh ? pr * drop.scale : 0.f;
          }
          s[4 * i + 2 * x + e] = pr;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l_run[x] = l_run[x] * alpha[x] + ls[x];
#pragma unroll
    for (int i = 0; i < DK / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
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
    if ((lane & 3) == 0 && ra + 8 * x < crows) {
      const int rr = ra + 8 * x;
      m_out[so + rr] = l > 0.f ? fmaxf(m_run[x] * kLn2, -1e29f) : -1e29f;
      den_out[so + rr] = fmaxf(l, 1e-30f);
    }
  }
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (ra + 8 * x < crows)  // rows past the chunk are not stored
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<int64_t>(ra + 8 * x) * H * DK +
                                           8 * i + cb) =
            __floats2bfloat162_rn(o[4 * i + 2 * x] * inv[x], o[4 * i + 2 * x + 1] * inv[x]);
    }
  }
}

// ------------------------------------------------------- backward (a): dq

constexpr int kFb = 132;  // f32 row stride of the skewed band (16-byte rows, 4 mod 32)

template <int DK>
struct DqSmem {
  static constexpr int kTile = 64 * DK * 2;
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kTile;      // dctx
  static constexpr int kK = kG + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kP = kV + kTile;      // ring of 3 positional blocks
  static constexpr int kBand = kP + 3 * kTile;            // bf16 [64][128] unshift(dS)
  static constexpr int kFband = kBand + 2 * 8192;         // f32 [64][kFb] unshift(dS)
  static constexpr int kStg = kFband + 64 * kFb * 4;      // f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                // f32 v.p [64]
  static constexpr int kCsp = kVp + 64 * 4;               // f32 band column sums [128]
  static constexpr int kRow = kCsp + 128 * 4;             // f32 [2][64]: m log2e, 1/den
  static constexpr int kBytes = kRow + 2 * 64 * 4 + 1024;
};

template <int DK>
__global__ void __launch_bounds__(kThreads)
train_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                       const bf16* __restrict__ pos, const bf16* __restrict__ bias_u,
                       const bf16* __restrict__ bias_v, const int* __restrict__ lens,
                       const float* __restrict__ m_in, const float* __restrict__ den_in,
                       const bf16* __restrict__ dctx, float* __restrict__ delta_out, bf16* __restrict__ dq,
                       float* __restrict__ dp_part, float* __restrict__ cs_part, int B,
                       int group, int splits, Geom g, Drop drop, int64_t sqb, int64_t sqt,
                       int64_t sqh,
                       int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  using S = DqSmem<DK>;
  constexpr int kTile = S::kTile;
  constexpr int kSlot = 64 * kStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem + S::kK;
  uint8_t* sV = smem + S::kV;
  uint8_t* sP = smem + S::kP;
  uint8_t* sBand = smem + S::kBand;
  float* fband = reinterpret_cast<float*>(smem + S::kFband);
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);
  float* csp = reinterpret_cast<float*>(smem + S::kCsp);
  float* row_m = reinterpret_cast<float*>(smem + S::kRow);
  float* row_inv = row_m + 64;

  // cell: utterances [grp * group, + group), chunks [ci0, ci1) of them
  const int cell = blockIdx.x, grp = cell / splits, part = cell % splits, h = blockIdx.y;
  const int ci0 = part * g.n / splits, ci1 = (part + 1) * g.n / splits;
  const int tid = threadIdx.x, c = g.c, H = g.H;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(DK));
  const float scale_log2 = kLog2e * scale;
  float* slab = dp_part + (static_cast<int64_t>(cell) * H + h) * p_rows * DK;
  float* cs_slab = cs_part + (static_cast<int64_t>(cell) * H + h) * p_rows;
  const bf16* pb = pos + h * sph;
  const uint32_t q_addr = smem_u32(smem + S::kQ), g_addr = smem_u32(smem + S::kG);
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV), band_addr = smem_u32(sBand);

  for (int d = tid; d < DK; d += kThreads) {
    uf[d] = __bfloat162float(bias_u[h * DK + d]);
    vf[d] = __bfloat162float(bias_v[h * DK + d]);
  }
  // every tile writes the same band positions (row r, columns 63 - r + j):
  // the rest stays 0
  for (int i = tid; i < 64 * kFb; i += kThreads) fband[i] = 0.f;

  const int b_end = min(B, (grp + 1) * group);
  for (int b = grp * group; b < b_end; ++b) {
    const int len = lens[b];
    const bf16* kvb = kv + b * skb + h * skh;
    for (int ci = ci0; ci < ci1; ++ci) {
      const int lo = max(0, g.L - ci * c);
      const int hi = min(W, len - ci * c + g.L);
      const bf16* kb = kvb + static_cast<int64_t>(ci) * c * skt;
      for (int r0 = 0; r0 < c; r0 += 64) {
        const int crows = min(64, c - r0);               // query rows of the block in the chunk
        const int rows = min(crows, len - ci * c - r0);  // valid ones
        const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;
        const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0;
        bf16* dqb = dq + (t0 * H + h) * DK;
        __syncthreads();  // the previous block's shared tiles are free
        const bool empty = hi <= lo || rows <= 0;
        const int n_tiles = (hi - lo + 63) / 64;
        const int pb0 = lo + c - 64 - r0;  // negative in a partial block: zero-filled rows
        if (tid < 64) {  // rows past the chunk: finite stand-ins, never used (no valid key)
          row_m[tid] = tid < crows ? m_in[so + tid] * kLog2e : 0.f;
          row_inv[tid] = tid < crows ? 1.f / den_in[so + tid] : 0.f;
        }
        if (empty) {  // no valid pair: delta and dq rows 0
          if (tid < crows) delta_out[so + tid] = 0.f;
          for (int i = tid; i < crows * DK / 2; i += kThreads) {
            const int r = i / (DK / 2), d = 2 * (i % (DK / 2));
            *reinterpret_cast<__nv_bfloat162*>(dqb + static_cast<int64_t>(r) * H * DK + d) =
                __floats2bfloat162_rn(0.f, 0.f);
          }
          continue;
        }
        // Q and dctx rows past the chunk load as zeros
        load_tile<DK>(q_addr, q + b * sqb + (ci * c + r0) * sqt + h * sqh, sqt, 0, crows, tid);
        load_tile<DK>(g_addr, dctx + (t0 * H + h) * DK, static_cast<int64_t>(H) * DK, 0, crows,
                      tid);
        // the first key tile and positional blocks 0, 1 into ring slots 0, 1
        auto load_first = [&]() {
          load_tile<DK>(k_addr, kb, skt, lo, W, tid);
          load_tile<DK>(v_addr, kb + DK, skt, lo, W, tid);
          load_tile<DK>(smem_u32(sP), pb, spp, pb0, p_rows, tid);
          load_tile<DK>(smem_u32(sP + kTile), pb, spp, pb0 + 64, p_rows, tid);
        };
        // waits for the copies, then BD of positional block 0 into stage slot 0
        auto stage_first = [&]() {
          cp_async_commit();
          cp_async_wait_all();
          fence_async_smem();
          __syncthreads();
          float b0[32];
          fence_regs(b0);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss_n64(b0, desc_kmajor(q_addr, kk), desc_kmajor(smem_u32(sP), kk), kk > 0);
          wgmma_commit();
          if (tid >= 64) vp[tid - 64] = dot_row<DK>(sP, tid - 64, vf);
          __syncthreads();
          wgmma_wait_all();
          fence_regs(b0);
          stage_block(b0, stg, vp, ra, cb);
        };
        load_first();
        stage_first();

        bool row_ok[2];
        uint32_t row_hash[2];
        float rm[2], rinv[2], rdelta[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int rr = ra + 8 * x;
          row_ok[x] = rr < rows;
          row_hash[x] = drop_row(drop, b, h, ci * c + r0 + rr);
          rm[x] = row_m[rr];
          rinv[x] = row_inv[rr];
        }

        // S = q K^T, BD = q P^T of positional block t + 1 and dA = dctx V^T of
        // the key tile on the tensor cores, with u.k and v.p beside them
        auto tile_products = [&](const uint8_t* tP1, float(&s)[32], float(&da)[32],
                                 float(&bacc)[32]) {
          fence_regs(s);
          fence_regs(bacc);
          fence_regs(da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk) {
            const uint64_t dqd = desc_kmajor(q_addr, kk);
            wgmma_ss_n64(s, dqd, desc_kmajor(k_addr, kk), kk > 0);
            wgmma_ss_n64(bacc, dqd, desc_kmajor(smem_u32(tP1), kk), kk > 0);
            wgmma_ss_n64(da, desc_kmajor(g_addr, kk), desc_kmajor(v_addr, kk), kk > 0);
          }
          wgmma_commit();
          if (tid < 64)
            uk[tid] = dot_row<DK>(sK, tid, uf);
          else
            vp[tid - 64] = dot_row<DK>(tP1, tid - 64, vf);
          __syncthreads();
          wgmma_wait_all();
          fence_regs(s);
          fence_regs(bacc);
          fence_regs(da);
        };
        // each fragment's A (s + u.k + the staged rel-shifted BD, the key and
        // row masks, exp2 with m and 1/den) and dA (after the keep mask) of
        // key tile t in f32, handed to f(k, x, att, dav): the one definition
        // that the delta pre-pass and the dS pass share
        auto for_each_weight = [&](int t, const float(&s)[32], const float(&da)[32], auto&& f) {
          const int j0 = lo + 64 * t;
          const float* slot_lo = stg + (t & 1) * kSlot;
          const float* slot_hi = stg + ((t + 1) & 1) * kSlot;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float2 ukj = *reinterpret_cast<const float2*>(uk + 8 * i + cb);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int jj = 8 * i + cb + e;
              const bool key_ok = j0 + jj < hi;
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                const int rr = ra + 8 * x, k = 4 * i + 2 * x + e;
                const int idx = 63 - rr + jj;
                const float bd = (idx < 64 ? slot_lo : slot_hi)[rr * kStage + (idx & 63)];
                const float sc = (s[k] + (e ? ukj.y : ukj.x) + bd) * scale_log2;
                const float att = key_ok && row_ok[x] ? exp2f(sc - rm[x]) * rinv[x] : 0.f;
                float dav = da[k];
                if (drop.on) {
                  const uint32_t fk = static_cast<uint32_t>(ci * c + j0 + jj);
                  dav = mix32(row_hash[x] ^ fk) >= drop.thresh ? dav * drop.scale : 0.f;
                }
                f(k, x, att, dav);
              }
            }
          }
        };

        // delta = rowsum(A dA) in f32 (dA after the keep mask), from the same
        // scores and dA as the pass below, as the TPU kernel and the plain
        // version take it: a pre-pass over the key tiles. (rowsum(dctx ctx)
        // of the bf16 ctx is off by the rounding of ctx, which dominates dS
        // where attention is flat.)
        float dsum[2] = {0.f, 0.f};
        for (int t = 0; t < n_tiles; ++t) {
          const int j0 = lo + 64 * t;
          cp_async_wait_all();  // K, V of tile t and positional block t + 1 have landed
          fence_async_smem();
          __syncthreads();
          const uint8_t* tP1 = sP + ((t + 1) % 3) * kTile;
          float s[32], da[32], bacc[32];
          tile_products(tP1, s, da, bacc);
          if (t + 1 < n_tiles) {
            load_tile<DK>(k_addr, kb, skt, j0 + 64, W, tid);
            load_tile<DK>(v_addr, kb + DK, skt, j0 + 64, W, tid);
            load_tile<DK>(smem_u32(sP + ((t + 2) % 3) * kTile), pb, spp, pb0 + 64 * (t + 2),
                          p_rows, tid);
          } else {
            load_first();  // the pass below starts over
          }
          cp_async_commit();
          stage_block(bacc, stg + ((t + 1) & 1) * kSlot, vp, ra, cb);
          __syncthreads();
          for_each_weight(t, s, da, [&](int k, int x, float att, float dav) {
            dsum[x] = fmaf(att, dav, dsum[x]);
          });
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], 1);
          dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], 2);
          rdelta[x] = dsum[x];
          if ((lane & 3) == 0 && ra + 8 * x < crows) delta_out[so + ra + 8 * x] = dsum[x];
        }
        stage_first();

        float dacc[DK / 2];
#pragma unroll
        for (int i = 0; i < DK / 2; ++i) dacc[i] = 0.f;

        for (int t = 0; t < n_tiles; ++t) {
          const int j0 = lo + 64 * t;
          const bool more = t + 1 < n_tiles;
          cp_async_wait_all();  // K, V of tile t and positional block t + 1 have landed
          fence_async_smem();
          __syncthreads();
          if (more)
            load_tile<DK>(smem_u32(sP + ((t + 2) % 3) * kTile), pb, spp, pb0 + 64 * (t + 2),
                          p_rows, tid);
          cp_async_commit();
          const uint8_t* tP0 = sP + (t % 3) * kTile;        // block t
          const uint8_t* tP1 = sP + ((t + 1) % 3) * kTile;  // block t + 1

          float s[32], da[32], bacc[32];
          tile_products(tP1, s, da, bacc);
          // V is read by no one else in this tile: the next tile's V loads now
          if (more) load_tile<DK>(v_addr, kb + DK, skt, j0 + 64, W, tid);
          stage_block(bacc, stg + ((t + 1) & 1) * kSlot, vp, ra, cb);
          __syncthreads();

          // dS = A (keep dA / (1 - p) - delta), f32, in s
          for_each_weight(t, s, da, [&](int k, int x, float att, float dav) {
            s[k] = att * (dav - rdelta[x]);
          });
          // dq += dS K (dS as bf16 A fragments, K as it landed: MN-major)
          {
            uint32_t a[4][4];
            acc_to_a(s, a);
            fence_regs(dacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_pv<DK>(dacc, a[kk], desc_mnmajor(k_addr, kk));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(dacc);
          }
          // K is read by no one else in this tile: the next tile's K loads now
          if (more) load_tile<DK>(k_addr, kb, skt, j0 + 64, W, tid);
          cp_async_commit();
          // f32 dS skewed into the band: row r, column 63 - r + j
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              float* row = fband + (ra + 8 * x) * kFb + 63 - (ra + 8 * x) + 8 * i + cb;
              row[0] = s[4 * i + 2 * x];
              row[1] = s[4 * i + 2 * x + 1];
            }
          }
          __syncthreads();
          {  // f32 column sums of the band, cs_p[m] = sum_r band[r, m], fixed order
            float a = 0.f;
#pragma unroll 16
            for (int r = 0; r < 64; ++r) a += fband[r * kFb + tid];
            csp[tid] = a;
          }
          // the band in bf16, swizzled: the A operand of unshift(dS) P and of dP
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int i = tid + k * kThreads;
            const int r = i >> 4, ch = i & 15;
            const float4 lo4 = *reinterpret_cast<const float4*>(fband + r * kFb + ch * 8);
            const float4 hi4 = *reinterpret_cast<const float4*>(fband + r * kFb + ch * 8 + 4);
            uint4 pk;
            pk.x = pack_bf16(lo4.x, lo4.y);
            pk.y = pack_bf16(lo4.z, lo4.w);
            pk.z = pack_bf16(hi4.x, hi4.y);
            pk.w = pack_bf16(hi4.z, hi4.w);
            *reinterpret_cast<uint4*>(sBand + swz(r, ch)) = pk;
          }
          fence_async_smem();
          __syncthreads();

          // dq += band [P_t; P_t+1]: K = 128 positional rows, P MN-major
          fence_regs(dacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_ss_dk<DK, 0, 1>(dacc, desc_kmajor(band_addr, kk),
                                  desc_mnmajor(smem_u32(kk < 4 ? tP0 : tP1), kk & 3), 1);
          wgmma_commit();
          {  // this group's f32 band column sums, for the v terms of dP and dv (a
             // positional row below 0 meets only zero rows past the chunk)
            const int prow = pb0 + 64 * t + tid;
            if (prow >= 0 && prow < p_rows) cs_slab[prow] += csp[tid];
          }
          wgmma_wait_all();
          fence_regs(dacc);

          // dP rows of blocks t and t + 1 += band^T Q (this group's slab)
#pragma unroll 1
          for (int mb = 0; mb < 2; ++mb) {
            // this thread's slab values, loaded while the product runs
            float pacc[DK / 2], cur[DK / 2];
            const int prow0 = pb0 + 64 * (t + mb) + ra;
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const bool in = prow0 + 8 * x >= 0 && prow0 + 8 * x < p_rows;
              const float* src = slab + static_cast<int64_t>(prow0 + 8 * x) * DK + cb;
#pragma unroll
              for (int i = 0; i < DK / 8; ++i) {
                const float2 v2 = in ? *reinterpret_cast<const float2*>(src + 8 * i)
                                     : make_float2(0.f, 0.f);
                cur[4 * i + 2 * x] = v2.x;
                cur[4 * i + 2 * x + 1] = v2.y;
              }
            }
            fence_regs(pacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_ss_dk<DK, 1, 1>(pacc, desc_mnmajor(band_addr + mb * 8192, kk),
                                    desc_mnmajor(q_addr, kk), kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(pacc);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              if (prow0 + 8 * x < 0 || prow0 + 8 * x >= p_rows) continue;
              float* dst = slab + static_cast<int64_t>(prow0 + 8 * x) * DK + cb;
#pragma unroll
              for (int i = 0; i < DK / 8; ++i)
                *reinterpret_cast<float2*>(dst + 8 * i) =
                    make_float2(cur[4 * i + 2 * x] + pacc[4 * i + 2 * x],
                                cur[4 * i + 2 * x + 1] + pacc[4 * i + 2 * x + 1]);
            }
          }
        }
        // dq = (dS K + unshift(dS) P) / sqrt(dk); rows past len are 0, rows
        // past the chunk not stored
#pragma unroll
        for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            if (ra + 8 * x < crows)
              *reinterpret_cast<__nv_bfloat162*>(
                  dqb + static_cast<int64_t>(ra + 8 * x) * H * DK + 8 * i + cb) =
                  __floats2bfloat162_rn(dacc[4 * i + 2 * x] * scale,
                                        dacc[4 * i + 2 * x + 1] * scale);
          }
        }
      }
    }
  }
}

// -------------------------------------------------- backward (b): dK, dV

template <int DK>
struct DkvSmem {
  static constexpr int kTile = 64 * DK * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile;
  static constexpr int kStep = kV + kTile;        // Q, dctx, P block 0, P block 1
  static constexpr int kA = kStep + 4 * kTile;    // bf16 [64 r][64 j] A_drop
  static constexpr int kDs = kA + 8192;           // bf16 [64 r][64 j] dS
  static constexpr int kStg = kDs + 8192;         // f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                // f32 v.p [128]
  static constexpr int kCsw = kVp + 128 * 4;              // f32 [4 warps][64] dS column sums
  static constexpr int kRow = kCsw + 4 * 64 * 4;          // f32 [2][3][64]: m log2e, 1/den, delta
  static constexpr int kBytes = kRow + 2 * 3 * 64 * 4 + 1024;
};

template <int DK>
__global__ void __launch_bounds__(kThreads)
train_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                        const bf16* __restrict__ pos, const bf16* __restrict__ bias_u,
                        const bf16* __restrict__ bias_v, const int* __restrict__ lens,
                        const float* __restrict__ m_in, const float* __restrict__ den_in,
                        const float* __restrict__ delta_in, const bf16* __restrict__ dctx,
                        bf16* __restrict__ dkv, float* __restrict__ du_part, Geom g, Drop drop,
                        int64_t sqb, int64_t sqt, int64_t sqh,
                        int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                        int64_t sdb, int64_t sdt, int64_t sdh) {
  using S = DkvSmem<DK>;
  constexpr int kTile = S::kTile;
  constexpr int kSlot = 64 * kStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem + S::kK;
  uint8_t* sV = smem + S::kV;
  uint8_t* sA = smem + S::kA;
  uint8_t* sDs = smem + S::kDs;
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);
  float* csw = reinterpret_cast<float*>(smem + S::kCsw);
  float* rowst = reinterpret_cast<float*>(smem + S::kRow);

  const int kt = (g.T() + 63) / 64;  // key blocks an utterance, the last may be partial
  const int b = blockIdx.x / kt, f0 = (blockIdx.x % kt) * 64, h = blockIdx.y;
  const int tid = threadIdx.x, c = g.c, H = g.H, L = g.L;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int krows = min(64, T - f0);  // key frames of the block
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(DK));
  const float scale_log2 = kLog2e * scale;
  const int len = lens[b];
  bf16* ob = dkv + b * sdb + static_cast<int64_t>(L + f0) * sdt + h * sdh;

  // query chunks whose window [ci*c - L, ci*c + c + R) meets [f0, f0 + 64)
  int ci_lo, ci_hi;
  key_block_chunks(g, f0, ci_lo, ci_hi);
  int n_steps = 0;
  if (f0 < len) {
    for (int ci = ci_lo, r0 = 0; ci <= ci_hi && ci * c < len; next_block(ci, r0, c, len))
      ++n_steps;
  }
  float* dub = du_part + (static_cast<int64_t>(blockIdx.x) * H + h) * DK;
  if (n_steps == 0) {  // no valid key or no query: zero gradient rows
    for (int i = tid; i < krows * DK; i += kThreads) {
      const int r = i / DK, d = i % DK;
      ob[r * sdt + d] = __float2bfloat16(0.f);
      ob[r * sdt + DK + d] = __float2bfloat16(0.f);
    }
    for (int d = tid; d < DK; d += kThreads) dub[d] = 0.f;
    return;
  }

  const bf16* kvb = kv + b * skb + h * skh;
  const bf16* pb = pos + h * sph;
  for (int d = tid; d < DK; d += kThreads) {
    uf[d] = __bfloat162float(bias_u[h * DK + d]);
    vf[d] = __bfloat162float(bias_v[h * DK + d]);
  }
  // one step's operands: Q, dctx, positional blocks; row statistics into
  // stage st (a partial block's rows past the chunk: zero rows, finite
  // stand-in statistics, never used)
  auto load_step = [&](int st, int ci, int r0) {
    uint8_t* base = smem + S::kStep;
    const int j0 = L + f0 - ci * c;
    const int pbase = c - 64 - r0 + j0;
    const int crows = min(64, c - r0);
    const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;
    load_tile<DK>(smem_u32(base), q + b * sqb + (ci * c + r0) * sqt + h * sqh, sqt, 0, crows,
                  tid);
    load_tile<DK>(smem_u32(base + kTile), dctx + (t0 * H + h) * DK,
                  static_cast<int64_t>(H) * DK, 0, crows, tid);
    load_tile<DK>(smem_u32(base + 2 * kTile), pb, spp, pbase, p_rows, tid);
    load_tile<DK>(smem_u32(base + 3 * kTile), pb, spp, pbase + 64, p_rows, tid);
    if (tid < 64) {
      const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0 + tid;
      float* rs = rowst + st * 192;
      rs[tid] = tid < crows ? m_in[so] * kLog2e : 0.f;
      rs[64 + tid] = tid < crows ? 1.f / den_in[so] : 0.f;
      rs[128 + tid] = tid < crows ? delta_in[so] : 0.f;
    }
  };

  load_tile<DK>(smem_u32(sK), kvb, skt, L + f0, L + T, tid);
  load_tile<DK>(smem_u32(sV), kvb + DK, skt, L + f0, L + T, tid);
  int ci = ci_lo, r0 = 0;
  load_step(0, ci, r0);
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();
  if (tid < 64) uk[tid] = dot_row<DK>(sK, tid, uf);

  float dkacc[DK / 2], dvacc[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  float cs_tot = 0.f;  // thread j < 64: f32 sum of dS over every query row, for key j
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step > 0) {
      cp_async_wait_all();
      fence_async_smem();
    }
    __syncthreads();
    int nci = ci, nr0 = r0;
    next_block(nci, nr0, c, len);

    const uint8_t* base = smem + S::kStep;
    const uint32_t tq = smem_u32(base), tg = smem_u32(base + kTile);
    const uint8_t* tP0 = base + 2 * kTile;
    const uint8_t* tP1 = base + 3 * kTile;
    const float* rs = rowst + st * 192;
    const int j0 = L + f0 - ci * c;
    const int crows = min(64, c - r0);  // query rows of the block in the chunk

    float bacc[32];
    fence_regs(bacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(bacc, desc_kmajor(tq, kk), desc_kmajor(smem_u32(tP0), kk), kk > 0);
    wgmma_commit();
    vp[tid] = dot_row<DK>(tid < 64 ? tP0 : tP1, tid & 63, vf);
    __syncthreads();
    wgmma_wait_all();
    fence_regs(bacc);
    stage_block(bacc, stg, vp, ra, cb);

    float s[32], da[32];
    fence_regs(s);
    fence_regs(da);
    fence_regs(bacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint64_t dqd = desc_kmajor(tq, kk);
      wgmma_ss_n64(bacc, dqd, desc_kmajor(smem_u32(tP1), kk), kk > 0);
      wgmma_ss_n64(s, dqd, desc_kmajor(k_addr, kk), kk > 0);
      wgmma_ss_n64(da, desc_kmajor(tg, kk), desc_kmajor(v_addr, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(bacc);
    fence_regs(s);
    fence_regs(da);
    stage_block(bacc, stg + kSlot, vp + 64, ra, cb);
    __syncthreads();

    float cs[16];  // this thread's column partials of dS: columns 8i + cb + e
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 ukj = *reinterpret_cast<const float2*>(uk + 8 * i + cb);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 8 * i + cb + e;
        const bool key_ok = j0 + jj >= 0 && j0 + jj < W && f0 + jj < len;
        const uint32_t fk = static_cast<uint32_t>(L + f0 + jj);  // key stream row
        float csum = 0.f;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int rr = ra + 8 * x, k = 4 * i + 2 * x + e;
          const bool ok = key_ok && rr < crows && ci * c + r0 + rr < len;
          const int idx = 63 - rr + jj;
          const float bd = stg[(idx < 64 ? 0 : kSlot) + rr * kStage + (idx & 63)];
          const float sc = (s[k] + (e ? ukj.y : ukj.x) + bd) * scale_log2;
          const float att = ok ? exp2f(sc - rs[rr]) * rs[64 + rr] : 0.f;
          float adrop = att, dav = da[k];
          if (drop.on) {
            const bool kp =
                mix32(drop_row(drop, b, h, ci * c + r0 + rr) ^ fk) >= drop.thresh;
            adrop = kp ? att * drop.scale : 0.f;
            dav = kp ? dav * drop.scale : 0.f;
          }
          const float dsv = att * (dav - rs[128 + rr]);
          s[k] = dsv;
          da[k] = adrop;
          csum += dsv;
        }
        cs[2 * i + e] = csum;
      }
    }
    // A_drop and dS as bf16 [r][j] tiles (the MN-major A operands of dV and dK)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int rr = ra + 8 * x;
        const uint32_t off = swz(rr, i) + cb * 2;
        *reinterpret_cast<uint32_t*>(sA + off) = pack_bf16(da[4 * i + 2 * x], da[4 * i + 2 * x + 1]);
        *reinterpret_cast<uint32_t*>(sDs + off) = pack_bf16(s[4 * i + 2 * x], s[4 * i + 2 * x + 1]);
      }
    }
    // column sums over the warp's 16 rows, then over the 4 warps (fixed order)
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 4);
      cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 8);
      cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 16);
    }
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        csw[warp * 64 + 8 * i + cb] = cs[2 * i];
        csw[warp * 64 + 8 * i + cb + 1] = cs[2 * i + 1];
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tid < 64) cs_tot += ((csw[tid] + csw[64 + tid]) + csw[128 + tid]) + csw[192 + tid];

    // dV += A_drop^T dctx, dK += dS^T Q (A operands MN-major, B operands MN-major)
    fence_regs(dkacc);
    fence_regs(dvacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss_dk<DK, 1, 1>(dvacc, desc_mnmajor(smem_u32(sA), kk), desc_mnmajor(tg, kk), 1);
      wgmma_ss_dk<DK, 1, 1>(dkacc, desc_mnmajor(smem_u32(sDs), kk), desc_mnmajor(tq, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dkacc);
    fence_regs(dvacc);
    // this step's operands are consumed: the next step's load (overlapping the
    // other block on the SM)
    if (step + 1 < n_steps) load_step(st ^ 1, nci, nr0);
    cp_async_commit();
    ci = nci;
    r0 = nr0;
  }
  __syncthreads();
  if (tid < 64) csw[tid] = cs_tot;
  __syncthreads();
  // du partial: sum_j cs[j] k[j] over this block's keys, f32
  for (int d = tid; d < DK; d += kThreads) {
    float a = 0.f;
    for (int j = 0; j < 64; ++j) a = fmaf(csw[j], tile_at(sK, j, d), a);
    dub[d] = a;
  }
  // dK = (dS^T Q + cs u) / sqrt(dk), dV = A_drop^T dctx, rows L + f0 + j of the
  // stream; a partial block's rows past T are not stored
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int jj = ra + 8 * x;
    if (jj >= krows) continue;
    const float csj = csw[jj];
    bf16* row = ob + jj * sdt;
#pragma unroll
    for (int i = 0; i < DK / 8; ++i) {
      const int d = 8 * i + cb;
      *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
          (dkacc[4 * i + 2 * x] + csj * uf[d]) * scale,
          (dkacc[4 * i + 2 * x + 1] + csj * uf[d + 1]) * scale);
      *reinterpret_cast<__nv_bfloat162*>(row + DK + d) =
          __floats2bfloat162_rn(dvacc[4 * i + 2 * x], dvacc[4 * i + 2 * x + 1]);
    }
  }
}

template <int DK>
int launch_fwd(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, void* ctx, float* m, float* den, int B, Geom g, Drop drop,
               const int64_t* s, cudaStream_t stream) {
  const int smem = FwdSmem<DK>::kBytes;
  int err = set_smem(train_fwd_tc_kernel<DK>, smem);
  if (err) return err;
  // ceil(c / 64) query blocks a chunk, the last partial where 64 does not divide c
  train_fwd_tc_kernel<DK><<<dim3(B * g.n, g.H, (g.c + 63) / 64), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv), static_cast<const bf16*>(pos),
      static_cast<const bf16*>(u), static_cast<const bf16*>(v), lens, static_cast<bf16*>(ctx),
      m, den, g, drop, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch_bwd(const void* q, const void* kv, const void* pos, const void* u, const void* v,
               const int* lens, const void* ctx, const float* m, const float* den,
               const void* dctx, float* delta, void* dq, void* dkv, float* dp_part,
               float* cs_part, float* du_part, void* dp, void* du, void* dv, int B, int group,
               int splits, Geom g, Drop drop, const int64_t* s, cudaStream_t stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kvb = static_cast<const bf16*>(kv);
  const bf16* pb = static_cast<const bf16*>(pos);
  const bf16* ub = static_cast<const bf16*>(u);
  const bf16* vb = static_cast<const bf16*>(v);
  const int cells = (B + group - 1) / group * splits;  // dq blocks a head, one slab each
  int smem = DqSmem<DK>::kBytes;
  int err = set_smem(train_bwd_dq_tc_kernel<DK>, smem);
  if (err) return err;
  train_bwd_dq_tc_kernel<DK><<<dim3(cells, g.H), kThreads, smem, stream>>>(
      qb, kvb, pb, ub, vb, lens, m, den, static_cast<const bf16*>(dctx), delta,
      static_cast<bf16*>(dq), dp_part, cs_part, B, group, splits, g, drop, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7]);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  smem = DkvSmem<DK>::kBytes;
  err = set_smem(train_bwd_dkv_tc_kernel<DK>, smem);
  if (err) return err;
  const int kv_blocks = B * ((g.T() + 63) / 64);
  train_bwd_dkv_tc_kernel<DK><<<dim3(kv_blocks, g.H), kThreads, smem, stream>>>(
      qb, kvb, pb, ub, vb, lens, m, den, delta, static_cast<const bf16*>(dctx),
      static_cast<bf16*>(dkv), du_part, g, drop, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
      s[7], s[8], s[9], s[10]);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  return launch_partial_sums<bf16>(dp_part, cs_part, du_part, pb, vb, static_cast<bf16*>(dp),
                                   static_cast<bf16*>(du), static_cast<bf16*>(dv), cells,
                                   kv_blocks, g, DK, s[6], s[7], stream);
}

}  // namespace

extern "C" int cf_chunk_train_attn_tc_f32_fwd(const void* q, const void* kv, const void* pos,
                                              const void* u, const void* v, const int* lens,
                                              void* ctx, float* m, float* den, int B, int n,
                                              int H, int c, int dk, int L, int R, uint32_t seed,
                                              uint32_t thresh, float drop_scale, int use_drop,
                                              int h0, int Ht,
                                              int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
                                              int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                              void* stream);
extern "C" int cf_chunk_train_attn_tc_f32_bwd(
    const void* q, const void* kv, const void* pos, const void* u, const void* v,
    const int* lens, const void* ctx, const float* m, const float* den, const void* dctx,
    float* delta, void* dq, void* dkv, float* dp_part, float* cs_part, float* du_part, void* dp,
    void* du, void* dv, int B, int n, int H, int c, int dk, int L, int R, int group,
    int splits, uint32_t seed, uint32_t thresh, float drop_scale, int use_drop, int h0, int Ht,
    int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb, int64_t skt, int64_t skh, int64_t spp,
    int64_t sph, int64_t sdb, int64_t sdt, int64_t sdh, void* stream);

// dtype: 0 = float32 (the 3xTF32 kernels of chunk_attention_train_tc_f32.cu),
// 1 = bfloat16 (this file's kernels); dk 64 or 128; any c >= 1; every row
// 16-byte aligned; ctx, dctx, dq contiguous [B, n*c, H, dk]; m, den,
// delta contiguous [B, H, n*c] (checked by the Python wrapper). Strides: q
// (b, t, h), kv (b, t, h), p (p, h), dkv (b, t, h). h0, Ht: the tensor's head h
// is head h0 + h of Ht in the dropout hash (0 and H on one process). Return a
// cudaError_t (0 = launched).
extern "C" int cf_chunk_train_attn_tc_fwd(int dtype, const void* q, const void* kv,
                                          const void* pos, const void* u, const void* v,
                                          const int* lens, void* ctx, float* m, float* den,
                                          int B, int n, int H, int c, int dk, int L, int R,
                                          uint32_t seed, uint32_t thresh, float drop_scale,
                                          int use_drop, int h0, int Ht, int64_t sqb, int64_t sqt,
                                          int64_t sqh,
                                          int64_t skb, int64_t skt, int64_t skh, int64_t spp,
                                          int64_t sph, void* stream) {
  if (dtype == 0)
    return cf_chunk_train_attn_tc_f32_fwd(q, kv, pos, u, v, lens, ctx, m, den, B, n, H, c, dk,
                                          L, R, seed, thresh, drop_scale, use_drop, h0, Ht, sqb,
                                          sqt,
                                          sqh, skb, skt, skh, spp, sph, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || n == 0) return 0;
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{n, H, c, L, R};
  const Drop drop{seed, thresh, drop_scale, use_drop, h0, Ht};
  const int64_t s[8] = {sqb, sqt, sqh, skb, skt, skh, spp, sph};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk == 64) return launch_fwd<64>(q, kv, pos, u, v, lens, ctx, m, den, B, g, drop, s, st);
  if (dk == 128) return launch_fwd<128>(q, kv, pos, u, v, lens, ctx, m, den, B, g, drop, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// group: utterances per dq block; splits: chunk ranges an utterance's dq work
// is cut into (only with group 1; ops/chunk_attention_train.py dp_splits).
// Partials, f32: dp_part [ceil(B / group) * splits, H, P, dk] and cs_part
// [ceil(B / group) * splits, H, P], both zero; du_part [B * ceil(n*c / 64),
// H, dk] (one row a dK/dV block).
extern "C" int cf_chunk_train_attn_tc_bwd(int dtype, const void* q, const void* kv, const void* pos,
                                          const void* u, const void* v, const int* lens,
                                          const void* ctx, const float* m, const float* den,
                                          const void* dctx, float* delta, void* dq, void* dkv,
                                          float* dp_part, float* cs_part, float* du_part,
                                          void* dp, void* du, void* dv, int B, int n, int H,
                                          int c, int dk, int L, int R, int group, int splits,
                                          uint32_t seed,
                                          uint32_t thresh, float drop_scale, int use_drop, int h0,
                                          int Ht,
                                          int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
                                          int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                          int64_t sdb, int64_t sdt, int64_t sdh, void* stream) {
  if (dtype == 0)
    return cf_chunk_train_attn_tc_f32_bwd(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq,
                                          dkv, dp_part, cs_part, du_part, dp, du, dv, B, n, H,
                                          c, dk, L, R, group, splits, seed, thresh, drop_scale,
                                          use_drop, h0, Ht, sqb, sqt, sqh, skb, skt, skh, spp,
                                          sph, sdb,
                                          sdt, sdh, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || n == 0) return 0;
  if (c < 1 || group < 1 || splits < 1 || splits > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{n, H, c, L, R};
  const Drop drop{seed, thresh, drop_scale, use_drop, h0, Ht};
  const int64_t s[11] = {sqb, sqt, sqh, skb, skt, skh, spp, sph, sdb, sdt, sdh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk == 64)
    return launch_bwd<64>(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq, dkv, dp_part,
                          cs_part, du_part, dp, du, dv, B, group, splits, g, drop, s, st);
  if (dk == 128)
    return launch_bwd<128>(q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq, dkv, dp_part,
                           cs_part, du_part, dp, du, dv, B, group, splits, g, drop, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
