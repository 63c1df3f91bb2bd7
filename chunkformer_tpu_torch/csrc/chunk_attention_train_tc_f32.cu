// Limited-context training attention on Hopper tensor cores (sm_90a), f32,
// with 3xTF32 split products: forward and backward.
//
// Replaces, for f32 with head_dim 64 or 128 and a chunk of a multiple of 64
// rows, the TPU kernels of chunkformer_tpu/ops/pallas/chunk_attention_train.py:
// the forward _attn_fwd_call (:316; its pallas_call at :359, kernel
// _fwd_kernel :78) and the backward _attn_core_bwd (:390; its pallas_call at
// :448, kernel _bwd_kernel :161, overlap-add :469-482). The function is that
// of chunk_attention_train_tc.cu (its bf16 twin, whose C entry dispatches
// f32 here) and chunk_attention_train.cu (the CUDA-core kernels, which keep
// every other shape): for utterance b, chunk ci, head h, query row r and
// window position j < W = L + c + R (key frame f = ci*c - L + j),
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid   iff 0 <= f < len[b] and ci*c + r < len[b]
//   ctx[r]  = sum_j keep(r, j) / (1 - p_drop) * softmax_j(s[r, j] | valid) v[j]
// with m = max(row max, -1e29) and den = max(row sum, 1e-30), to the f32 bars
// (ctx 1e-5 absolute, m and den 1e-5 relative, gradients 1e-4 + 1e-5
// relative against the plain f32 version). Every product is split into
// three TF32 passes with fresh accumulators added in f32 (tf32_split.cuh):
// one TF32 pass keeps 10 bits, about 5e-4 relative.
//
// What bounds them on an H100: at the flagship train shape (B = 32, n = 4,
// c = 64, H = 8, dk = 64, L = R = 128, 199 frames) the forward's three
// products over the valid (query, key) pairs are 3.8 GFLOP, the backward's
// eight 10.1 GFLOP; three TF32 passes at 495 TFLOP/s take 0.023 and 0.062
// ms, against about 0.017 and 0.045 ms for their f32 bytes at 3.35 TB/s:
// operations bound both.
//
// Forward (train_fwd_tc_f32_kernel): the f32 decode kernel's design
// (chunk_attention_tc_f32.cu), a block per (b, ci, h, 64 query rows): a
// producer warpgroup lands Q, each key tile K_t, positional block and V_t by
// cp.async and splits them into hi/lo pairs (V transposed, its keys in the
// order of P's register fragments; u.k and v.p from the unsplit values);
// a consumer warpgroup runs S = Q K^T and BD = Q P^T, stages each BD block in
// f32 for the skewed rel-shift read, keeps the online softmax in registers,
// applies the keep mask and multiplies P (from registers) by V^T. Shared
// memory 171.5 KB at dk = 64, 208 KB at dk = 128; 222 registers a thread
// at dk = 64, 255 and 496 bytes of stack at dk = 128 (ptxas).
//
// Backward, deterministic (no floating-point atomics; every sum has one
// owner and a fixed order), the bf16 kernels' decomposition with the
// partial buffers of ops/chunk_attention_train.py:partial_shapes:
// (a) train_bwd_dq_tc_f32_kernel, a block per (group of utterances, h, 64
//     columns of dk): per 64-row query block and key tile, S, BD and dA =
//     dctx V^T (split products, dk in 64-column steps), dS = A (keep dA /
//     (1 - p) - delta) in f32 registers (delta = rowsum(dctx * ctx) in f32
//     on the CUDA cores), dq += dS K (dS from registers, K^T transposed with
//     its keys permuted to match), dS written skewed into an f32 band
//     [64][128] over the tile's two positional blocks, whose f32 column sums
//     go into the group's slab [P], dq += band P (P^T transposed) and dP +=
//     band^T Q (band^T and Q^T transposed) into the group's f32 slab [P][dk],
//     read-modified-written by this block only. It also sums delta' =
//     sum_j A_j dA_j from its own A and dA, in a fixed order, for (b).
// (b) train_bwd_dkv_tc_f32_kernel, a block per (b, 64 key frames, h, 64
//     columns of dk), over the query blocks whose windows meet those keys:
//     S, BD and dA formed as (a) forms them (the same operands, products,
//     order and expressions, so A and dA equal (a)'s bitwise), dS = A (keep
//     dA / (1 - p) - delta'); dS^T and A_drop^T written into split pairs,
//     then dK += dS^T Q and dV += A_drop^T dctx (Q^T and dctx^T transposed),
//     the f32 column sums of dS for dK's u term and a du partial. With
//     delta' each row of dS sums to zero up to f32 rounding, as the plain
//     version's does (its delta is rowsum(dA * A), as is the TPU kernel's,
//     chunk_attention_train.py:247): the gradient of the key projection's
//     bias, zero in exact arithmetic, is then f32 noise. With delta =
//     rowsum(dctx * ctx), which takes ctx from the forward's split
//     products, the f32 train step missed its per-parameter bar on those
//     biases (chip_smoke.py).
// (c, d) the sums of chunk_attention_train_tc.cuh: dp, du and dv.
// TF32 wgmma takes both shared operands K-major only, so each operand the
// bf16 kernels read MN-major is transposed here by the threads on its way
// into its pair (split_vt; the operands written by threads that meet it
// along K, the band, band^T, dS^T and A_drop^T, take its column order).
// (a) and (b) run two warpgroups a block and no double buffering: every
// operand arrives raw by cp.async, all of a phase's at once (the transposed
// operands' raw tiles while dS is computed), and both warpgroups split it
// into 64 x 64 hi/lo pairs (32 KB) between block barriers; warpgroup 0 runs
// the score products and dS, and the last products split between the two
// (dP's two positional blocks in (a), dK and dV in (b)). Both stream
// through five pairs: shared memory 199.0 KB (a) and 200.5 KB (b) at dk =
// 64, half a KB more at 128, one block an SM; 255 registers a thread, with
// 808 (a) and 256 (b) bytes of stack at dk = 64, 1312 and 736 at 128. The
// grids are small for one block an SM ((a): 128 blocks at the flagship
// shape), so each phase's latency shows: the elementwise work and the
// splits, one or two warps a scheduler, take more of a key tile than the
// products (tools/profile_torch_train_bwd_phases.py, PERF.md).

#include "chunk_attention_train_tc.cuh"
#include "tf32_split.cuh"

namespace {

constexpr int kThreads = 128;         // a warpgroup
constexpr int kBlock = 2 * kThreads;  // the forward's producer and consumer; the dq block
// the forward's named barriers (0 is __syncthreads)
constexpr int kBarQ = 1;       // Q's pair is split
constexpr int kBarProd = 2;    // the producer warpgroup alone
constexpr int kBarCons = 3;    // the consumer warpgroup alone
constexpr int kBarFull = 4;    // + slot (< 2): the slot's pair holds the next element
constexpr int kBarEmpty = 8;   // + slot (< 2): the consumer is done with the slot's pair

// ---------------------------------------------------------------- forward

template <int DK>
struct FwdSmem {
  static constexpr int kPairs = DK == 64 ? 2 : 1;    // operand hi/lo pairs
  static constexpr int kLanding = DK == 64 ? 2 : 1;  // landing buffers
  static constexpr int kTile = 64 * DK * 4;          // bytes of a [64][DK] f32 tile
  static constexpr int kQh = 0;                      // Q hi
  static constexpr int kQl = kQh + kTile;            // Q lo
  static constexpr int kB = kQl + kTile;             // pair s: hi at 2s, lo at 2s + 1 tiles
  static constexpr int kLand = kB + 2 * kPairs * kTile;
  static constexpr int kStg = kLand + kLanding * kTile;   // f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [2][64], by tile parity
  static constexpr int kVp = kUk + 2 * 64 * 4;            // f32 v.p [2][64], by block parity
  static constexpr int kPt = kVp + 2 * 64 * 4;            // f32 dot shares [64][kPart]
  static constexpr int kBytes = kPt + 64 * kPart<DK> * 4 + 1024;  // + 1024-byte alignment
};

// One key tile of the training forward's online softmax, on the S
// accumulator (s[4i + 2x + e]: query row ra + 8x, key column 8i + cb + e):
// the log2-domain score (s + u.k_j + BD'[r, 63 - r + j]) * scale_log2,
// masked past hi and on rows past the utterance; m_run, l_run (sums before
// dropout) and o are rescaled; s becomes the kept, rescaled probability.
// fk0 is the key stream row of column 0.
template <int DK>
__device__ __forceinline__ void softmax_tile_train(
    float (&s)[32], float (&o)[DK / 2], float (&m_run)[2], float (&l_run)[2],
    const float* stg_lo, const float* stg_hi, const float* uk, int ra, int cb, int j0, int hi,
    const bool (&row_ok)[2], const uint32_t (&row_hash)[2], const Drop& drop, int fk0,
    float scale_log2) {
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
        const float bd = (idx < 64 ? stg_lo : stg_hi)[rr * kStage + (idx & 63)];
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
    m_use[x] = m_new == -INFINITY ? 0.f : m_new;  // a row with no valid key
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
          const uint32_t fk = static_cast<uint32_t>(fk0 + 8 * i + cb + e);
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
}

template <int DK>
__global__ void __launch_bounds__(kBlock)
train_fwd_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                        const float* __restrict__ pos, const float* __restrict__ bias_u,
                        const float* __restrict__ bias_v, const int* __restrict__ lens,
                        float* __restrict__ ctx, float* __restrict__ m_out,
                        float* __restrict__ den_out, Geom g, Drop drop,
                        int64_t sqb, int64_t sqt, int64_t sqh,
                        int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  using S = FwdSmem<DK>;
  constexpr int kTile = S::kTile;
  constexpr int kPairs = S::kPairs;
  constexpr int kLanding = S::kLanding;
  constexpr int kSlot = 64 * kStage;  // floats of a staging slot
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQh = smem + S::kQh;
  uint8_t* sQl = smem + S::kQl;
  uint8_t* sB = smem + S::kB;
  uint8_t* sLand = smem + S::kLand;
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);
  float* pt = reinterpret_cast<float*>(smem + S::kPt);

  const int b = blockIdx.x / g.n, ci = blockIdx.x % g.n, h = blockIdx.y;
  const int r0 = blockIdx.z * 64;
  const int tid = threadIdx.x, c = g.c, H = g.H;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int len = lens[b];
  const int lo = max(0, g.L - ci * c);
  const int hi = min(W, len - ci * c + g.L);
  const int rows = min(64, len - ci * c - r0);  // valid query rows of the block
  const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;  // first frame of the block
  const int64_t sor = static_cast<int64_t>(H) * DK;              // row stride of ctx
  float* ob = ctx + (t0 * H + h) * DK;
  const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0;

  if (hi <= lo || rows <= 0) {  // no valid (query, key) pair: ctx 0, empty statistics
    for (int i = tid; i < 64 * DK / 2; i += kBlock) {
      const int r = i / (DK / 2), d = 2 * (i % (DK / 2));
      *reinterpret_cast<float2*>(ob + r * sor + d) = make_float2(0.f, 0.f);
    }
    if (tid < 64) {
      m_out[so + tid] = -1e29f;
      den_out[so + tid] = 1e-30f;
    }
    return;
  }
  const int n_tiles = (hi - lo + 63) / 64;
  // positional block b holds rows [pb0 + 64b, pb0 + 64b + 64); key tile t
  // needs blocks t and t + 1, and S_bd[r, j] = BD'[r, 63 - r + j] over them
  const int pb0 = lo + c - 64 - r0;
  // The operands form one stream of 64-row elements: Q, positional block 0,
  // then for each key tile t: K_t, positional block t + 1, V_t. Element
  // e >= 1 is split into pair slot(e); Q into its own pair.
  const int n_elems = 2 + 3 * n_tiles;
  enum { kQ, kK, kP, kV };
  auto kind = [](int e) { return e == 0 ? kQ : e == 1 ? kP : kK + (e - 2) % 3; };
  auto tile = [](int e) { return e < 2 ? 0 : (e - 2) / 3; };  // t of K_t, V_t; block t + 1
  auto slot = [](int e) { return (e - 1) % kPairs; };
  auto pair_hi = [&](int e) { return sB + 2 * slot(e) * kTile; };

  if (tid >= kThreads) {
    // ---- producer: land each element by cp.async, split it into hi and lo
    const int ptid = tid - kThreads;
    const float* qb = q + b * sqb + static_cast<int64_t>(ci * c + r0) * sqt + h * sqh;
    const float* kb = kv + b * skb + static_cast<int64_t>(ci) * c * skt + h * skh;
    const float* pb = pos + h * sph;
    for (int d = ptid; d < DK; d += kThreads) {
      uf[d] = bias_u[h * DK + d];
      vf[d] = bias_v[h * DK + d];
    }
    // element e lands in landing buffer e % kLanding; one commit group each
    auto load = [&](int e) {
      if (e < n_elems) {
        const uint32_t dst = smem_u32(sLand + (e % kLanding) * kTile);
        const int t = tile(e), block = e == 1 ? 0 : t + 1;
        if (kind(e) == kQ)
          load_tile<DK>(dst, qb, sqt, 0, 64, ptid);
        else if (kind(e) == kK)
          load_tile<DK>(dst, kb, skt, lo + 64 * t, W, ptid);
        else if (kind(e) == kP)
          load_tile<DK>(dst, pb, spp, pb0 + 64 * block, p_rows, ptid);
        else
          load_tile<DK>(dst, kb + DK, skt, lo + 64 * t, W, ptid);
      }
      cp_async_commit();  // possibly empty: one group per element keeps the count
    };
    for (int e = 0; e < kLanding; ++e) load(e);
    for (int e = 0; e < n_elems; ++e) {
      cp_async_wait<kLanding - 1>();
      bar_sync(kBarProd, kThreads);  // element e has landed (and u, v are in place)
      const uint8_t* src = sLand + (e % kLanding) * kTile;
      if (e >= 1 + kPairs) bar_sync(kBarEmpty + slot(e), kBlock);
      const int k = kind(e), t = tile(e), block = e == 1 ? 0 : t + 1;
      if (k == kQ)
        split_rows<DK, false>(src, sQh, sQl, nullptr, nullptr, ptid);
      else if (k == kV)
        split_vt<DK>(src, pair_hi(e), pair_hi(e) + kTile, ptid);
      else
        split_rows<DK, true>(src, pair_hi(e), pair_hi(e) + kTile, k == kK ? uf : vf, pt, ptid);
      fence_async_smem();
      bar_sync(kBarProd, kThreads);  // every producer thread is done with the landing buffer
      load(e + kLanding);
      // u.k of K_t by tile parity, v.p of a positional block by block parity
      if (k == kK) sum_parts<DK>(pt, uk + 64 * (t & 1), ptid);
      if (k == kP) sum_parts<DK>(pt, vp + 64 * (block & 1), ptid);
      bar_arrive(e == 0 ? kBarQ : kBarFull + slot(e), kBlock);
    }
    return;
  }

  // ---- consumer: the products, the online softmax and the output
  // accumulator layout: this thread holds rows ra and ra + 8 of the 64, at
  // columns 8i + cb and 8i + cb + 1 of every 8-column group i
  const int warp = tid >> 5, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  auto acquire = [&](int e) {
    bar_sync(kBarFull + slot(e), kBlock);
    return smem_u32(pair_hi(e));
  };
  auto release = [&](int e) {  // after this thread's products on the pair are done
    if (e + kPairs < n_elems) bar_arrive(kBarEmpty + slot(e), kBlock);
  };
  bar_sync(kBarQ, kBlock);
  const uint32_t qh = smem_u32(sQh), ql = smem_u32(sQl);

  // block 0's product into staging slot 0; each later block's is computed
  // once, by the tile before the one that first needs it
  float bacc[32];
  uint32_t bh = acquire(1);
  split_product<DK>(bacc, qh, ql, bh, bh + kTile);
  release(1);
  stage_block(bacc, stg, vp, ra, cb);

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
    const int e = 2 + 3 * t;
    const int j0 = lo + 64 * t;
    float s[32];
    bh = acquire(e);  // K_t
    split_product<DK>(s, qh, ql, bh, bh + kTile);
    release(e);
    bh = acquire(e + 1);  // positional block t + 1
    split_product<DK>(bacc, qh, ql, bh, bh + kTile);
    release(e + 1);
    stage_block(bacc, stg + ((t + 1) & 1) * kSlot, vp + 64 * ((t + 1) & 1), ra, cb);
    bar_sync(kBarCons, kThreads);

    softmax_tile_train<DK>(s, o, m_run, l_run, stg + (t & 1) * kSlot,
                           stg + ((t + 1) & 1) * kSlot, uk + 64 * (t & 1), ra, cb, j0, hi,
                           row_ok, row_hash, drop, ci * c + j0, scale_log2);

    uint32_t ph[8][4], pl[8][4];
    acc_to_tf32(s, ph, pl);
    bh = acquire(e + 2);  // V_t transposed
    split_product_rs<DK>(o, ph, pl, bh, bh + kTile);
    release(e + 2);
  }

  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float l = l_run[x];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[x] = l > 0.f ? 1.f / l : 0.f;
    if ((lane & 3) == 0) {
      const int rr = ra + 8 * x;
      m_out[so + rr] = l > 0.f ? fmaxf(m_run[x] * kLn2, -1e29f) : -1e29f;
      den_out[so + rr] = fmaxf(l, 1e-30f);
    }
  }
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      *reinterpret_cast<float2*>(ob + (ra + 8 * x) * sor + 8 * i + cb) =
          make_float2(o[4 * i + 2 * x] * inv[x], o[4 * i + 2 * x + 1] * inv[x]);
    }
  }
}

// ------------------------------------------------- backward: operand loads

constexpr int kUnit = 32768;  // bytes of a [64][64] f32 hi/lo pair
constexpr int kHalf = 16384;  // offset of its lo tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Rows [row0, row0 + 64) x columns [col0, col0 + 64) of a row-strided f32
// matrix (16-byte-aligned rows) as the K-major [64][64] operand of the pair
// at unit (row r, its columns along K), in two steps: stage_pair starts
// this thread's cp.async copies of the raw values into the pair's lo tile
// (rows outside [0, row_end) zero-filled); after cp_async_wait, split_pair
// splits the same chunks in place into hi and lo. No registers hold the
// copies, so every operand of a phase is in flight at once.
template <int THREADS = kThreads>
__device__ __forceinline__ void stage_raw(uint8_t* dst, const float* base, int64_t stride,
                                          int row0, int row_end, int col0, int tid) {
  load_tile<64, THREADS>(smem_u32(dst), base + col0, stride, row0, row_end, tid);
}
template <int THREADS = kThreads>
__device__ __forceinline__ void stage_pair(uint8_t* unit, const float* base, int64_t stride,
                                           int row0, int row_end, int col0, int tid) {
  stage_raw<THREADS>(unit + kHalf, base, stride, row0, row_end, col0, tid);
}

// The K column that holds index k (0..63) in the order of split_vt and of the
// register A fragments (acc_to_tf32): in each group of 8, indices 0, 2, 4, 6
// then 1, 3, 5, 7. An operand written by threads that meets a split_vt
// operand along K takes the same order.
__device__ __forceinline__ int kperm(int k) {
  return (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2);
}
template <int THREADS = kThreads>
__device__ __forceinline__ void split_pair(uint8_t* unit, int tid) {
#pragma unroll
  for (int k = 0; k < 64 * 16 / THREADS; ++k) {
    const int i = tid + k * THREADS;  // load_tile's chunk of this thread: row i / 16
    const uint32_t off = swz(i >> 4, i & 15);
    float4 h, l;
    split4(*reinterpret_cast<const float4*>(unit + kHalf + off), h, l);
    *reinterpret_cast<float4*>(unit + off) = h;
    *reinterpret_cast<float4*>(unit + kHalf + off) = l;
  }
}

// f32 dot product of row `row` of a row-strided f32 matrix with w (shared,
// [DK]); 0 outside [0, row_end)
template <int DK>
__device__ __forceinline__ float dot_global(const float* base, int64_t stride, int row,
                                            int row_end, const float* w) {
  if (row < 0 || row >= row_end) return 0.f;
  const float* src = base + row * stride;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DK / 4; ++i) {
    const float4 x = ld4(src + 4 * i), y = w4[i];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// d (=, or += when not first) A B^T over 64 columns of the pairs at a and b
__device__ __forceinline__ void product_step(float (&d)[32], bool first, const uint8_t* a,
                                             const uint8_t* b) {
  const uint32_t ah = smem_u32(a), bh = smem_u32(b);
  if (first)
    split_product<64>(d, ah, ah + kHalf, bh, bh + kHalf);
  else
    split_product_add<64>(d, ah, ah + kHalf, bh, bh + kHalf);
}

// the band element (row r, column m) lies on the band iff 63 - r <= m < 127 - r
__device__ __forceinline__ float4 on_band(float4 x, int r, int m0) {
  const int lo = 63 - r - m0, hi = 127 - r - m0;  // kept columns m0 + e: lo <= e < hi
  return make_float4(0 >= lo && 0 < hi ? x.x : 0.f, 1 >= lo && 1 < hi ? x.y : 0.f,
                     2 >= lo && 2 < hi ? x.z : 0.f, 3 >= lo && 3 < hi ? x.w : 0.f);
}

// ------------------------------------------------------- backward (a): dq

template <int DK>
struct DqSmem {
  static constexpr int kStg = 5 * kUnit;                  // five pairs, then f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                // f32 v.p [64]
  static constexpr int kRow = kVp + 64 * 4;  // [4][64]: m log2e, 1/den, delta, dropout row hash
  static constexpr int kBytes = kRow + 4 * 64 * 4 + 1024;
};

template <int DK>
__global__ void __launch_bounds__(kBlock)
train_bwd_dq_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                           const float* __restrict__ pos, const float* __restrict__ bias_u,
                           const float* __restrict__ bias_v, const int* __restrict__ lens,
                           const float* __restrict__ ctx, const float* __restrict__ m_in,
                           const float* __restrict__ den_in, const float* __restrict__ dctx,
                           float* __restrict__ delta_out, float* __restrict__ dq,
                           float* __restrict__ dp_part, float* __restrict__ cs_part, int B,
                           int group, Geom g, Drop drop, int64_t sqb, int64_t sqt, int64_t sqh,
                           int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph) {
  using S = DqSmem<DK>;
  constexpr int kSlot = 64 * kStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* u0 = smem;
  uint8_t* u1 = smem + kUnit;
  uint8_t* u2 = smem + 2 * kUnit;
  uint8_t* u3 = smem + 3 * kUnit;
  uint8_t* u4 = smem + 4 * kUnit;
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);
  float* row_m = reinterpret_cast<float*>(smem + S::kRow);
  float* row_inv = row_m + 64;
  float* row_delta = row_inv + 64;
  uint32_t* row_hash = reinterpret_cast<uint32_t*>(row_delta + 64);
  float* fband = reinterpret_cast<float*>(u0);  // f32 [64][128]: dS of row r at column 63 - r + j

  const int grp = blockIdx.x, h = blockIdx.y, z = blockIdx.z, d0 = 64 * z;
  // two warpgroups share the loads, splits and transposes; warpgroup 0 runs
  // the score products, dS and dq, and each runs one of the two dP products
  const int tid = threadIdx.x, wg = tid >> 7, c = g.c, H = g.H;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(DK));
  const float scale_log2 = kLog2e * scale;
  const int64_t srow = static_cast<int64_t>(H) * DK;  // row stride of ctx, dctx, dq
  float* slab = dp_part + (static_cast<int64_t>(grp) * H + h) * p_rows * DK;
  float* cs_slab = cs_part + (static_cast<int64_t>(grp) * H + h) * p_rows;
  const float* pb = pos + h * sph;

  for (int d = tid; d < DK; d += kBlock) {
    uf[d] = bias_u[h * DK + d];
    vf[d] = bias_v[h * DK + d];
  }

  const int b_end = min(B, (grp + 1) * group);
  for (int b = grp * group; b < b_end; ++b) {
    const int len = lens[b];
    const float* kvb = kv + b * skb + h * skh;
    for (int ci = 0; ci < g.n; ++ci) {
      const int lo = max(0, g.L - ci * c);
      const int hi = min(W, len - ci * c + g.L);
      const float* kb = kvb + static_cast<int64_t>(ci) * c * skt;
      for (int r0 = 0; r0 < c; r0 += 64) {
        const int rows = min(64, len - ci * c - r0);
        const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;
        const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0;
        const float* qb = q + b * sqb + static_cast<int64_t>(ci * c + r0) * sqt + h * sqh;
        const float* gb = dctx + (t0 * H + h) * DK;
        float* dqb = dq + (t0 * H + h) * DK + d0;
        __syncthreads();  // the previous block's row statistics and pairs are free
        if (wg == 0) {  // delta = rowsum(dctx * ctx), two threads a row; row statistics
          const int row = tid >> 1, half = tid & 1;
          const int64_t off = (t0 + row) * srow + h * DK + half * (DK / 2);
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < DK / 8; ++i) {
            const float4 x = ld4(ctx + off + 4 * i), y = ld4(dctx + off + 4 * i);
            a = fmaf(x.x, y.x, a);
            a = fmaf(x.y, y.y, a);
            a = fmaf(x.z, y.z, a);
            a = fmaf(x.w, y.w, a);
          }
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          if (half == 0) {
            row_delta[row] = a;
            if (z == 0) delta_out[so + row] = a;
            row_m[row] = m_in[so + row] * kLog2e;
            row_inv[row] = 1.f / den_in[so + row];
            row_hash[row] = drop_row(drop, b, h, ci * c + r0 + row);
          }
        }
        if (hi <= lo || rows <= 0) {  // no valid pair: dq rows 0
          for (int i = tid; i < 64 * 16; i += kBlock)
            *reinterpret_cast<float4*>(dqb + (i >> 4) * srow + 4 * (i & 15)) =
                make_float4(0.f, 0.f, 0.f, 0.f);
          continue;
        }
        const int n_tiles = (hi - lo + 63) / 64;
        const int pb0 = lo + c - 64 - r0;  // positional block t: rows [pb0 + 64t, pb0 + 64t + 64)

        {  // block 0's product BD = Q P_0^T + v.p into staging slot 0
          if (tid < 64) vp[tid] = dot_global<DK>(pb, spp, pb0 + tid, p_rows, vf);
          float bd[32];
#pragma unroll
          for (int d1 = 0; d1 < DK; d1 += 64) {
            if (d1) __syncthreads();
            stage_pair<kBlock>(u0, qb, sqt, 0, 64, d1, tid);
            stage_pair<kBlock>(u1, pb, spp, pb0, p_rows, d1, tid);
            cp_async_commit();
            cp_async_wait_all();
            split_pair<kBlock>(u0, tid);
            split_pair<kBlock>(u1, tid);
            fence_async_smem();
            __syncthreads();
            if (wg == 0) product_step(bd, d1 == 0, u0, u1);
          }
          if (wg == 0) stage_block(bd, stg, vp, ra, cb);
        }

        bool row_ok[2];
        uint32_t rhash[2];
        float rm[2], rinv[2], rdelta[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int rr = ra + 8 * x;
          row_ok[x] = rr < rows;
          rhash[x] = row_hash[rr];
          rm[x] = row_m[rr];
          rinv[x] = row_inv[rr];
          rdelta[x] = row_delta[rr];
        }
        float dacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
        float adsum[2] = {0.f, 0.f};  // this thread's share of sum_j A_j dA_j, rows ra, ra + 8

        for (int t = 0; t < n_tiles; ++t) {
          const int j0 = lo + 64 * t;
          const int pt0 = pb0 + 64 * t;  // first positional row of block t
          // S = Q K_t^T, BD = Q P_{t+1}^T, dA = dctx V_t^T, dk in steps of 64
          float s[32], bd[32], da[32];
#pragma unroll
          for (int d1 = 0; d1 < DK; d1 += 64) {
            __syncthreads();  // the pairs are free (and, at d1 = 0, u.k and v.p)
            stage_pair<kBlock>(u0, qb, sqt, 0, 64, d1, tid);
            stage_pair<kBlock>(u1, kb, skt, j0, W, d1, tid);
            stage_pair<kBlock>(u2, pb, spp, pt0 + 64, p_rows, d1, tid);
            stage_pair<kBlock>(u3, gb, srow, 0, 64, d1, tid);
            stage_pair<kBlock>(u4, kb + DK, skt, j0, W, d1, tid);
            cp_async_commit();
            if (d1 == 0) {  // while the copies fly
              if (tid < 64)
                uk[tid] = dot_global<DK>(kb, skt, j0 + tid, W, uf);
              else if (tid < 128)
                vp[tid - 64] = dot_global<DK>(pb, spp, pt0 + tid, p_rows, vf);  // block t + 1
            }
            cp_async_wait_all();
            split_pair<kBlock>(u0, tid);
            split_pair<kBlock>(u1, tid);
            split_pair<kBlock>(u2, tid);
            split_pair<kBlock>(u3, tid);
            split_pair<kBlock>(u4, tid);
            fence_async_smem();
            __syncthreads();
            if (wg == 0) {
              product_step(bd, d1 == 0, u0, u2);
              // staged as soon as it is whole, so its registers are free for S and dA
              if (d1 + 64 == DK) stage_block(bd, stg + ((t + 1) & 1) * kSlot, vp, ra, cb);
              product_step(s, d1 == 0, u0, u1);
              product_step(da, d1 == 0, u3, u4);
            }
          }
          __syncthreads();  // the staging is whole; the pairs are free
          // the raw tiles of the transposed operands, in flight during dS: P
          // of blocks t and t + 1 (u2), Q and K (u4), columns d0 .. d0 + 63
          stage_raw<kBlock>(u2, pb, spp, pt0, p_rows, d0, tid);
          stage_raw<kBlock>(u2 + kHalf, pb, spp, pt0 + 64, p_rows, d0, tid);
          stage_raw<kBlock>(u4, qb, sqt, 0, 64, d0, tid);
          stage_raw<kBlock>(u4 + kHalf, kb, skt, j0, W, d0, tid);
          cp_async_commit();
          float cs_prev = 0.f;  // this group's column sum of positional row pt0 + tid so far
          if (z == 0 && tid < 128 && pt0 + tid < p_rows) cs_prev = cs_slab[pt0 + tid];

          // dS = A (keep dA / (1 - p) - delta), f32, in s, and its skewed f32
          // band (u0): row r, column 63 - r + j
          if (wg == 0) {
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
                  const float bdv = (idx < 64 ? slot_lo : slot_hi)[rr * kStage + (idx & 63)];
                  const float sc = (s[k] + (e ? ukj.y : ukj.x) + bdv) * scale_log2;
                  const float att = key_ok && row_ok[x] ? exp2f(sc - rm[x]) * rinv[x] : 0.f;
                  float dav = da[k];
                  if (drop.on) {
                    const uint32_t fk = static_cast<uint32_t>(ci * c + j0 + jj);
                    dav = mix32(rhash[x] ^ fk) >= drop.thresh ? dav * drop.scale : 0.f;
                  }
                  adsum[x] = fmaf(att, dav, adsum[x]);
                  s[k] = att * (dav - rdelta[x]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
              for (int x = 0; x < 2; ++x) {
                float* row = fband + (ra + 8 * x) * 128 + 63 - (ra + 8 * x) + 8 * i + cb;
                row[0] = s[4 * i + 2 * x];
                row[1] = s[4 * i + 2 * x + 1];
              }
            }
          }
          cp_async_wait_all();
          __syncthreads();  // the band and the raw tiles are in place

          // dq += dS K: K^T (u1), its keys in the order of dS's A fragments
          split_vt<64, kBlock>(u4 + kHalf, u1, u1 + kHalf, tid);
          if (z == 0 && tid < 128) {  // the band's f32 column sums (v terms of dP, dv), in order
            const int m = tid;
            float a = 0.f;
            for (int r = max(0, 63 - m); r < min(64, 127 - m); ++r) a += fband[r * 128 + m];
            if (pt0 + m < p_rows) cs_slab[pt0 + m] = cs_prev + a;
          }
          fence_async_smem();
          __syncthreads();
          if (wg == 0) {
            uint32_t ah[8][4], al[8][4];
            acc_to_tf32(s, ah, al);
            split_product_rs<64>(dacc, ah, al, smem_u32(u1), smem_u32(u1 + kHalf));
          }
          // this warpgroup's slab values (positional block t + wg), loaded while
          // the band products run
          float cur[32];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int prow = pt0 + 64 * wg + ra + 8 * x;
            const float* sp = slab + static_cast<int64_t>(prow) * DK + d0 + cb;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float2 v2 = prow < p_rows ? *reinterpret_cast<const float2*>(sp + 8 * i)
                                              : make_float2(0.f, 0.f);
              cur[4 * i + 2 * x] = v2.x;
              cur[4 * i + 2 * x + 1] = v2.y;
            }
          }

          // dq += band P, 64 positions at a time: band half hb [64 rows][64
          // positions] (u1) and P^T of block t + hb (u3), 0 off the band,
          // positions in split_vt's order
#pragma unroll 1
          for (int hb = 0; hb < 2; ++hb) {
            __syncthreads();  // u1 and u3 are free
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int i = tid + k * kBlock;
              const int r = i >> 3, g = i & 7;  // row r, positions 64hb + 8g .. + 7
              const int m0 = 64 * hb + 8 * g;
              const float4 a = on_band(*reinterpret_cast<const float4*>(fband + r * 128 + m0),
                                       r, m0);
              const float4 b = on_band(
                  *reinterpret_cast<const float4*>(fband + r * 128 + m0 + 4), r, m0 + 4);
              float4 hv, lv;
              split4(make_float4(a.x, a.z, b.x, b.z), hv, lv);
              *reinterpret_cast<float4*>(u1 + swz(r, 2 * g)) = hv;
              *reinterpret_cast<float4*>(u1 + kHalf + swz(r, 2 * g)) = lv;
              split4(make_float4(a.y, a.w, b.y, b.w), hv, lv);
              *reinterpret_cast<float4*>(u1 + swz(r, 2 * g + 1)) = hv;
              *reinterpret_cast<float4*>(u1 + kHalf + swz(r, 2 * g + 1)) = lv;
            }
            split_vt<64, kBlock>(u2 + hb * kHalf, u3, u3 + kHalf, tid);
            fence_async_smem();
            __syncthreads();
            if (wg == 0)
              split_product_add<64>(dacc, smem_u32(u1), smem_u32(u1 + kHalf), smem_u32(u3),
                                    smem_u32(u3 + kHalf));
          }
          __syncthreads();  // u1 .. u3 are free

          // band^T [128 positions][64 rows] as two 64-position pairs (u1: block
          // t, u2: block t + 1), rows in split_vt's order, and Q^T (u3)
          {
            const int mb = wg, mg = tid & 15, g = (tid >> 4) & 7;  // positions 4mg .. 4mg + 3,
            const int m0 = 64 * mb + 4 * mg;                       // rows 8g .. 8g + 7
            float4 x[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              x[q] = on_band(*reinterpret_cast<const float4*>(fband + (8 * g + q) * 128 + m0),
                             8 * g + q, m0);
            uint8_t* dst = u1 + mb * kUnit;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int pr = 4 * mg + e;
              float4 hv, lv;
              split4(make_float4(pick(x[0], e), pick(x[2], e), pick(x[4], e), pick(x[6], e)),
                     hv, lv);
              *reinterpret_cast<float4*>(dst + swz(pr, 2 * g)) = hv;
              *reinterpret_cast<float4*>(dst + kHalf + swz(pr, 2 * g)) = lv;
              split4(make_float4(pick(x[1], e), pick(x[3], e), pick(x[5], e), pick(x[7], e)),
                     hv, lv);
              *reinterpret_cast<float4*>(dst + swz(pr, 2 * g + 1)) = hv;
              *reinterpret_cast<float4*>(dst + kHalf + swz(pr, 2 * g + 1)) = lv;
            }
          }
          split_vt<64, kBlock>(u4, u3, u3 + kHalf, tid);
          fence_async_smem();
          __syncthreads();

          // dP rows of block t + wg += band^T Q, columns d0 .. d0 + 63 of this
          // group's slab (one product a warpgroup)
          {
            float pacc[32];
            const uint32_t a = smem_u32(u1 + wg * kUnit), bq = smem_u32(u3);
            split_product<64>(pacc, a, a + kHalf, bq, bq + kHalf);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int prow = pt0 + 64 * wg + ra + 8 * x;
              if (prow >= p_rows) continue;
              float* dst = slab + static_cast<int64_t>(prow) * DK + d0 + cb;
#pragma unroll
              for (int i = 0; i < 8; ++i)
                *reinterpret_cast<float2*>(dst + 8 * i) =
                    make_float2(cur[4 * i + 2 * x] + pacc[4 * i + 2 * x],
                                cur[4 * i + 2 * x + 1] + pacc[4 * i + 2 * x + 1]);
            }
          }
        }
        // delta' = sum_j A_j dA_j from this kernel's own A and dA (fixed order),
        // the delta of the dK/dV kernel, which recomputes them bitwise: its dS
        // rows then sum to zero up to f32 rounding, as the plain version's do
        if (wg == 1) continue;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          adsum[x] += __shfl_xor_sync(0xffffffffu, adsum[x], 1);
          adsum[x] += __shfl_xor_sync(0xffffffffu, adsum[x], 2);
          if (z == 0 && (lane & 3) == 0) delta_out[so + ra + 8 * x] = adsum[x];
        }
        // dq = (dS K + unshift(dS) P) / sqrt(dk); rows past len are 0
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            *reinterpret_cast<float2*>(dqb + (ra + 8 * x) * srow + 8 * i + cb) =
                make_float2(dacc[4 * i + 2 * x] * scale, dacc[4 * i + 2 * x + 1] * scale);
          }
        }
      }
    }
  }
}

// -------------------------------------------------- backward (b): dK, dV

template <int DK>
struct DkvSmem {
  static constexpr int kStg = 5 * kUnit;                  // five pairs, then f32 [2][64][kStage]
  static constexpr int kUf = kStg + 2 * 64 * kStage * 4;  // f32 u [DK]
  static constexpr int kVf = kUf + DK * 4;                // f32 v [DK]
  static constexpr int kUk = kVf + DK * 4;                // f32 u.k [64]
  static constexpr int kVp = kUk + 64 * 4;                // f32 v.p [128]
  static constexpr int kCs = kVp + 128 * 4;               // f32 dS column sums [64]
  static constexpr int kCsw = kCs + 64 * 4;               // f32 [4 warps][64] of a step's
  static constexpr int kRow = kCsw + 4 * 64 * 4;  // [4][64]: m log2e, 1/den, delta, row hash
  static constexpr int kBytes = kRow + 4 * 64 * 4 + 1024;
};

template <int DK>
__global__ void __launch_bounds__(kBlock)
train_bwd_dkv_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                            const float* __restrict__ pos, const float* __restrict__ bias_u,
                            const float* __restrict__ bias_v, const int* __restrict__ lens,
                            const float* __restrict__ m_in, const float* __restrict__ den_in,
                            const float* __restrict__ delta_in, const float* __restrict__ dctx,
                            float* __restrict__ dkv, float* __restrict__ du_part, Geom g,
                            Drop drop, int64_t sqb, int64_t sqt, int64_t sqh,
                            int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                            int64_t sdb, int64_t sdt, int64_t sdh) {
  using S = DkvSmem<DK>;
  constexpr int kSlot = 64 * kStage;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* u0 = smem;
  uint8_t* u1 = smem + kUnit;
  uint8_t* u2 = smem + 2 * kUnit;
  uint8_t* u3 = smem + 3 * kUnit;
  uint8_t* u4 = smem + 4 * kUnit;  // raw Q and dctx, columns d0 .. d0 + 63
  float* stg = reinterpret_cast<float*>(smem + S::kStg);
  float* uf = reinterpret_cast<float*>(smem + S::kUf);
  float* vf = reinterpret_cast<float*>(smem + S::kVf);
  float* uk = reinterpret_cast<float*>(smem + S::kUk);
  float* vp = reinterpret_cast<float*>(smem + S::kVp);
  float* csk = reinterpret_cast<float*>(smem + S::kCs);
  float* csw = reinterpret_cast<float*>(smem + S::kCsw);
  float* rs_m = reinterpret_cast<float*>(smem + S::kRow);
  float* rs_inv = rs_m + 64;
  float* rs_delta = rs_inv + 64;
  uint32_t* rs_hash = reinterpret_cast<uint32_t*>(rs_delta + 64);

  const int kt = g.T() / 64;
  const int b = blockIdx.x / kt, f0 = (blockIdx.x % kt) * 64, h = blockIdx.y;
  const int d0 = 64 * blockIdx.z;
  // two warpgroups share the loads, splits and transposes; warpgroup 0 runs
  // the score products and dS and then dK, warpgroup 1 dV
  const int tid = threadIdx.x, wg = tid >> 7, c = g.c, H = g.H, L = g.L;
  const int W = g.W(), p_rows = g.P(), T = g.T();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int ra = warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(DK));
  const float scale_log2 = kLog2e * scale;
  const int64_t srow = static_cast<int64_t>(H) * DK;  // row stride of dctx
  const int len = lens[b];
  float* ob = dkv + b * sdb + static_cast<int64_t>(L + f0) * sdt + h * sdh + d0;

  int ci_lo, ci_hi;
  key_block_chunks(g, f0, ci_lo, ci_hi);
  int n_steps = 0;
  if (f0 < len) {
    for (int ci = ci_lo, r0 = 0; ci <= ci_hi && ci * c < len; next_block(ci, r0, c, len))
      ++n_steps;
  }
  float* dub = du_part + (static_cast<int64_t>(blockIdx.x) * H + h) * DK + d0;
  if (n_steps == 0) {  // no valid key or no query: zero gradient rows
    for (int i = tid; i < 64 * 64; i += kBlock) {
      const int r = i >> 6, d = i & 63;
      ob[r * sdt + d] = 0.f;
      ob[r * sdt + DK + d] = 0.f;
    }
    if (tid < 64) dub[tid] = 0.f;
    return;
  }

  const float* kvb = kv + b * skb + h * skh;
  const float* pb = pos + h * sph;
  for (int d = tid; d < DK; d += kBlock) {
    uf[d] = bias_u[h * DK + d];
    vf[d] = bias_v[h * DK + d];
  }
  __syncthreads();
  if (tid < 64) uk[tid] = dot_global<DK>(kvb, skt, L + f0 + tid, L + T, uf);

  float dkacc[32], dvacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.f;
  float cs_tot = 0.f;  // thread j < 64: f32 sum of dS over every query row, for key j

  int ci = ci_lo, r0 = 0;
  for (int step = 0; step < n_steps; ++step, next_block(ci, r0, c, len)) {
    const int j0 = L + f0 - ci * c;       // window position of key frame f0
    const int pbase = c - 64 - r0 + j0;   // first positional row of block 0
    const int64_t t0 = static_cast<int64_t>(b) * T + ci * c + r0;
    const float* qb = q + b * sqb + static_cast<int64_t>(ci * c + r0) * sqt + h * sqh;
    const float* gb = dctx + (t0 * H + h) * DK;
    __syncthreads();  // the previous step's pairs, staging and row statistics are free
    if (tid < 64) {
      const int64_t so = (static_cast<int64_t>(b) * H + h) * T + ci * c + r0 + tid;
      rs_m[tid] = m_in[so] * kLog2e;
      rs_inv[tid] = 1.f / den_in[so];
      rs_delta[tid] = delta_in[so];
      rs_hash[tid] = drop_row(drop, b, h, ci * c + r0 + tid);
    }
    if (tid < 128) vp[tid] = dot_global<DK>(pb, spp, pbase + tid, p_rows, vf);

    // BD of positional blocks 0 and 1: Q P_b^T [query rows][positions]
    float bd0[32], bd1[32];
#pragma unroll
    for (int d1 = 0; d1 < DK; d1 += 64) {
      if (d1) __syncthreads();
      stage_pair<kBlock>(u0, qb, sqt, 0, 64, d1, tid);
      stage_pair<kBlock>(u1, pb, spp, pbase, p_rows, d1, tid);
      stage_pair<kBlock>(u2, pb, spp, pbase + 64, p_rows, d1, tid);
      if (d1 == 0) {  // the sources of Q^T and dctx^T, for the last products
        stage_raw<kBlock>(u4, qb, sqt, 0, 64, d0, tid);
        stage_raw<kBlock>(u4 + kHalf, gb, srow, 0, 64, d0, tid);
      }
      cp_async_commit();
      cp_async_wait_all();
      split_pair<kBlock>(u0, tid);
      split_pair<kBlock>(u1, tid);
      split_pair<kBlock>(u2, tid);
      fence_async_smem();
      __syncthreads();
      if (wg == 0) {
        product_step(bd0, d1 == 0, u0, u1);
        if (d1 + 64 == DK) stage_block(bd0, stg, vp, ra, cb);  // staged as soon as it is whole
        product_step(bd1, d1 == 0, u0, u2);
        if (d1 + 64 == DK) stage_block(bd1, stg + kSlot, vp + 64, ra, cb);
      }
    }

    // S = Q K^T and dA = dctx V^T [query rows][keys], formed as the dq
    // kernel forms them (the same operands, products and order), so A and dA
    // equal its values bitwise
    float s[32], da[32];
#pragma unroll
    for (int d1 = 0; d1 < DK; d1 += 64) {
      __syncthreads();  // (at d1 = 0, also the staging)
      if (DK > 64) stage_pair<kBlock>(u0, qb, sqt, 0, 64, d1, tid);  // else Q is in u0
      stage_pair<kBlock>(u1, kvb, skt, L + f0, L + T, d1, tid);
      stage_pair<kBlock>(u2, gb, srow, 0, 64, d1, tid);
      stage_pair<kBlock>(u3, kvb + DK, skt, L + f0, L + T, d1, tid);
      cp_async_commit();
      cp_async_wait_all();
      if (DK > 64) split_pair<kBlock>(u0, tid);
      split_pair<kBlock>(u1, tid);
      split_pair<kBlock>(u2, tid);
      split_pair<kBlock>(u3, tid);
      fence_async_smem();
      __syncthreads();
      if (wg == 0) {
        product_step(s, d1 == 0, u0, u1);
        product_step(da, d1 == 0, u2, u3);
      }
    }

    // dS and A_drop, f32, in s and da (element 4i + 2x + e: query row
    // ra + 8x, key 8i + cb + e), with the dq kernel's expressions
    float cs[16];  // this thread's column partials of dS: keys 8i + cb + e
    if (wg == 0) {
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
            const int idx = 63 - rr + jj;
            const float bdv = stg[(idx < 64 ? 0 : kSlot) + rr * kStage + (idx & 63)];
            const float sc = (s[k] + (e ? ukj.y : ukj.x) + bdv) * scale_log2;
            const float att = key_ok && ci * c + r0 + rr < len
                                  ? exp2f(sc - rs_m[rr]) * rs_inv[rr] : 0.f;
            float adrop = att, dav = da[k];
            if (drop.on) {
              const bool kp = mix32(rs_hash[rr] ^ fk) >= drop.thresh;
              adrop = kp ? att * drop.scale : 0.f;
              dav = kp ? dav * drop.scale : 0.f;
            }
            const float dsv = att * (dav - rs_delta[rr]);
            s[k] = dsv;
            da[k] = adrop;
            csum += dsv;
          }
          cs[2 * i + e] = csum;
        }
      }
      // column sums over the warp's 16 rows, then over the 4 warps (fixed order)
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 4);
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 8);
        cs[k] += __shfl_xor_sync(0xffffffffu, cs[k], 16);
      }
    }
    __syncthreads();  // u0 .. u3 are consumed
    if (wg == 0 && lane < 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        csw[warp * 64 + 8 * i + cb] = cs[2 * i];
        csw[warp * 64 + 8 * i + cb + 1] = cs[2 * i + 1];
      }
    }
    // dS^T and A_drop^T [keys][query rows] as split pairs (u1, u2): the A
    // operands of dK = dS^T Q and dV = A_drop^T dctx, rows in split_vt's order
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = kperm(ra + 8 * x);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jj = 8 * i + cb + e, k = 4 * i + 2 * x + e;
            const uint32_t off = swz(jj, col >> 2) + (col & 3) * 4;
            const float sh = tf32_rna(s[k]), ah = tf32_rna(da[k]);
            *reinterpret_cast<float*>(u1 + off) = sh;
            *reinterpret_cast<float*>(u1 + kHalf + off) = tf32_rna(s[k] - sh);
            *reinterpret_cast<float*>(u2 + off) = ah;
            *reinterpret_cast<float*>(u2 + kHalf + off) = tf32_rna(da[k] - ah);
          }
        }
      }
    }
    // Q^T and dctx^T (u0, u3): the B operands
    split_vt<64, kBlock>(u4, u0, u0 + kHalf, tid);
    split_vt<64, kBlock>(u4 + kHalf, u3, u3 + kHalf, tid);
    fence_async_smem();
    __syncthreads();
    if (tid < 64) cs_tot += ((csw[tid] + csw[64 + tid]) + csw[128 + tid]) + csw[192 + tid];
    if (wg == 0)
      split_product_add<64>(dkacc, smem_u32(u1), smem_u32(u1 + kHalf), smem_u32(u0),
                            smem_u32(u0 + kHalf));
    else
      split_product_add<64>(dvacc, smem_u32(u2), smem_u32(u2 + kHalf), smem_u32(u3),
                            smem_u32(u3 + kHalf));
  }
  __syncthreads();
  if (tid < 64) csk[tid] = cs_tot;
  __syncthreads();
  // du partial: sum_j cs[j] k[j] over this block's keys, f32, fixed order
  if (tid < 64) {
    const float* kcol = kvb + static_cast<int64_t>(L + f0) * skt + d0 + tid;
    float a = 0.f;
    for (int j = 0; j < 64; ++j) a = fmaf(csk[j], kcol[j * skt], a);
    dub[tid] = a;
  }
  // dK = (dS^T Q + cs u) / sqrt(dk) (warpgroup 0), dV = A_drop^T dctx
  // (warpgroup 1), rows L + f0 + j of the stream
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int jj = ra + 8 * x;
    float* row = ob + jj * sdt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = 8 * i + cb;
      if (wg == 0)
        *reinterpret_cast<float2*>(row + d) =
            make_float2((dkacc[4 * i + 2 * x] + csk[jj] * uf[d0 + d]) * scale,
                        (dkacc[4 * i + 2 * x + 1] + csk[jj] * uf[d0 + d + 1]) * scale);
      else
        *reinterpret_cast<float2*>(row + DK + d) =
            make_float2(dvacc[4 * i + 2 * x], dvacc[4 * i + 2 * x + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int DK>
int launch_fwd(const float* q, const float* kv, const float* pos, const float* u,
               const float* v, const int* lens, float* ctx, float* m, float* den, int B, Geom g,
               Drop drop, const int64_t* s, cudaStream_t stream) {
  const int smem = FwdSmem<DK>::kBytes;
  int err = set_smem(train_fwd_tc_f32_kernel<DK>, smem);
  if (err) return err;
  train_fwd_tc_f32_kernel<DK><<<dim3(B * g.n, g.H, g.c / 64), kBlock, smem, stream>>>(
      q, kv, pos, u, v, lens, ctx, m, den, g, drop, s[0], s[1], s[2], s[3], s[4], s[5], s[6],
      s[7]);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int launch_bwd(const float* q, const float* kv, const float* pos, const float* u,
               const float* v, const int* lens, const float* ctx, const float* m,
               const float* den, const float* dctx, float* delta, float* dq, float* dkv,
               float* dp_part, float* cs_part, float* du_part, float* dp, float* du, float* dv,
               int B, int group, Geom g, Drop drop, const int64_t* s, cudaStream_t stream) {
  const int groups = (B + group - 1) / group;
  int smem = DqSmem<DK>::kBytes;
  int err = set_smem(train_bwd_dq_tc_f32_kernel<DK>, smem);
  if (err) return err;
  train_bwd_dq_tc_f32_kernel<DK><<<dim3(groups, g.H, DK / 64), kBlock, smem, stream>>>(
      q, kv, pos, u, v, lens, ctx, m, den, dctx, delta, dq, dp_part, cs_part, B, group, g, drop,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  smem = DkvSmem<DK>::kBytes;
  err = set_smem(train_bwd_dkv_tc_f32_kernel<DK>, smem);
  if (err) return err;
  const int kv_blocks = B * (g.T() / 64);
  train_bwd_dkv_tc_f32_kernel<DK><<<dim3(kv_blocks, g.H, DK / 64), kBlock, smem, stream>>>(
      q, kv, pos, u, v, lens, m, den, delta, dctx, dkv, du_part, g, drop, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10]);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_partial_sums<float>(dp_part, cs_part, du_part, pos, v, dp, du, dv, groups,
                                    kv_blocks, g, DK, s[6], s[7], stream);
}

}  // namespace

// f32; dk 64 or 128; c a multiple of 64; every row 16-byte aligned; ctx,
// dctx, dq contiguous [B, n*c, H, dk]; m, den, delta contiguous [B, H, n*c]
// (checked by the Python wrapper). Called by cf_chunk_train_attn_tc_fwd and
// _bwd (chunk_attention_train_tc.cu) for f32 inputs, with their arguments.
// Return a cudaError_t (0 = launched).
extern "C" int cf_chunk_train_attn_tc_f32_fwd(const void* q, const void* kv, const void* pos,
                                              const void* u, const void* v, const int* lens,
                                              void* ctx, float* m, float* den, int B, int n,
                                              int H, int c, int dk, int L, int R, uint32_t seed,
                                              uint32_t thresh, float drop_scale, int use_drop,
                                              int h0, int Ht,
                                              int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
                                              int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                              void* stream) {
  if (B == 0 || n == 0) return 0;
  if (c % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{n, H, c, L, R};
  const Drop drop{seed, thresh, drop_scale, use_drop, h0, Ht};
  const int64_t s[8] = {sqb, sqt, sqh, skb, skt, skh, spp, sph};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kvf = static_cast<const float*>(kv);
  const float* pf = static_cast<const float*>(pos);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  float* cf = static_cast<float*>(ctx);
  if (dk == 64) return launch_fwd<64>(qf, kvf, pf, uf, vf, lens, cf, m, den, B, g, drop, s, st);
  if (dk == 128) return launch_fwd<128>(qf, kvf, pf, uf, vf, lens, cf, m, den, B, g, drop, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// group: utterances per dq block. Partials, f32: dp_part [ceil(B / group),
// H, P, dk] and cs_part [ceil(B / group), H, P], both zero; du_part
// [B * n*c / 64, H, dk].
extern "C" int cf_chunk_train_attn_tc_f32_bwd(
    const void* q, const void* kv, const void* pos, const void* u, const void* v,
    const int* lens, const void* ctx, const float* m, const float* den, const void* dctx,
    float* delta, void* dq, void* dkv, float* dp_part, float* cs_part, float* du_part, void* dp,
    void* du, void* dv, int B, int n, int H, int c, int dk, int L, int R, int group,
    uint32_t seed, uint32_t thresh, float drop_scale, int use_drop, int h0, int Ht, int64_t sqb,
    int64_t sqt,
    int64_t sqh, int64_t skb, int64_t skt, int64_t skh, int64_t spp, int64_t sph, int64_t sdb,
    int64_t sdt, int64_t sdh, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (c % 64 != 0 || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{n, H, c, L, R};
  const Drop drop{seed, thresh, drop_scale, use_drop, h0, Ht};
  const int64_t s[11] = {sqb, sqt, sqh, skb, skt, skh, spp, sph, sdb, sdt, sdh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kvf = static_cast<const float*>(kv);
  const float* pf = static_cast<const float*>(pos);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  const float* cf = static_cast<const float*>(ctx);
  const float* gf = static_cast<const float*>(dctx);
  float* dqf = static_cast<float*>(dq);
  float* dkvf = static_cast<float*>(dkv);
  float* dpf = static_cast<float*>(dp);
  float* duf = static_cast<float*>(du);
  float* dvf = static_cast<float*>(dv);
  if (dk == 64)
    return launch_bwd<64>(qf, kvf, pf, uf, vf, lens, cf, m, den, gf, delta, dqf, dkvf, dp_part,
                          cs_part, du_part, dpf, duf, dvf, B, group, g, drop, s, st);
  if (dk == 128)
    return launch_bwd<128>(qf, kvf, pf, uf, vf, lens, cf, m, den, gf, delta, dqf, dkvf,
                           dp_part, cs_part, du_part, dpf, duf, dvf, B, group, g, drop, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
