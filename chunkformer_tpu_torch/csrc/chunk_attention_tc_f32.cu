// Relative-position chunk attention for decode on Hopper tensor cores
// (sm_90a), f32 inputs, with 3xTF32 split products.
//
// Replaces the TPU kernel chunk_attention_pallas_union_hmajor
// (chunkformer_tpu/ops/pallas/chunk_attention.py:335), with its row-major
// wrapper (:306) and the per-chunk and G-batched variants (:32, :158), for
// f32 inputs with head_dim 64 or 128 at any chunk size and 16-byte-aligned
// rows: the main path's shapes when a model decodes in f32, the default
// precision of ChunkFormerModel, and any --chunk_size a user picks. It
// computes the function of chunk_attention.cu (the CUDA-core kernel, which
// keeps other head dims and strides) and of chunk_attention_tc.cu (its bf16
// twin):
//   s[r, j] = ((q[r] + u) . k[j] + (q[r] + v) . p[c - 1 - r + j]) / sqrt(dk)
//   valid(j)  iff  -offset[n] <= chunk_idx[n]*c - L + j < max_len[n]
//   out[r]    = softmax_j(s[r, j] | valid) . v[j]      (all-masked row -> 0)
// to the f32 bar (1e-5 absolute against the plain f32 version).
//
// The split and the accumulation are tf32_split.cuh's: each operand as two
// TF32 parts, three products (hi.lo' + lo.hi' + hi.hi', about 21 bits, where
// one TF32 product keeps 10), each from fresh accumulators added in f32 on
// the CUDA cores, since the tensor cores' sums truncate. Summed into one
// accumulator over the three passes, and into O over every tile, the
// truncations of some 120 wgmma steps missed the 1e-5 bar on the card (a
// first version).
//
// What bounds it on an H100: at the ChunkFormer-large segment (N = 209,
// H = 8, c = 64, dk = 64, L = R = 128) one call must move about 110 MB of
// f32 (q, the KV stream and the output once each), 33 us at 3.35 TB/s, and
// its three products over the valid keys are 13.1 GFLOP; split three ways
// that is 39.3 GFLOP of TF32, 79 us at 495 TFLOP/s. So the f32-accurate
// work on the tensor cores is bound by operations at about 0.079 ms (the
// same work on the CUDA cores at 67 TFLOP/s: 0.195 ms).
//
// Design: the bf16 kernel's (a block per (chunk row n, head h, tile of 64
// query rows), the last tile of a chunk partial when 64 does not divide c:
// its rows past the chunk load as zeros, into the producer's landing buffer
// and so into Q's hi/lo pair, and are not stored; key tiles of 64 over the
// valid interval [lo, hi); the split bias form q.k + u.k and q.p + v.p with
// u.k and v.p as f32 dot products; each 64-row positional block's product
// BD' computed once and staged in f32 for the skewed rel-shift read, the
// positional rows below 0 that a partial tile's padding rows reach
// zero-filled), with what f32 on TF32 forces:
// - K-major only. TF32 wgmma takes both shared operands K-major. Q K^T and
//   Q P^T are K-major as loaded (dk contiguous). O = P V needs V^T [dk][keys]
//   with keys contiguous, so the V tile is transposed by the threads on its
//   way from its landing buffer into the operand tiles.
// - P from registers. The m64k8 A fragment holds columns (t, t + 4) of each
//   group of 8 keys, the S accumulator columns (2t, 2t + 1). So A column k
//   stands for key 2(k % 4) + k / 4 of its group: the accumulator registers
//   become A registers unmoved, and the transpose writes V^T's columns in
//   the same order (the sum over keys does not care).
// - The split, by a second warpgroup. A block is two warpgroups: a producer
//   lands every operand raw by cp.async (16 bytes a thread, zero fill past
//   the window, the 128-byte swizzle: an f32 [64][32] sub-tile has 128-byte
//   rows, the swizzle atom) and writes its hi and lo tiles, with each
//   thread's share of u.k or v.p (from the unsplit values) going to shared
//   memory for 64 threads to add up; the consumer runs the products, the
//   softmax and the output. They hand operands over through hi/lo pairs
//   with named barriers (full, empty). The operands form one stream: Q (its
//   own pair, resident), then per key tile K_t, positional block t + 1, V_t.
//   Shared memory, dk = 64: Q pair 32 KB + two operand pairs 64 KB + two
//   landing buffers 32 KB + two f32 staging slots 36 KB + 7.5 KB = 171.5 KB
//   (one block an SM); dk = 128: one operand pair and one landing buffer,
//   208 KB, so there the producer splits the next operand only once the
//   consumer is done with the last. Double-buffered hi/lo pairs for each of
//   K, V^T and P would need 226 KB at dk = 64 before Q.
// - Online softmax in f32 in the accumulator registers (the bf16 kernel's
//   softmax_tile), with 1/sqrt(dk) applied after the products.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, the shape above):
// 0.34 ms, 6.4x faster than the CUDA-core kernel and 4.3x the 0.079 ms
// bound. One block an SM, each warpgroup waits on the other at every
// hand-off; where the rest of the time goes is not measured yet (PERF.md).
// A first version, whose one warpgroup split each operand and then ran its
// products, was slower.
// Not done: TMA, a persistent grid, a second consumer warpgroup.

#include "tf32_split.cuh"

namespace {

constexpr int kThreads = 128;  // a warpgroup: the consumer's, and the producer's
constexpr int kBlock = 2 * kThreads;
// named barriers (0 is __syncthreads)
constexpr int kBarQ = 1;       // Q's pair is split
constexpr int kBarProd = 2;    // the producer warpgroup alone
constexpr int kBarCons = 3;    // the consumer warpgroup alone
constexpr int kBarFull = 4;    // + slot (< 2): the slot's pair holds the next element
constexpr int kBarEmpty = 8;   // + slot (< 2): the consumer is done with the slot's pair

template <int DK>
struct Smem {
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

// ---------------------------------------------------------------- kernel

template <int DK>
__global__ void __launch_bounds__(kBlock)
chunk_attention_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                              const float* __restrict__ pos, const float* __restrict__ bias_u,
                              const float* __restrict__ bias_v,
                              const int* __restrict__ chunk_idx, const int* __restrict__ offsets,
                              const int* __restrict__ max_lens, float* __restrict__ out,
                              int c, int L, int R,
                              int64_t sqn, int64_t sqr, int64_t sqh,
                              int64_t skt, int64_t skh,
                              int64_t spp, int64_t sph,
                              int64_t son, int64_t sor, int64_t soh) {
  using S = Smem<DK>;
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

  const int n = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * 64;
  const int rows = min(64, c - r0);  // query rows of this tile in the chunk
  const int tid = threadIdx.x;
  const int W = L + c + R;
  const int p_rows = 2 * c - 1 + L + R;
  const int ci = chunk_idx[n];
  const int lo = max(0, L - ci * c - offsets[n]);
  const int hi = min(W, max_lens[n] - ci * c + L);
  float* ob = out + n * son + h * soh + static_cast<int64_t>(r0) * sor;

  if (hi <= lo) {  // no valid key: the rows are 0
    for (int i = tid; i < rows * DK / 2; i += kBlock) {
      const int r = i / (DK / 2), d = 2 * (i % (DK / 2));
      *reinterpret_cast<float2*>(ob + r * sor + d) = make_float2(0.f, 0.f);
    }
    return;
  }
  const int n_tiles = (hi - lo + 63) / 64;
  // positional block b holds rows [pb0 + 64b, pb0 + 64b + 64); key tile t
  // needs blocks t and t + 1, and S_bd[r, j] = BD'[r, 63 - r + j] over them
  // (in a partial tile pb0 may be negative: those rows zero-fill)
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
    const float* qb = q + n * sqn + h * sqh + static_cast<int64_t>(r0) * sqr;
    const float* kb = kv + static_cast<int64_t>(n) * c * skt + h * skh;
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
          load_tile<DK>(dst, qb, sqr, 0, rows, ptid);  // zeros past the chunk
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
  float b[32];
  uint32_t bh = acquire(1);
  split_product<DK>(b, qh, ql, bh, bh + kTile);
  release(1);
  stage_block(b, stg, vp, ra, cb);

  float o[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const float scale_log2 = 1.4426950408889634f * rsqrtf(static_cast<float>(DK));

  for (int t = 0; t < n_tiles; ++t) {
    const int e = 2 + 3 * t;
    float s[32];
    bh = acquire(e);  // K_t
    split_product<DK>(s, qh, ql, bh, bh + kTile);
    release(e);
    bh = acquire(e + 1);  // positional block t + 1
    split_product<DK>(b, qh, ql, bh, bh + kTile);
    release(e + 1);
    stage_block(b, stg + ((t + 1) & 1) * kSlot, vp + 64 * ((t + 1) & 1), ra, cb);
    bar_sync(kBarCons, kThreads);

    softmax_tile<DK>(s, o, m_run, l_run, stg + (t & 1) * kSlot, stg + ((t + 1) & 1) * kSlot,
                     uk + 64 * (t & 1), ra, cb, lo + 64 * t, hi, scale_log2);

    // P's split A fragments: k-step kk takes keys [8kk, 8kk + 8) in the
    // order 0, 2, 4, 6, 1, 3, 5, 7 (A columns t, t + 4 <- keys 2t, 2t + 1)
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
  }
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (ra + 8 * x < rows)  // rows past the chunk are not stored
        *reinterpret_cast<float2*>(ob + (ra + 8 * x) * sor + 8 * i + cb) =
            make_float2(o[4 * i + 2 * x] * inv[x], o[4 * i + 2 * x + 1] * inv[x]);
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
  cudaError_t err = cudaFuncSetAttribute(chunk_attention_tc_f32_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N, H, (c + 63) / 64);  // the last tile of a chunk may be partial
  chunk_attention_tc_f32_kernel<DK><<<grid, kBlock, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv),
      static_cast<const float*>(pos), static_cast<const float*>(u),
      static_cast<const float*>(v), ci, off, ml, static_cast<float*>(out), c, L, R, sqn, sqr,
      sqh, skt, skh, spp, sph, son, sor, soh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32; dk 64 or 128; any c >= 1; every row 16-byte aligned (checked
// by the Python wrapper). Called by cf_chunk_attention_tc for f32 inputs.
// Returns a cudaError_t (0 = launched).
extern "C" int cf_chunk_attention_tc_f32(const void* q, const void* kv, const void* pos,
                                         const void* u, const void* v, const int* chunk_idx,
                                         const int* offsets, const int* max_lens, void* out,
                                         int N, int H, int c, int dk, int L, int R,
                                         int64_t sqn, int64_t sqr, int64_t sqh,
                                         int64_t skt, int64_t skh, int64_t spp, int64_t sph,
                                         int64_t son, int64_t sor, int64_t soh, void* stream) {
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
