// f32-accurate products on Hopper's TF32 tensor cores (sm_90a): the split
// of each operand into two TF32 parts and the three-pass products over them,
// shared by the f32 tensor-core attention kernels (chunk_attention_tc_f32.cu
// for decode, chunk_attention_train_tc_f32.cu for training).
//
// The split. One TF32 product keeps 10 mantissa bits (about 5e-4 relative).
// Each operand is split as a = hi + lo with hi = tf32(a) and lo = tf32(a -
// hi), both rounded to nearest (ties away from zero, as cvt.rna.tf32.f32
// rounds, in two integer operations), so the tensor cores read them exactly,
// and a.b is taken as hi.lo' + lo.hi' + hi.hi' (lo.lo' is below 2^-22):
// about 21 bits, f32-class (tests/test_torch_tf32_split.py emulates the
// products on the CPU against the f64 result).
//
// Accumulation. The tensor cores' f32 sums truncate, so every product here
// starts from fresh accumulators, the small products in one and hi.hi' in
// another, and the caller adds the results in f32 on the CUDA cores, which
// round to nearest.
//
// Layout: an f32 [64][K] operand tile is stored as K/32 swizzled [64][32]
// sub-tiles of 8 KB (128-byte rows, the swizzle atom), addressed by swz(r,
// ch) with ch = column / 4, so desc_kmajor(tile, kk) names k-step kk
// (columns [8kk, 8kk + 8)). A split pair is the hi tile and the lo tile.
// TF32 wgmma takes both shared operands K-major only (PTX has no transpose
// bits for 32-bit types); an operand needed MN-major is transposed by the
// threads on its way into its pair.

#pragma once

#include "hopper_tc.cuh"

namespace {

constexpr int kWg = 128;  // threads of a warpgroup

template <int DK>
constexpr int kPart = DK / 4 + 4;  // row stride of the dot shares: 16-byte aligned, padded

// f32 rounded to the nearest TF32 (ties away from zero), low 13 bits zero:
// what cvt.rna.tf32.f32 gives a finite input, in two integer operations
// (the sign and magnitude bits of a float round like an unsigned integer)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split4(const float4 x, float4& h, float4& l) {
  h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  l = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z),
                  tf32_rna(x.w - h.w));
}

// Split a landed [64][DK] tile into its hi and lo tiles (the same swizzled
// layout), by one warpgroup. With DOT, also each 16-byte chunk's share of
// row r . w (w: shared f32 [DK]) in f32 from the unsplit values, into
// part[r][ch] (rows kPart floats apart; sum_parts adds them up). The kChunks
// lanes of a row are consecutive, so each 8-lane phase of a 16-byte access
// touches one row's 8 distinct chunks.
template <int DK, bool DOT>
__device__ __forceinline__ void split_rows(const uint8_t* src, uint8_t* hi, uint8_t* lo,
                                           const float* w, float* part, int tid) {
  constexpr int kChunks = DK / 4;
  const int ch = tid % kChunks;
  float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (DOT) w4 = reinterpret_cast<const float4*>(w)[ch];
#pragma unroll
  for (int k = 0; k < 64 * kChunks / kWg; ++k) {
    const int r = (tid + k * kWg) / kChunks;
    const uint32_t off = swz(r, ch);
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    float4 h, l;
    split4(x, h, l);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
    if (DOT) {
      float acc = x.x * w4.x;
      acc = fmaf(x.y, w4.y, acc);
      acc = fmaf(x.z, w4.z, acc);
      acc = fmaf(x.w, w4.w, acc);
      part[r * kPart<DK> + ch] = acc;
    }
  }
}

// dot[r] = sum over ch of part[r][ch], for the 64 rows (threads 0-63)
template <int DK>
__device__ __forceinline__ void sum_parts(const float* part, float* dot, int tid) {
  if (tid < 64) {
    const float4* row = reinterpret_cast<const float4*>(part + tid * kPart<DK>);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DK / 16; ++i) {
      const float4 x = row[i];
      acc += (x.x + x.y) + (x.z + x.w);
    }
    dot[tid] = acc;
  }
}

__device__ __forceinline__ float pick(const float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Transpose a landed V tile [64 keys][DK] into the hi and lo tiles of V^T
// (by THREADS threads), the K-major B operand of O += P V: [DK rows][64
// keys] as two [DK][32] sub-tiles DK * 128 bytes apart. Columns 4cg .. 4cg + 3 hold keys
// 8(cg / 2) + 2m + cg % 2 (m = 0..3), the key order of P's A fragments
// (acc_to_tf32). An item is 4 keys x 4 dk; an 8-lane phase reads one key
// row's 8 distinct chunks, and writes rows whose d % 8 differ (the rr
// rotation), so neither side has bank conflicts.
template <int DK, int THREADS = kWg>
__device__ __forceinline__ void split_vt(const uint8_t* src, uint8_t* hi, uint8_t* lo, int tid) {
  constexpr int kDg = DK / 4;  // groups of 4 dk
  constexpr uint32_t kSub = DK * 128;
#pragma unroll
  for (int k = 0; k < kDg * 16 / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int dg = i % kDg, cg = i / kDg;
    const int key0 = 8 * (cg >> 1) + (cg & 1);
    float4 x[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      x[m] = *reinterpret_cast<const float4*>(src + swz(key0 + 2 * m, dg));
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int rr = ((dg >> 1) + mm) & 3;
      const int d = 4 * dg + rr;
      const float4 v = make_float4(pick(x[0], rr), pick(x[1], rr), pick(x[2], rr),
                                   pick(x[3], rr));
      const uint32_t off = (cg >> 3) * kSub + d * 128 + (((cg & 7) ^ (d & 7)) << 4);
      float4 h, l;
      split4(v, h, l);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
}

// d[64 x 64] = A B^T over K columns of the split pairs (A and B [64][K],
// K-major): the small products Ahi.Blo + Alo.Bhi into one fresh
// accumulator, Ahi.Bhi into another, summed in f32 at the end
template <int K>
__device__ __forceinline__ void split_product(float (&d)[32], uint32_t qh, uint32_t ql,
                                              uint32_t bh, uint32_t bl) {
  float dc[32];
  fence_regs(d);
  fence_regs(dc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss_n64(dc, desc_kmajor(qh, kk), desc_kmajor(bl, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss_n64(dc, desc_kmajor(ql, kk), desc_kmajor(bh, kk), 1);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_tf32_ss_n64(d, desc_kmajor(qh, kk), desc_kmajor(bh, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
  fence_regs(dc);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += dc[i];
}

// d += A B^T over K columns, from a fresh product added in f32
template <int K>
__device__ __forceinline__ void split_product_add(float (&d)[32], uint32_t ah, uint32_t al,
                                                  uint32_t bh, uint32_t bl) {
  float t[32];
  split_product<K>(t, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += t[i];
}

// o += sum over passes of A_pass B^T_pass over 64 K columns, A from
// registers, B [DK][64] K-major (two [DK][32] sub-tiles DK * 128 bytes
// apart), from a fresh accumulator added to o in f32
template <int DK, int PASSES>
__device__ __forceinline__ void pv_product(float (&o)[DK / 2], const uint32_t (&a0)[8][4],
                                           uint32_t b0, const uint32_t (&a1)[8][4],
                                           uint32_t b1) {
  float ot[DK / 2];
  fence_regs(ot);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = desc_kmajor_tf32(pass ? b1 : b0, kk, DK * 128);
      if constexpr (DK == 64)
        wgmma_tf32_rs_n64(ot, pass ? a1[kk] : a0[kk], db, pass + kk > 0);
      else
        wgmma_tf32_rs_n128(ot, pass ? a1[kk] : a0[kk], db, pass + kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(ot);
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) o[i] += ot[i];
}

// o += A B^T, A's split fragments in registers (acc_to_tf32), B's pair: the
// small products Ahi.Blo + Alo.Bhi, then Ahi.Bhi, each from a fresh
// accumulator
template <int DK>
__device__ __forceinline__ void split_product_rs(float (&o)[DK / 2], const uint32_t (&ah)[8][4],
                                                 const uint32_t (&al)[8][4], uint32_t bh,
                                                 uint32_t bl) {
  pv_product<DK, 2>(o, ah, bl, al, bh);
  pv_product<DK, 1>(o, ah, bh, ah, bh);
}

// The split A fragments of a 64 x 64 f32 accumulator (rows ra and ra + 8,
// columns 8i + cb and 8i + cb + 1 a thread). The m64k8 A fragment holds
// columns (t, t + 4) of each group of 8, the accumulator (2t, 2t + 1): so A
// column k of k-step kk stands for column 8kk + 2(k % 4) + k / 4, and the
// registers move unpermuted; the B operand's K columns take the same order
// (split_vt, and load_pair_t<true> in the training kernels).
__device__ __forceinline__ void acc_to_tf32(const float (&s)[32], uint32_t (&ah)[8][4],
                                            uint32_t (&al)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float v4[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float hv = tf32_rna(v4[x]);
      ah[kk][x] = __float_as_uint(hv);
      al[kk][x] = __float_as_uint(tf32_rna(v4[x] - hv));
    }
  }
}

}  // namespace
