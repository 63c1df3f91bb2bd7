// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels (chunk_attention_tc.cu and chunk_attention_tc_f32.cu for decode,
// chunk_attention_train_tc.cu and chunk_attention_train_tc_f32.cu for
// training; the f32 kernels' split is in tf32_split.cuh): shared-memory
// addresses and the 128-byte swizzle, cp.async, the wgmma fences,
// shared-memory descriptors and products (bf16, and TF32 for the split f32
// products), bf16 packing, and the swizzled tile copies, dot products and
// rel-shift staging that those kernels build on.
//
// Tile layout: a [64][DK] bf16 tile is stored as DK/64 sub-tiles of
// [64 rows][64 bf16] (8 KB, 128-byte rows) in the 128-byte swizzle that
// wgmma's descriptors name (16-byte chunk index XOR row % 8). The same
// tile serves as a K-major operand (rows along M or N, the 64 columns along
// K) and as an MN-major one (rows along K, columns along M or N).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStage = 72;  // f32 row stride of a 64-row staging slot

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk ch of row r in a [64][DK] bf16 tile stored as
// DK/64 swizzled [64][64] sub-tiles of 8 KB.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return static_cast<uint32_t>((ch >> 3) * 8192 + r * 128 + (((ch & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make this thread's generic-proxy shared writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows of the tile along M or N, columns along K): k-step
// kk covers columns [16kk, 16kk + 16); 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (rows of the tile along K, columns along M or N): k-step
// kk covers rows [16kk, 16kk + 16); 8-row groups 1024 bytes apart, 64-column
// swizzle atoms along M or N 8192 bytes apart
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, 8192, 1024);
}

#define CF_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CF_ACC32 CF_ACC8(0), CF_ACC8(8), CF_ACC8(16), CF_ACC8(24)
#define CF_ACC64 CF_ACC32, CF_ACC8(32), CF_ACC8(40), CF_ACC8(48), CF_ACC8(56)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both in shared memory; TA / TB = 1
// for an MN-major A / B (0: K-major)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : CF_ACC32
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both in shared memory
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : CF_ACC64
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[64 x DK] (+)= A[64 x 16] B[16 x DK], both in shared memory
template <int DK, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_dk(float (&d)[DK / 2], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (DK == 64)
    wgmma_ss_n64<TA, TB>(d, da, db, accumulate);
  else
    wgmma_ss_n128<TA, TB>(d, da, db, accumulate);
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CF_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128] (MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CF_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x DK] += A[64 x 16] (registers) B[16 x DK] (MN-major in shared memory)
template <int DK>
__device__ __forceinline__ void wgmma_pv(float (&o)[DK / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DK == 64)
    wgmma_rs_n64(o, a, db);
  else
    wgmma_rs_n128(o, a, db);
}

// ---------------------------------------------------------------- TF32
//
// TF32 wgmma (k8: 32 bytes of K a step, as bf16's k16) takes both shared
// operands K-major only: PTX has no transpose bits for 32-bit types. A
// [64][32] f32 sub-tile has 128-byte rows, the swizzle atom, so an f32
// [64][DK] tile stored as DK/32 such sub-tiles (8 KB apart) is addressed by
// swz(r, ch) with ch = col / 4, and desc_kmajor(tile, kk) names k-step kk
// (columns [8kk, 8kk + 8)) of it. The A fragment in registers of m64k8
// holds, per thread, rows ra and ra + 8 at columns t and t + 4 (t = lane
// % 4): a0 (ra, t), a1 (ra + 8, t), a2 (ra, t + 4), a3 (ra + 8, t + 4).

// named barriers: bar_sync waits until n threads (a multiple of 32) have
// reached barrier id by bar_sync or bar_arrive; bar_arrive does not wait
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// K-major operand whose 32-column sub-tiles are sub_bytes apart (a [ROWS][64]
// f32 tile: sub_bytes = ROWS * 128): k-step kk covers columns [8kk, 8kk + 8)
__device__ __forceinline__ uint64_t desc_kmajor_tf32(uint32_t tile, int kk, uint32_t sub_bytes) {
  return make_desc(tile + (kk >> 2) * sub_bytes + (kk & 3) * 32, 16, 1024);
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], TF32, both K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : CF_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] (registers) B[8 x 64] (K-major in shared memory), TF32
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : CF_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 8] (registers) B[8 x 128] (K-major in shared memory), TF32
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : CF_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of k-step kk (columns [16kk, 16kk + 16)) from a 64 x 64
// f32 accumulator, rounded to bf16
__device__ __forceinline__ void acc_to_a(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------- tiles

// Copy rows [row0, row0 + 64) of a row-strided bf16 or f32 matrix
// (row_stride elements apart, DK contiguous) into a swizzled tile; rows
// outside [0, row_end) are zero-filled.
template <int DK, int THREADS = 128, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* base, int64_t row_stride,
                                          int row0, int row_end, int tid) {
  constexpr int kPerChunk = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = DK / kPerChunk;    // 16-byte chunks a row
#pragma unroll
  for (int k = 0; k < 64 * kChunks / THREADS; ++k) {
    const int i = tid + k * THREADS;
    const int r = i / kChunks, ch = i % kChunks;
    const int g = row0 + r;
    const bool ok = g >= 0 && g < row_end;
    const T* src = ok ? base + static_cast<int64_t>(g) * row_stride + ch * kPerChunk : base;
    cp_async16(dst + swz(r, ch), src, ok ? 16 : 0);
  }
}

// f32 dot product of row r of a swizzled tile with w[DK] (shared, f32)
template <int DK>
__device__ __forceinline__ float dot_row(const uint8_t* tile, int r, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.f;
#pragma unroll
  for (int ch = 0; ch < DK / 8; ++ch) {
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + swz(r, ch));
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 wa = w4[2 * ch], wb = w4[2 * ch + 1];
    const float2 f0 = __bfloat1622float2(p2[0]), f1 = __bfloat1622float2(p2[1]);
    const float2 f2 = __bfloat1622float2(p2[2]), f3 = __bfloat1622float2(p2[3]);
    acc = fmaf(f0.x, wa.x, acc);
    acc = fmaf(f0.y, wa.y, acc);
    acc = fmaf(f1.x, wa.z, acc);
    acc = fmaf(f1.y, wa.w, acc);
    acc = fmaf(f2.x, wb.x, acc);
    acc = fmaf(f2.y, wb.y, acc);
    acc = fmaf(f3.x, wb.z, acc);
    acc = fmaf(f3.y, wb.w, acc);
  }
  return acc;
}

// element (r, col) of a swizzled bf16 tile, as f32
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int col) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(tile + swz(r, col >> 3) + (col & 7) * 2));
}

// The 64 x 64 product BD_b = Q P_b^T of one positional block, plus v.p_m on
// column m, into a staging slot (f32 rows kStage apart): float2 stores, free
// of bank conflicts at kStage = 8 (mod 32). Accumulator layout: this thread
// holds rows ra and ra + 8, columns 8i + cb and 8i + cb + 1.
__device__ __forceinline__ void stage_block(const float (&b)[32], float* dst, const float* vp,
                                            int ra, int cb) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = 8 * i + cb;
    const float2 w = *reinterpret_cast<const float2*>(vp + m);
    *reinterpret_cast<float2*>(dst + ra * kStage + m) = make_float2(b[4 * i] + w.x,
                                                                    b[4 * i + 1] + w.y);
    *reinterpret_cast<float2*>(dst + (ra + 8) * kStage + m) =
        make_float2(b[4 * i + 2] + w.x, b[4 * i + 3] + w.y);
  }
}

// One key tile of the decode attention's online softmax, on the S
// accumulator: s[4i + 2x + e] (row ra + 8x, key column 8i + cb + e) becomes
// the log2-domain score (s + u.k_j + BD'[r, 63 - r + j]) * scale_log2,
// masked past hi, then its unnormalised probability against the running row
// max; m_run, l_run and the context accumulator o are rescaled. BD' is read
// skewed from the staging slots of positional blocks t (columns < 64,
// stg_lo) and t + 1 (stg_hi). The tile must hold a valid key.
template <int DK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[DK / 2],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const float* stg_lo, const float* stg_hi,
                                             const float* uk, int ra, int cb, int j0, int hi,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 ukj = *reinterpret_cast<const float2*>(uk + 8 * i + cb);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = 8 * i + cb + e;
      const bool ok = j0 + jj < hi;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int rr = ra + 8 * x;
        const int idx = 63 - rr + jj;
        const float bd = (idx < 64 ? stg_lo : stg_hi)[rr * kStage + (idx & 63)];
        const float v = (s[4 * i + 2 * x + e] + (e ? ukj.y : ukj.x) + bd) * scale_log2;
        s[4 * i + 2 * x + e] = ok ? v : -INFINITY;
        mx[x] = fmaxf(mx[x], s[4 * i + 2 * x + e]);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    const float m_new = fmaxf(m_run[x], mx[x]);  // finite: the tile has a valid key
    alpha[x] = exp2f(m_run[x] - m_new);
    m_run[x] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = exp2f(s[4 * i + 2 * x + e] - m_run[x]);
        s[4 * i + 2 * x + e] = pr;
        ls[x] += pr;
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

}  // namespace
