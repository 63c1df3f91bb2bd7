// The float64 complex arithmetic and small DFTs of the FFT fbank kernels
// (fbank_fft.cu: a warp a frame, padded windows of up to 4096 points;
// fbank_fft_block.cu: a block a frame, above 4096 points), and the constants
// of the Kaldi features they compute.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kPreemph = 0.97f;
constexpr float kEps = 1.1920928955078125e-07f;
constexpr double kSqrtHalf = 0.70710678118654752440;

__device__ __forceinline__ double2 cx(double re, double im) { return make_double2(re, im); }
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return cx(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return cx(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 cmul(double2 a, double2 w) {
  return cx(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ double2 mul_neg_i(double2 a) { return cx(a.y, -a.x); }
// a * exp(-2 pi i / 8) and a * exp(-2 pi i 3 / 8)
__device__ __forceinline__ double2 mul_w8(double2 a) {
  return cx((a.x + a.y) * kSqrtHalf, (a.y - a.x) * kSqrtHalf);
}
__device__ __forceinline__ double2 mul_w8_3(double2 a) {
  return cx((a.y - a.x) * kSqrtHalf, -(a.x + a.y) * kSqrtHalf);
}

// in-place 4-point DFT, natural order in and out
__device__ __forceinline__ void dft4(double2* a) {
  const double2 b0 = cadd(a[0], a[2]), b2 = csub(a[0], a[2]);
  const double2 b1 = cadd(a[1], a[3]), b3 = mul_neg_i(csub(a[1], a[3]));
  a[0] = cadd(b0, b1);
  a[1] = cadd(b2, b3);
  a[2] = csub(b0, b1);
  a[3] = csub(b2, b3);
}

// in-place 8-point DFT: one radix-2 step, then a 4-point DFT of the sums
// (even outputs) and of the twiddled differences (odd outputs)
__device__ __forceinline__ void dft8(double2* a) {
  double2 e[4], o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = cadd(a[j], a[j + 4]);
    o[j] = csub(a[j], a[j + 4]);
  }
  o[1] = mul_w8(o[1]);
  o[2] = mul_neg_i(o[2]);
  o[3] = mul_w8_3(o[3]);
  dft4(e);
  dft4(o);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] = e[q];
    a[2 * q + 1] = o[q];
  }
}

// in-place 2-point DFT
__device__ __forceinline__ void dft2(double2* a) {
  const double2 b = csub(a[0], a[1]);
  a[0] = cadd(a[0], a[1]);
  a[1] = b;
}

template <int Radix>
__device__ __forceinline__ void dft(double2* a) {
  if constexpr (Radix == 8) dft8(a);
  else if constexpr (Radix == 4) dft4(a);
  else dft2(a);
}

}  // namespace
