// Kaldi log-mel filterbank features for Hopper (sm_90a).
//
// Replaces the TPU kernel fbank_pallas (chunkformer_tpu/ops/pallas/fbank.py:43):
// framing (snip_edges) -> per-frame DC removal -> preemphasis 0.97 (the first
// sample against itself) -> window -> real DFT of the zero-padded frame,
// computed in the kernel's own body in full f32 as a product with cos/sin
// tables -> power -> mel product -> log(max(., 1.1920929e-07)).
// Dither is 0 (decode-time features).
//
// What bounds it on an H100: it reads 4 bytes and writes 320 bytes per frame
// (160 new samples, 80 log-mel values) but does about 2 * 2 * 400 * 257
// = 411 kFLOP of DFT per frame in f32, so it is bound by operations: about
// 0.74 ms for 20 minutes of 16 kHz audio (~120 k frames) at 67 TFLOP/s f32.
// The TPU kernel ran the DFT on the MXU at HIGHEST precision because the MXU's
// bf16 passes are too coarse for int16-scale audio followed by a log; the
// same reason keeps this kernel off the bf16/TF32 tensor cores.
//
// Design (simple and right first): one block per tile of kFrames = 32 frames,
// one thread per DFT bin (at most 288 threads; a wider spectrum is taken in
// passes). The windowed frames sit in shared memory
// transposed ([sample][frame]) so that a thread reads eight frames' samples
// with one float4 broadcast load and keeps 2 * 32 accumulators in registers;
// the cos/sin tables ([win][n_bins], 822 KB for 400 x 257) are read with
// coalesced loads and stay resident in L2 across blocks. Power spectra then
// go through the mel matrix and the log.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;
constexpr int kMaxThreads = 288;  // a block of 288 threads launches (257 bins at 512 points)
constexpr float kPreemph = 0.97f;
constexpr float kEps = 1.1920928955078125e-07f;

__global__ void fbank_kernel(const float* __restrict__ wave,
                             const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t,
                             const float* __restrict__ window,
                             const float* __restrict__ mel,
                             float* __restrict__ out, int n_frames, int win,
                             int shift, int n_bins, int n_mels) {
  extern __shared__ float smem[];
  float* raw = smem;                    // [kFrames][win]; later power [kFrames][n_bins]
  float* wt = raw + kFrames * win;      // [win][kFrames] windowed frames, transposed
  float* mean = wt + kFrames * win;     // [kFrames]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t0 = blockIdx.x * kFrames;

  for (int i = tid; i < kFrames * win; i += nthreads) {
    const int f = i / win, s = i % win;
    raw[i] = (t0 + f < n_frames) ? wave[(int64_t)(t0 + f) * shift + s] : 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int f = warp; f < kFrames; f += nthreads / 32) {
    float s = 0.f;
    for (int i = lane; i < win; i += 32) s += raw[f * win + i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) mean[f] = s / (float)win;
  }
  __syncthreads();

  for (int i = tid; i < kFrames * win; i += nthreads) {
    const int f = i / win, s = i % win;
    const float m = mean[f];
    const float x = raw[i] - m;
    const float prev = raw[f * win + (s > 0 ? s - 1 : 0)] - m;
    wt[s * kFrames + f] = (x - kPreemph * prev) * window[s];
  }
  __syncthreads();

  for (int k = tid; k < n_bins; k += nthreads) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
    for (int s = 0; s < win; ++s) {
      const float cs = cos_t[(int64_t)s * n_bins + k];
      const float sn = sin_t[(int64_t)s * n_bins + k];
      const float4* w4 = reinterpret_cast<const float4*>(wt + s * kFrames);
#pragma unroll
      for (int g = 0; g < kFrames / 4; ++g) {
        const float4 w = w4[g];
        re[4 * g + 0] = fmaf(w.x, cs, re[4 * g + 0]);
        re[4 * g + 1] = fmaf(w.y, cs, re[4 * g + 1]);
        re[4 * g + 2] = fmaf(w.z, cs, re[4 * g + 2]);
        re[4 * g + 3] = fmaf(w.w, cs, re[4 * g + 3]);
        im[4 * g + 0] = fmaf(w.x, sn, im[4 * g + 0]);
        im[4 * g + 1] = fmaf(w.y, sn, im[4 * g + 1]);
        im[4 * g + 2] = fmaf(w.z, sn, im[4 * g + 2]);
        im[4 * g + 3] = fmaf(w.w, sn, im[4 * g + 3]);
      }
    }
    float* power = raw;  // raw is dead after the windowing pass
#pragma unroll
    for (int f = 0; f < kFrames; ++f) power[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int i = tid; i < kFrames * n_mels; i += nthreads) {
    const int f = i / n_mels, m = i % n_mels;
    if (t0 + f >= n_frames) continue;
    const float* pw = raw + f * n_bins;
    float s = 0.f;
    for (int k = 0; k < n_bins; ++k) s = fmaf(pw[k], mel[k * n_mels + m], s);
    out[(int64_t)(t0 + f) * n_mels + m] = logf(fmaxf(s, kEps));
  }
}

}  // namespace

// All pointers are float32 on the device; tables are [win][n_bins] (cos, sin),
// [win] (window) and [n_bins][n_mels] (mel). Returns a cudaError_t.
extern "C" int cf_fbank(const float* wave, const float* cos_t, const float* sin_t,
                        const float* window, const float* mel, float* out,
                        int n_frames, int win, int shift, int n_bins, int n_mels,
                        void* stream) {
  if (n_frames == 0) return 0;
  if (n_bins > win || n_bins > 1024) return (int)cudaErrorInvalidValue;
  // a thread per bin up to kMaxThreads; past that the bin loop takes the
  // bins in passes of equal width (2 * kFrames accumulators a thread leave
  // no registers for 544 threads, the 513 bins of a 1024-point window:
  // cudaError 701)
  const int passes = (n_bins + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((n_bins + passes - 1) / passes + 31) / 32 * 32;
  const size_t smem = sizeof(float) * ((size_t)2 * kFrames * win + kFrames);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  fbank_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      wave, cos_t, sin_t, window, mel, out, n_frames, win, shift, n_bins, n_mels);
  return (int)cudaGetLastError();
}
