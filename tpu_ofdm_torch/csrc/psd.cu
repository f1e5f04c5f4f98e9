// Windowed PSD frames: window (normalization folded in), N-point DFT and
// |.|^2 in one pass over the sample stream.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/psd.py (built by
// _build_call).  The TPU kernel emitted k1-major (Z-order) bins and needed
// an XLA transpose afterwards, and ran its 128-point stage as a bf16 hi/lo
// matmul; both were Mosaic/MXU workarounds.  Here bins come out in natural
// order and everything is float32.
//
// Semantics (spectrum.psd.psd_frames): frame f, bin k,
//   out[f, k] = |sum_n x[f N + n] w[n] exp(-2 pi i n k / N)|^2
// with w = window / sqrt(sum(window^2) * N), folded on the host in float64.
//
// Bound on this card: device-memory traffic, 12 bytes per sample (8 in, 4
// out); the FFT costs ~5 log2(N) flops per sample from shared memory.
// Design, kept simple: one CTA of 256 threads owns ~4096 samples
// (4096 / N frames); each thread loads and windows one (frame, t2) column
// of the DFT plan (coalesced), runs the direct n1-point stage in registers
// and the radix-2 stage in shared memory (dft.cuh), then writes |.|^2.
#include <cuda_runtime.h>

#include "dft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;

using tpu_ofdm::DftPlan;
using tpu_ofdm::kMaxN1;

__global__ void __launch_bounds__(kThreads)
psd_kernel(const float2* __restrict__ x, const float* __restrict__ w,
           DftPlan p, int fpc, long long nf, float* __restrict__ out) {
  extern __shared__ float2 smem[];
  float2* W = smem;
  float2* buf = smem + p.N;
  tpu_ofdm::dft_table(W, p);
  __syncthreads();

  const long long f0 = static_cast<long long>(blockIdx.x) * fpc;
  for (int g = threadIdx.x; g < fpc * p.m; g += kThreads) {
    const int f = g / p.m;
    const int t2 = g - f * p.m;
    const long long frame = f0 + f;
    float2 v[kMaxN1];
#pragma unroll
    for (int t1 = 0; t1 < kMaxN1; ++t1) {
      if (t1 >= p.n1) break;
      const int n = t1 * p.m + t2;
      float2 s = make_float2(0.f, 0.f);
      if (frame < nf) {
        s = x[frame * p.N + n];
        const float wn = __ldg(w + n);
        s.x *= wn;
        s.y *= wn;
      }
      v[t1] = s;
    }
    tpu_ofdm::dft_stage1(v, t2, buf + f * p.N, W, p);
  }
  tpu_ofdm::dft_radix2(buf, fpc * p.n1, W, p);

  for (int i = threadIdx.x; i < fpc * p.N; i += kThreads) {
    const int f = i / p.N;
    const int k = i - f * p.N;
    const long long frame = f0 + f;
    if (frame < nf) {
      const float2 y = buf[f * p.N + tpu_ofdm::dft_bin(k, p)];
      out[frame * p.N + k] = y.x * y.x + y.y * y.y;
    }
  }
}

}  // namespace

// x: nf * N complex64 samples; w: N float32 (normalization folded in);
// out: (nf, N) float32.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int psd_launch(const void* x, long long nf, const void* w, int N,
                          void* out, void* stream) {
  DftPlan p;
  if (nf < 0 || !tpu_ofdm::make_plan(N, -1.f, &p))
    return cudaErrorInvalidValue;
  if (nf == 0) return cudaSuccess;
  const int fpc = N >= kTileSamples ? 1 : kTileSamples / N;
  const long long grid = (nf + fpc - 1) / fpc;
  const size_t smem = static_cast<size_t>(N) * (fpc + 1) * sizeof(float2);
  psd_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w), p, fpc,
      nf, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
