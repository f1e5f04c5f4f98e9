// Polyphase filterbank channelizer: commutator, J-tap FIR per arm and the
// cross-arm N-point DFT in one pass over the wideband stream.
//
// Replaces both Pallas kernels of tpu_ofdm/kernels/pfb.py: `_kernel`
// (through _pfb_pallas, N <= 128, lane-folded) and `_kernel_wide` (through
// _pfb_pallas_wide, N a multiple of 128 up to 512, one commutator load per
// row).  The narrow/wide split was a TPU lane-layout artifact; here both
// are one kernel.  The bf16 hi/lo split of the DFT operands was a TPU
// matmul-precision workaround and is not carried over: everything is
// float32.
//
// Semantics (spectrum.channelizer.channelize_ext): over the virtual buffer
// [head | x] (head = the stream's raw-sample tail carry), output row m of
// x, channel k:
//   out[m, k] = sum_a z[m, a] exp(+2 pi i a k / N)
//   z[m, a]   = sum_j poly[j, a] * v[h + (m - j) N + (N - 1 - a)]
// i.e. arm a consumes the reference's reversed commutator order, and the
// unnormalized inverse DFT equals channelize_ext's ifft(acc) * N.  Virtual
// positions before the buffer read as zero (stream start).
//
// Bound on this card: device-memory traffic is 16 bytes per sample (8 in, 8
// out) plus the J-1 lookback rows each CTA re-reads through L1/L2; the
// float32 FFT in shared memory costs ~5 log2(N) flops per sample.  Design,
// kept simple: one CTA of 256 threads owns a tile of ~4096 samples
// (4096 / N output rows).  Each thread forms z for one (row, t2) column of
// the DFT plan straight from device memory (coalesced: neighbouring threads
// read neighbouring samples), runs the direct n1-point stage in registers
// and the radix-2 stage in shared memory (dft.cuh).  CTAs carry nothing
// between them and run in any order.
#include <cuda_runtime.h>

#include "dft.cuh"
#include "virtual_buffer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;

using tpu_ofdm::DftPlan;
using tpu_ofdm::kMaxN1;

__global__ void __launch_bounds__(kThreads)
pfb_kernel(const float2* __restrict__ head, long long h,
           const float2* __restrict__ x, long long nv,
           const float* __restrict__ poly, int J, DftPlan p, int fpc,
           long long rows, float2* __restrict__ out) {
  extern __shared__ float2 smem[];
  float2* W = smem;
  float2* buf = smem + p.N;
  tpu_ofdm::dft_table(W, p);
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * fpc;
  for (int g = threadIdx.x; g < fpc * p.m; g += kThreads) {
    const int f = g / p.m;
    const int t2 = g - f * p.m;
    const long long row = r0 + f;
    float2 v[kMaxN1];
#pragma unroll
    for (int t1 = 0; t1 < kMaxN1; ++t1) {
      if (t1 >= p.n1) break;
      const int a = t1 * p.m + t2;  // arm
      float2 z = make_float2(0.f, 0.f);
      if (row < rows) {
        const long long pos0 = h + row * p.N + (p.N - 1 - a);
        for (int j = 0; j < J; ++j) {
          const float q = __ldg(poly + j * p.N + a);
          const float2 s = tpu_ofdm::virtual_load(
              head, h, x, nv, pos0 - static_cast<long long>(j) * p.N);
          z.x += q * s.x;
          z.y += q * s.y;
        }
      }
      v[t1] = z;
    }
    tpu_ofdm::dft_stage1(v, t2, buf + f * p.N, W, p);
  }
  tpu_ofdm::dft_radix2(buf, fpc * p.n1, W, p);

  for (int i = threadIdx.x; i < fpc * p.N; i += kThreads) {
    const int f = i / p.N;
    const int k = i - f * p.N;
    const long long row = r0 + f;
    if (row < rows)
      out[row * p.N + k] = buf[f * p.N + tpu_ofdm::dft_bin(k, p)];
  }
}

}  // namespace

// head: h complex64 samples immediately preceding x (may be null when
// h == 0); x: n complex64 samples, n % N == 0; poly: (J, N) float32;
// out: (n / N, N) complex64.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int pfb_launch(const void* head, long long h, const void* x,
                          long long n, const void* poly, int J, int N,
                          void* out, void* stream) {
  DftPlan p;
  if (J < 1 || h < 0 || n < 0 || !tpu_ofdm::make_plan(N, 1.f, &p) ||
      n % N != 0)
    return cudaErrorInvalidValue;
  const long long rows = n / N;
  if (rows == 0) return cudaSuccess;
  const int fpc = N >= kTileSamples ? 1 : kTileSamples / N;
  const long long grid = (rows + fpc - 1) / fpc;
  const size_t smem = static_cast<size_t>(N) * (fpc + 1) * sizeof(float2);
  pfb_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(head), h, static_cast<const float2*>(x),
      h + n, static_cast<const float*>(poly), J, p, fpc, rows,
      static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
