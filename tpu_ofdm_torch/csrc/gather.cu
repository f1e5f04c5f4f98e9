// Slot-window gather for the receiver: out[k, j] = virtual[starts[k] + j]
// over the virtual buffer [head | x], complex64 (K, F).
//
// Replaces the Pallas kernels in tpu_ofdm/kernels/gather.py: `_kernel`
// (one source, via _gather_super) and `_kernel2` (two sources, via
// _gather_super2).  Those fetched (8, 128)-aligned superwindows by DMA and
// cut the exact window out in a second pass, because Mosaic only allows
// tile-aligned DMA endpoints.  A GPU thread can load any address, so this
// is one pass with no alignment games.
//
// Bound on this card: device-memory traffic, 16 bytes per output sample (8
// read, 8 written) -- at the receiver's K = 480, F = 2000 that is ~15 MB,
// far below the cost of the detect pass over the block.  Design: one thread
// per complex sample, grid (ceil(F / 256), K); neighbouring threads load
// neighbouring float2 values, so every warp's loads and stores coalesce.
// Starts are int32 positions in the virtual buffer; a position outside it
// reads as zero.
#include <cuda_runtime.h>

#include "virtual_buffer.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float2* __restrict__ head, long long h,
              const float2* __restrict__ x, long long nv,
              const int* __restrict__ starts, int F,
              float2* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= F) return;
  const int k = blockIdx.y;
  const long long p = static_cast<long long>(__ldg(starts + k)) + j;
  out[static_cast<long long>(k) * F + j] =
      tpu_ofdm::virtual_load(head, h, x, nv, p);
}

}  // namespace

// head: h complex64 samples (may be null when h == 0); x: n samples;
// starts: K int32; out: K * F complex64.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gather_launch(const void* head, long long h, const void* x,
                             long long n, const void* starts, int K, int F,
                             void* out, void* stream) {
  if (K < 0 || F < 0 || K > 65535) return cudaErrorInvalidValue;
  if (K == 0 || F == 0) return cudaSuccess;
  const dim3 grid((F + kThreads - 1) / kThreads, K);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(head), h, static_cast<const float2*>(x),
      h + n, static_cast<const int*>(starts), F, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
