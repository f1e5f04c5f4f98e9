// Slot-window gather for the receiver: out[b, k, j] = virtual_b[starts[b, k]
// + j] over B virtual buffers [head_b | x_b], complex64 (B, K, F).  B = 1 is
// the streaming receiver; B = n_chan the wideband one, where the JAX package
// gathers with a vmapped dynamic_slice (tpu_ofdm/modem/rx.py:200-222).
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
// per complex sample, grid (ceil(F / 256), K, B); neighbouring threads load
// neighbouring float2 values, so every warp's loads and stores coalesce.
// Starts are int32 positions in the virtual buffer; a position outside it
// reads as zero.
#include <cuda_runtime.h>

#include "virtual_buffer.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float2* __restrict__ head, long long h,
              long long head_stride, const float2* __restrict__ x,
              long long nv, long long x_stride,
              const int* __restrict__ starts, int F,
              float2* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= F) return;
  const long long slot =
      static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (head != nullptr) head += blockIdx.z * head_stride;
  x += blockIdx.z * x_stride;
  const long long p = static_cast<long long>(__ldg(starts + slot)) + j;
  out[slot * F + j] = tpu_ofdm::virtual_load(head, h, x, nv, p);
}

}  // namespace

// head: B rows of h complex64 samples, row b at head + b * head_stride
// (may be null when h == 0); x: B rows of n samples, row b at
// x + b * x_stride; starts: (B, K) int32; out: (B, K, F) complex64.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gather_launch(const void* head, long long h,
                             long long head_stride, const void* x,
                             long long n, long long x_stride, int B,
                             const void* starts, int K, int F, void* out,
                             void* stream) {
  if (B < 0 || K < 0 || F < 0 || K > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || K == 0 || F == 0) return cudaSuccess;
  const dim3 grid((F + kThreads - 1) / kThreads, K, B);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(head), h, head_stride,
      static_cast<const float2*>(x), h + n, x_stride,
      static_cast<const int*>(starts), F, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
