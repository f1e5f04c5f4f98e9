// Slot-window gather for the receiver: out[b, k, j] = virtual_b[starts[b, k]
// + j] over B virtual buffers [head_b | x_b], complex64 (B, K, F).  B = 1 is
// the streaming receiver; B = n_chan the wideband one, where the JAX package
// gathers with a vmapped dynamic_slice (tpu_ofdm/modem/rx.py:200-222).
// Positions outside the virtual buffer read as zero.
//
// Replaces the Pallas kernels in tpu_ofdm/kernels/gather.py: `_kernel`
// (one source, via _gather_super) and `_kernel2` (two sources, via
// _gather_super2).  Those fetched (8, 128)-aligned superwindows by DMA and
// cut the exact window out in a second pass, because Mosaic only allows
// tile-aligned DMA endpoints.  A GPU thread can load any 8-byte aligned
// address, so this is one pass.
//
// Bound on this card: device-memory traffic, 16 bytes per output sample (8
// read, 8 written); at the receiver's K = 480, F = 2000 that is ~15 MB.  The
// first design moved one sample a thread, with a bounds test and 64-bit
// index arithmetic per sample: 8 bytes in flight a thread, and it lost to
// x.unfold(-1, F, 1)[starts] (PERF.md).  This one:
//   - one CTA per window (grid.x = B * K).  The CTA classifies its window
//     once: wholly in x (the common case), wholly in head, or straddling the
//     seam or an edge.  The first two copy from one base pointer with 32-bit
//     offsets and no test per sample; only the last reads sample by sample
//     through virtual_load.
//   - stores are 16 bytes (float4, two samples) from the first 16-byte
//     aligned sample of the output row: with an odd F every other row starts
//     at an odd sample, so a row's first sample, and a last one left over,
//     are stored alone.  A window starts at any sample, so its source is
//     16-byte aligned only when its parity matches the row's: then the loads
//     are float4 too, else two float2 per pair.
//   - each thread issues all the loads of kUnroll pairs before their
//     stores: 64 bytes in flight a thread.
//   - the stores are plain write-back ones, so the windows stay in L2 for
//     derotate, which reads them next (modem/rx.py).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "virtual_buffer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // sample pairs per thread per pass

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[0, F) = src[0, F), both 8-byte aligned, by the CTA
__device__ __forceinline__ void copy_window(const float2* __restrict__ src,
                                            float2* __restrict__ dst, int F) {
  const int lead = aligned16(dst) ? 0 : 1;
  const int pairs = (F - lead) >> 1;
  if (threadIdx.x == 0) {
    if (lead) dst[0] = __ldg(src);
    if ((F - lead) & 1) dst[F - 1] = __ldg(src + F - 1);
  }
  const float2* s = src + lead;
  float4* d = reinterpret_cast<float4*>(dst + lead);
  constexpr int kStep = kThreads * kUnroll;
  if (aligned16(s)) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int i0 = threadIdx.x; i0 < pairs; i0 += kStep) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < pairs) v[u] = __ldg(s4 + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < pairs) d[i] = v[u];
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < pairs; i0 += kStep) {
      float2 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < pairs) {
          a[u] = __ldg(s + 2 * i);
          b[u] = __ldg(s + 2 * i + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < pairs) d[i] = make_float4(a[u].x, a[u].y, b[u].x, b[u].y);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float2* __restrict__ head, long long h,
              long long head_stride, const float2* __restrict__ x,
              long long n, long long x_stride,
              const int* __restrict__ starts, int K, int F,
              float2* __restrict__ out) {
  const long long w = blockIdx.x;  // window b * K + k
  const long long b = w / K;
  const long long s = __ldg(starts + w);
  const float2* xb = x + b * x_stride;
  float2* dst = out + w * F;
  if (s >= h && s + F <= h + n) {
    copy_window(xb + (s - h), dst, F);
  } else if (s >= 0 && s + F <= h) {
    copy_window(head + b * head_stride + s, dst, F);
  } else {
    // straddling: sample by sample, 2 * kUnroll loads in flight a thread
    const float2* hb = head == nullptr ? nullptr : head + b * head_stride;
    constexpr int kLoads = 2 * kUnroll;
    for (int j0 = threadIdx.x; j0 < F; j0 += kThreads * kLoads) {
      float2 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = j0 + u * kThreads;
        if (j < F) v[u] = tpu_ofdm::virtual_load(hb, h, xb, h + n, s + j);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int j = j0 + u * kThreads;
        if (j < F) dst[j] = v[u];
      }
    }
  }
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
  if (B < 0 || K < 0 || F < 0) return cudaErrorInvalidValue;
  if (B == 0 || K == 0 || F == 0) return cudaSuccess;
  const long long windows = static_cast<long long>(B) * K;
  if (windows > INT_MAX) return cudaErrorInvalidValue;
  gather_kernel<<<static_cast<unsigned>(windows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(head), h, head_stride,
      static_cast<const float2*>(x), n, x_stride,
      static_cast<const int*>(starts), K, F, static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
