// Reads from the VIRTUAL sample buffer [head | x] without materializing it.
//
// The streaming receiver keeps a short history (head) and receives a long
// block (x); detection and the slot-window gather both index the
// concatenation.  Positions outside [0, h + n) read as zero.
#pragma once

#include <cuda_runtime.h>

namespace tpu_ofdm {

__device__ __forceinline__ float2 virtual_load(const float2* __restrict__ head,
                                               long long h,
                                               const float2* __restrict__ x,
                                               long long nv, long long p) {
  if (p < 0 || p >= nv) return make_float2(0.f, 0.f);
  return p < h ? head[p] : x[p - h];
}

}  // namespace tpu_ofdm
