// Full-length Schmidl-Cox sliding metric, valid mode.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/sc_metric.py
// (through _sc_pallas).  For B rows r of n complex64 samples and every
// window start d in [0, m), m = n - 2L + 1:
//   P[d] = sum_{q<L} conj(r[d+q]) r[d+q+L]
//   R[d] = sum_{q<L} |r[d+q+L]|^2
//   M[d] = |P[d]|^2 / max(R[d], 1e-12)^2        (uncapped, as on the TPU)
//
// The TPU kernel took the window sums as differences of a running prefix
// carried across the whole row (MXU triangular matmuls, a VMEM lookback ring
// of the previous tile's prefix rows, a 2-D scratch layout).  At 2^25
// samples and L = 32 such a difference loses ~eps * n / L of a window's
// value.  Here every window is summed directly in float32, so the error is
// ~eps * sqrt(L) of the window's energy at any n, and there is no limit on
// L (the TPU's L // 128 + 1 < 128 was a VMEM limit).
//
// Bound on this card: the direct sums, ~L * 10 operations per output, read
// from shared memory.  Device-memory traffic is the 8-byte sample read
// twice (the plain and the L-lagged view) and 16 bytes written per output.
// Design, kept simple: one CTA of 256 threads owns 1024 consecutive window
// starts of one row; it walks the window in chunks of 256 terms, staging
// r[base + q0 + j] and r[base + q0 + L + j] for its 1024 + 255 positions in
// shared memory, and each thread accumulates 4 outputs (d = base + tid +
// 256 k) in registers, so a warp reads consecutive words.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 4;
constexpr int kTile = kThreads * kOutPerThread;  // window starts per CTA
constexpr int kChunk = 256;                      // window terms per stage

__global__ void __launch_bounds__(kThreads)
sc_metric_kernel(const float2* __restrict__ r, long long n, long long m,
                 int L, long long tiles, float2* __restrict__ P,
                 float* __restrict__ R, float* __restrict__ M) {
  __shared__ float2 a[kTile + kChunk];  // r[base + q0 + j]
  __shared__ float2 b[kTile + kChunk];  // r[base + q0 + L + j]
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) * kTile;
  r += row * n;
  float pr[kOutPerThread] = {}, pi[kOutPerThread] = {}, e[kOutPerThread] = {};
  for (int q0 = 0; q0 < L; q0 += kChunk) {
    const int c = min(kChunk, L - q0);
    const int span = kTile + c - 1;
    __syncthreads();  // the previous chunk's reads are done
    for (int j = threadIdx.x; j < span; j += kThreads) {
      const long long ia = base + q0 + j;
      const long long ib = ia + L;
      a[j] = ia < n ? r[ia] : make_float2(0.f, 0.f);
      b[j] = ib < n ? r[ib] : make_float2(0.f, 0.f);
    }
    __syncthreads();
    for (int k = 0; k < kOutPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      for (int q = 0; q < c; ++q) {
        const float2 u = a[j + q];
        const float2 v = b[j + q];
        pr[k] += u.x * v.x + u.y * v.y;
        pi[k] += u.x * v.y - u.y * v.x;
        e[k] += v.x * v.x + v.y * v.y;
      }
    }
  }
  const long long out0 = row * m;
  for (int k = 0; k < kOutPerThread; ++k) {
    const long long d = base + threadIdx.x + k * kThreads;
    if (d >= m) break;
    const float den = fmaxf(e[k], 1e-12f);
    P[out0 + d] = make_float2(pr[k], pi[k]);
    R[out0 + d] = e[k];
    M[out0 + d] = (pr[k] * pr[k] + pi[k] * pi[k]) / (den * den);
  }
}

}  // namespace

// r: B rows of n complex64 samples (interleaved float2), contiguous;
// P (complex64), R, M (float32): B rows of n - 2L + 1.  Needs L >= 1 and
// n >= 2L.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sc_metric_launch(const void* r, long long n, long long B,
                                int L, void* P, void* R, void* M,
                                void* stream) {
  if (L < 1 || B < 0 || n < 2LL * L) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const long long m = n - 2LL * L + 1;
  const long long tiles = (m + kTile - 1) / kTile;
  const long long blocks = B * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  sc_metric_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(r), n, m, L, tiles,
      static_cast<float2*>(P), static_cast<float*>(R),
      static_cast<float*>(M));
  return static_cast<int>(cudaGetLastError());
}
