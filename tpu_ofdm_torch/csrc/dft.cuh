// Shared-memory DFT of many short frames at once, for the PSD kernel
// (psd.cu).
//
// The TPU kernels computed these DFTs inside their bodies as MXU matmuls
// against constant DFT matrices (tpu_ofdm/kernels/pfb.py, psd.py); here it
// is an FFT in float32 in shared memory, one CTA transforming a tile of
// frames.  Lengths need not be powers of two (384 .. 896 occur), so
// N = n1 * m is factored as the TPU PSD kernel did it (psd.py:12-29): m the
// largest power of two dividing N, at most 128, and n1 <= 8.  Frame sample
// n = t1*m + t2, output bin k = k1 + n1*k2:
//
//   y[k1][t2] = W_N^(t2 k1) * sum_t1 x[t1 m + t2] W_n1^(t1 k1)  (stage 1)
//   X[k1 + n1 k2] = sum_t2 y[k1][t2] W_m^(t2 k2)                (stage 2)
//
// with W_L = exp(sign * 2 pi i / L).  Stage 1 runs in registers (a thread
// owns one (frame, t2) column of n1 samples) and stores y at bit-reversed
// t2, so stage 2 is an in-place radix-2 decimation-in-time FFT per (frame,
// k1) whose result sits in natural k2 order: bin k of frame f is
// buf[f*N + (k % n1)*m + k / n1].
//
// Every twiddle is a power of W_N taken from one table whose phases come
// from the integer exponent reduced mod N before it becomes a float
// (cf. pfb.py:84, :191).
#pragma once

#include <cuda_runtime.h>

namespace tpu_ofdm {

constexpr int kMaxN1 = 8;

struct DftPlan {
  int N;      // transform length
  int n1;     // direct stage length, 1..8
  int m;      // radix-2 stage length, a power of two <= 128
  int log2m;
  float sign;  // -1: forward DFT, +1: inverse (unnormalized)
};

// Host and device: the factorization above; returns false for a length the
// helper does not cover.
__host__ __device__ inline bool make_plan(int N, float sign, DftPlan* p) {
  if (N < 1) return false;
  int m = 1, log2m = 0;
  while (m < 128 && N % (2 * m) == 0) {
    m *= 2;
    ++log2m;
  }
  const int n1 = N / m;
  if (n1 > kMaxN1) return false;
  *p = DftPlan{N, n1, m, log2m, sign};
  return true;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// W[j] = exp(sign * 2 pi i j / N), j in [0, N).  All threads of the CTA
// call it; the caller synchronizes before use.
__device__ inline void dft_table(float2* W, const DftPlan& p) {
  for (int j = threadIdx.x; j < p.N; j += blockDim.x) {
    float s, c;
    // j < N, so 2j/N is the exact phase fraction up to one float rounding
    sincospif(2.f * static_cast<float>(j) / static_cast<float>(p.N), &s, &c);
    W[j] = make_float2(c, p.sign * s);
  }
}

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(v)) >>
                                          (32 - bits));
}

// Stage 1 for one (frame, t2) column: v[t1] = x[t1*m + t2], t1 < n1 (a
// register array of kMaxN1; the loops unroll fully so it stays in
// registers).  Writes y[k1][bitrev(t2)] into frame_buf (this frame's N
// values).
__device__ __forceinline__ void dft_stage1(const float2 (&v)[kMaxN1], int t2,
                                           float2* frame_buf,
                                           const float2* W,
                                           const DftPlan& p) {
  const int r = bit_reverse(t2, p.log2m);
#pragma unroll
  for (int k1 = 0; k1 < kMaxN1; ++k1) {
    if (k1 >= p.n1) break;
    float2 acc = v[0];
#pragma unroll
    for (int t1 = 1; t1 < kMaxN1; ++t1) {
      if (t1 >= p.n1) break;
      // W_n1^(t1 k1) = W_N^(m * (t1 k1 mod n1))
      acc = cadd(acc, cmul(v[t1], W[p.m * ((t1 * k1) % p.n1)]));
    }
    frame_buf[k1 * p.m + r] = cmul(acc, W[t2 * k1]);  // t2 k1 < N
  }
}

// Stage 2: in-place radix-2 DIT FFTs of length m over n_sub consecutive
// sub-transforms in buf (n_sub = frames * n1).  All threads of the CTA
// call it after stage 1 has been written; it synchronizes before each
// butterfly stage and after the last.
__device__ inline void dft_radix2(float2* buf, int n_sub, const float2* W,
                                  const DftPlan& p) {
  const int half_m = p.m / 2;
  const int total = n_sub * half_m;
  for (int s = 0; s < p.log2m; ++s) {
    __syncthreads();
    const int half = 1 << s;
    const int wstep = p.n1 * (half_m >> s);  // W_(2 half)^j = W_N^(j wstep)
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int sub = i / half_m;
      const int b = i - sub * half_m;
      const int j = b & (half - 1);
      const int pos = sub * p.m + ((b >> s) << (s + 1)) + j;
      const float2 a = buf[pos];
      const float2 t = cmul(buf[pos + half], W[j * wstep]);
      buf[pos] = cadd(a, t);
      buf[pos + half] = make_float2(a.x - t.x, a.y - t.y);
    }
  }
  __syncthreads();
}

// Offset of bin k inside a transformed frame.
__device__ __forceinline__ int dft_bin(int k, const DftPlan& p) {
  return (k % p.n1) * p.m + k / p.n1;
}

}  // namespace tpu_ofdm
