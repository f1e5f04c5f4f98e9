// Windowed PSD frames: window (normalization folded in), N-point DFT and
// |.|^2 in one pass over the sample stream.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/psd.py (built by
// _build_call, wrapper psd_fused).  The TPU kernel emitted k1-major
// (Z-order) bins and needed an XLA transpose afterwards, and ran its
// 128-point stage as a bf16 hi/lo matmul; both were Mosaic/MXU workarounds.
// Here bins come out in natural order and everything is float32.
//
// Semantics (spectrum.psd.psd_frames): row b, frame f, bin k,
//   out[b, f, k] = |sum_n x[b, f N + n] w[n] exp(-2 pi i n k / N)|^2
// with w = window / sqrt(sum(window^2) * N), folded on the host in float64.
// Each row gives n // N frames; a ragged tail is dropped.
//
// Bound on this card: device memory, 12 bytes per sample (8 in, 4 out);
// the FFT costs ~5 log2(N) flops per sample.  The first port ran a generic
// runtime-sized plan in shared memory (a twiddle table rebuilt with
// sincospif by every CTA, runtime `%` and `/` per butterfly, 8-way bank
// conflicts at its bit-reversed stores and strided reads, 7 block
// barriers) and sat at ~0.16 of the bound.  Design:
//   - one kernel per N (16, 32, 64 and 128 n1 for n1 = 1..8), so every
//     index is a compile-time constant and the body has no runtime `/`
//     or `%`;
//   - a four-step FFT held in registers.  N = A NL with NL = min(N, 32)
//     lanes a frame: lane l holds samples n = NL a + l (a < A), loaded
//     coalesced (32 consecutive samples a load) and windowed at load; it
//     runs the A-point DFT in registers (Good-Thomas: a 3-, 5- or 7-point
//     DFT and a radix-2 FFT of the power of two, no twiddles between them),
//     multiplies by W_N^(l k1).  The 32-point DFTs over l then run
//     either (N = 256, 512, 1024: psd_tile_kernel) in registers after one
//     padded shared-memory transpose, each lane storing 32 bins at a
//     stride of A, or (the other N: psd_kernel) as log2(NL) radix-2
//     decimation-in-frequency stages of __shfl_xor_sync butterflies, as
//     csrc/pfb.cu's, after which lane l holds bins k1 + A bitrev(l); from
//     A = 4 on that warp passes them through shared memory (rows of A + 1
//     floats, no bank conflicts) to store 32 consecutive bins at a time.
//     The shuffles cost ~2 shuffles per value and stage: where A >= 8 the
//     transpose and a second register FFT are cheaper;
//   - N < 32: 32 / N frames share a warp; small A: a warp takes several
//     frames at once (16 samples a lane in flight);
//   - twiddles: W_N^(l k1) from a table built once per N on the host in
//     float64 from the integer exponent (l k1) mod N and cached on the
//     device after the folded window (kernels/psd.py); the roots of the
//     in-lane DFTs and of the butterflies (W_32^j, W_3, W_5, W_7) come in
//     the launch's parameters, computed on the host in float64.
// Error bound: each bin is a float32 sum over log2(N) + 2 levels of
// butterflies and short DFTs, within ~(log2 N + 7) eps of sum_n |x w|.
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;

// exp(-2 pi i j / q): the roots of the in-lane DFTs and of the butterflies
struct Roots {
  float2 w32[32];
  float2 w3[3];
  float2 w5[5];
  float2 w7[7];
};

__host__ __device__ constexpr int odd_part(int a) {
  return a % 7 == 0 ? 7 : a % 5 == 0 ? 5 : a % 3 == 0 ? 3 : 1;
}
__host__ __device__ constexpr int inv_mod(int a, int mod) {
  for (int x = 0; x < mod; ++x)
    if ((a * x) % mod == 1 % mod) return x;
  return 0;
}
__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}
__host__ __device__ constexpr int bitrev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

template <int Q>
__device__ __forceinline__ float2 root_q(const Roots& R, int e) {
  if constexpr (Q == 3) return R.w3[e];
  else if constexpr (Q == 5) return R.w5[e];
  else return R.w7[e];
}

// the butterflies of span 2H of a radix-2 DIT FFT, then the next span: a
// template per stage, so that every loop bound is a constant and the
// values stay in registers
template <int P, int H>
__device__ __forceinline__ void fft2_stages(float2 (&b)[P], const Roots& R) {
  if constexpr (H < P) {
#pragma unroll
    for (int s = 0; s < P; s += 2 * H) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        constexpr int step = 32 / (2 * H);  // W_2H^j = W_32^(j step)
        const int e = j * step;
        float2 t = b[s + j + H];
        if (e == 8) t = make_float2(t.y, -t.x);  // times -i
        else if (e != 0) t = cmul(t, R.w32[e]);
        b[s + j + H] = csub(b[s + j], t);
        b[s + j] = cadd(b[s + j], t);
      }
    }
    fft2_stages<P, 2 * H>(b, R);
  }
}

// in-place radix-2 DIT FFT of P (a power of two <= 32) values
template <int P>
__device__ __forceinline__ void fft2(float2 (&a)[P], const Roots& R) {
  if constexpr (P > 1) {
    constexpr int bits = log2i(P);
    float2 b[P];
#pragma unroll
    for (int i = 0; i < P; ++i)  // __brev of a constant folds: no index
      b[__brev(static_cast<unsigned>(i)) >> (32 - bits)] = a[i];
    fft2_stages<P, 1>(b, R);
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = b[i];
  }
}

// in-place A-point DFT of a lane's values, A = Q P with Q in {1, 3, 5, 7}
// and P a power of two: Good-Thomas, input index (P n1 + Q n2) mod A,
// output index (P (P^-1 mod Q) k1 + Q (Q^-1 mod P) k2) mod A
template <int A>
__device__ __forceinline__ void dft_lane(float2 (&y)[A], const Roots& R) {
  constexpr int Q = odd_part(A);
  constexpr int P = A / Q;
  constexpr int u = inv_mod(P, Q);
  constexpr int v = inv_mod(Q, P);
  float2 t[Q][P];
#pragma unroll
  for (int n1 = 0; n1 < Q; ++n1)
#pragma unroll
    for (int n2 = 0; n2 < P; ++n2) t[n1][n2] = y[(P * n1 + Q * n2) % A];
  if constexpr (Q > 1) {
#pragma unroll
    for (int n2 = 0; n2 < P; ++n2) {
      float2 c[Q];
#pragma unroll
      for (int k1 = 0; k1 < Q; ++k1) {
        float2 acc = t[0][n2];
#pragma unroll
        for (int n1 = 1; n1 < Q; ++n1) {
          const int e = (n1 * k1) % Q;
          acc = cadd(acc, e == 0 ? t[n1][n2]
                                 : cmul(t[n1][n2], root_q<Q>(R, e)));
        }
        c[k1] = acc;
      }
#pragma unroll
      for (int k1 = 0; k1 < Q; ++k1) t[k1][n2] = c[k1];
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < Q; ++k1) fft2<P>(t[k1], R);
#pragma unroll
  for (int k1 = 0; k1 < Q; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < P; ++k2)
      y[(P * u * k1 + Q * v * k2) % A] = t[k1][k2];
}

template <int N>
struct Plan {
  static constexpr int NL = N < 32 ? N : 32;  // lanes a frame
  static constexpr int A = N / NL;            // samples (and bins) a lane
  static constexpr int FPW = 32 / NL;         // frames a warp pass
  static constexpr int U = 16 / A > 1 ? 16 / A : 1;  // passes at once
  static constexpr int GF = FPW * U;          // frames a warp
  static constexpr int LOG_NL = log2i(NL);
};

// x: B rows of samples, row b at x + b * stride, nf frames each; consts:
// the folded window (N floats), then W_N^((l k1) mod N) at [k1 NL + l]
// (float2, for A > 1); out: (B, nf, N).  gpr: warps a row.
template <int N>
__global__ void __launch_bounds__(kWarps * 32, 2)
psd_kernel(const float2* __restrict__ x, long long stride, long long nf,
           long long gpr, long long B, const float* __restrict__ consts,
           const __grid_constant__ Roots roots, float* __restrict__ out) {
  using PL = Plan<N>;
  constexpr int NL = PL::NL, A = PL::A, FPW = PL::FPW, U = PL::U;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gid = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long b = gid / gpr;
  if (b >= B) return;
  const long long f0 = (gid - b * gpr) * PL::GF;
  const int lp = lane & (NL - 1);  // lane within its frame
  const int fw = lane / NL;        // frame within the warp pass
  const float2* xr = x + b * stride;
  float* orow = out + b * nf * N;
  const float* w = consts;
  const float2* tw = reinterpret_cast<const float2*>(consts + N);
  __shared__ float stage[kWarps][A >= 4 ? 32 * (A + 1) : 1];

  float2 y[U][A];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long f = f0 + u * FPW + fw;
    const bool ok = f < nf;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int n = NL * a + lp;
      const float2 s = ok ? xr[f * N + n] : make_float2(0.f, 0.f);
      const float wn = __ldg(w + n);
      y[u][a] = make_float2(s.x * wn, s.y * wn);
    }
  }
  float2 wst[PL::LOG_NL > 0 ? PL::LOG_NL : 1];  // butterfly twiddle a stage
#pragma unroll
  for (int s = 0; s < PL::LOG_NL; ++s) {
    const int half = NL >> (s + 1);
    wst[s] = roots.w32[(lp & (half - 1)) * (16 / half)];
  }
  const int k2 = bitrev(lp, PL::LOG_NL);  // the bin this lane ends up with

#pragma unroll
  for (int u = 0; u < U; ++u) {
    dft_lane<A>(y[u], roots);
#pragma unroll
    for (int k1 = 1; k1 < A; ++k1)
      y[u][k1] = cmul(y[u][k1], __ldg(tw + k1 * NL + lp));
    // the NL-point DFT across the frame's lanes, radix-2 DIF: lane lp ends
    // up holding bin bitrev(lp) of each of its A transforms
#pragma unroll
    for (int s = 0; s < PL::LOG_NL; ++s) {
      const int half = NL >> (s + 1);
      const bool upper = (lp & half) != 0;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float bx = __shfl_xor_sync(kAll, y[u][a].x, half);
        const float by = __shfl_xor_sync(kAll, y[u][a].y, half);
        const float2 v = y[u][a];
        y[u][a] = upper ? cmul(make_float2(bx - v.x, by - v.y), wst[s])
                        : make_float2(v.x + bx, v.y + by);
      }
    }
    const long long f = f0 + u * FPW + fw;
    float p[A];
#pragma unroll
    for (int a = 0; a < A; ++a)
      p[a] = fmaf(y[u][a].x, y[u][a].x, y[u][a].y * y[u][a].y);
    if constexpr (A >= 4) {
      // one frame a warp (NL = 32): the bins go through the warp's rows of
      // A + 1 floats (row k2, no bank conflicts) and out as 128-byte runs
      float* st = stage[warp];
#pragma unroll
      for (int a = 0; a < A; ++a) st[k2 * (A + 1) + a] = p[a];
      __syncwarp();
      if (f < nf) {
#pragma unroll
        for (int i = 0; i < A; ++i) {
          const int k = lane + 32 * i;
          orow[f * N + k] = st[k / A * (A + 1) + k % A];
        }
      }
      __syncwarp();  // read before the next pass writes
    } else if (f < nf) {
      float* dst = orow + f * N + A * k2;  // bins k1 + A k2, k1 < A
      if constexpr (A == 2)
        *reinterpret_cast<float2*>(dst) = make_float2(p[0], p[1]);
      else
        dst[0] = p[0];
    }
  }
}

// N = 32 A with A = 8, 16 or 32: the cross-lane stage goes through shared
// memory instead.  A warp takes F = 32 / A frames; lane l runs the A-point
// FFT of each frame's samples n = 32 a + l and the twiddle W_N^(l k1),
// writes the results to column l, rows A u + k1 of a padded 32 x 33 tile
// (frame u) and reads back its own row j = A u + k1: the 32 values of l,
// whose 32-point FFT in registers gives bins k1 + A k2, k2 < 32.  For each k2
// the warp then stores runs of A consecutive bins, 128 bytes at A = 32.
// Both tile accesses are free of bank conflicts (rows of 33 float2).
constexpr int kTWarps = 4;

template <int N>
__global__ void __launch_bounds__(kTWarps * 32)
psd_tile_kernel(const float2* __restrict__ x, long long stride, long long nf,
                long long gpr, long long B, const float* __restrict__ consts,
                const __grid_constant__ Roots roots, float* __restrict__ out) {
  constexpr int A = N / 32;
  constexpr int F = 32 / A;
  __shared__ float2 tile[kTWarps][32][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gid = static_cast<long long>(blockIdx.x) * kTWarps + warp;
  const long long b = gid / gpr;
  if (b >= B) return;
  const long long f0 = (gid - b * gpr) * F;
  const float2* xr = x + b * stride;
  float* orow = out + b * nf * N;
  const float* w = consts;
  const float2* tw = reinterpret_cast<const float2*>(consts + N);

  float2 y[F][A];
#pragma unroll
  for (int u = 0; u < F; ++u) {
    const bool ok = f0 + u < nf;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int n = 32 * a + lane;
      const float2 s = ok ? xr[(f0 + u) * N + n] : make_float2(0.f, 0.f);
      const float wn = __ldg(w + n);
      y[u][a] = make_float2(s.x * wn, s.y * wn);
    }
  }
  float2(*t)[33] = tile[warp];
#pragma unroll
  for (int u = 0; u < F; ++u) {
    fft2<A>(y[u], roots);
    t[A * u][lane] = y[u][0];
#pragma unroll
    for (int k1 = 1; k1 < A; ++k1)
      t[A * u + k1][lane] = cmul(y[u][k1], __ldg(tw + k1 * 32 + lane));
  }
  __syncwarp();
  float2 z[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) z[l] = t[lane][l];
  fft2<32>(z, roots);
  const long long f = f0 + lane / A;
  if (f < nf) {
    float* dst = orow + f * N + (lane & (A - 1));
#pragma unroll
    for (int k2 = 0; k2 < 32; ++k2)
      dst[A * k2] = fmaf(z[k2].x, z[k2].x, z[k2].y * z[k2].y);
  }
}

const Roots& roots() {
  static const Roots r = [] {
    Roots v;
    auto fill = [](float2* out, int q) {
      for (int j = 0; j < q; ++j) {
        const double ph = -2.0 * 3.14159265358979323846 * j / q;
        out[j] = make_float2(static_cast<float>(std::cos(ph)),
                             static_cast<float>(std::sin(ph)));
      }
    };
    fill(v.w32, 32);
    fill(v.w3, 3);
    fill(v.w5, 5);
    fill(v.w7, 7);
    return v;
  }();
  return r;
}

template <int N>
int launch(const float2* x, long long B, long long stride, long long nf,
           const float* consts, float* out, cudaStream_t s) {
  constexpr bool tiled = N == 256 || N == 512 || N == 1024;
  constexpr int per_warp = tiled ? 32 / (N / 32) : Plan<N>::GF;  // frames
  constexpr int warps = tiled ? kTWarps : kWarps;
  const long long gpr = (nf + per_warp - 1) / per_warp;
  const long long blocks = (B * gpr + warps - 1) / warps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  if constexpr (tiled)
    psd_tile_kernel<N><<<grid, warps * 32, 0, s>>>(x, stride, nf, gpr, B,
                                                   consts, roots(), out);
  else
    psd_kernel<N><<<grid, warps * 32, 0, s>>>(x, stride, nf, gpr, B, consts,
                                              roots(), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: B rows of complex64 samples, row b at x + b * row_stride, nf frames
// of N from each; consts: the folded window (N float32) followed by the
// twiddle table of kernels/psd.py (2 N float32); out: (B, nf, N) float32.
// N: 16, 32, 64, and 128 n1 for n1 = 1..8.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int psd_rows_launch(const void* x, long long B,
                               long long row_stride, long long nf,
                               const void* consts, int N, void* out,
                               void* stream) {
  if (B < 0 || nf < 0 || row_stride < 0) return cudaErrorInvalidValue;
  if (B == 0 || nf == 0) return cudaSuccess;
  const auto* xp = static_cast<const float2*>(x);
  const auto* cp = static_cast<const float*>(consts);
  auto* op = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(xp, B, row_stride, nf, cp, op, s);
    case 32: return launch<32>(xp, B, row_stride, nf, cp, op, s);
    case 64: return launch<64>(xp, B, row_stride, nf, cp, op, s);
    case 128: return launch<128>(xp, B, row_stride, nf, cp, op, s);
    case 256: return launch<256>(xp, B, row_stride, nf, cp, op, s);
    case 384: return launch<384>(xp, B, row_stride, nf, cp, op, s);
    case 512: return launch<512>(xp, B, row_stride, nf, cp, op, s);
    case 640: return launch<640>(xp, B, row_stride, nf, cp, op, s);
    case 768: return launch<768>(xp, B, row_stride, nf, cp, op, s);
    case 896: return launch<896>(xp, B, row_stride, nf, cp, op, s);
    case 1024: return launch<1024>(xp, B, row_stride, nf, cp, op, s);
    default: return cudaErrorInvalidValue;
  }
}

// x: nf * N complex64 samples; w: as psd_rows_launch's consts; out:
// (nf, N) float32.  The one-row form (the first port's entry; its kernel
// reads only the window at the head of w).
extern "C" int psd_launch(const void* x, long long nf, const void* w, int N,
                          void* out, void* stream) {
  return psd_rows_launch(x, 1, nf * N, nf, w, N, out, stream);
}
