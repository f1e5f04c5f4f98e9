// Full-length Schmidl-Cox sliding metric, valid mode, raw and gated.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/sc_metric.py
// (through _sc_pallas), and the energy gate of tpu_ofdm.ops.sync.schmidl_cox
// (tpu_ofdm/ops/sync.py:148-168, coarse_sliding_max_same :60-81) that runs
// after it.  For B rows r of n complex64 samples and every window start d
// in [0, m), m = n - 2L + 1:
//   P[d] = sum_{q<L} conj(r[d+q]) r[d+q+L]
//   R[d] = sum_{q<L} |r[d+q+L]|^2
//   M[d] = |P[d]|^2 / max(R[d], 1e-12)^2        (raw: uncapped, as on the TPU)
// The gated form writes instead
//   M[d] = R > 0.05 local ? (R > 0 ? min(M, 2) : 0) : 0
// where local is the max of R over the 128-output rows b - k .. b + k of
// d's row b = d / 128, clipped to the row's outputs (k = ceil((w/2 + 128) /
// 128) for the gate width w; 2 at fft 64).
//
// The TPU kernel took the window sums as differences of a running prefix
// carried across the whole row (MXU triangular matmuls, a VMEM lookback
// ring); those were Mosaic and MXU workarounds and are not carried over.
//
// Bound on this card: device memory, 8 bytes read per sample and 16 written
// per output (P 8, R 4, M 4), ~20 flops per sample.  The first port summed
// every window directly, L terms of two shared-memory loads each, and was
// bound by shared-memory bandwidth at ~0.41 of the bytes' bound.  Design:
//   - window sums by 32-position segments aligned at output position 0, as
//     csrc/sc_detect.cu forms them: with the terms f(d') = conj(r[d'+L-1])
//     r[d'+2L-1], P[d] = sum_{d'=d-L+1..d} f(d') is the in-segment
//     inclusive prefix C(d) plus the totals of the whole segments the
//     window spans plus X(d - L), the sum of the terms after d - L in the
//     segment where it starts.  sc_detect takes that suffix as T - C(d - L),
//     which loses the quiet window next to a loud segment to cancellation;
//     here every part is a sum of the window's own terms.  O(L/32) work
//     per output, and a value's bits depend only on (row, d), never on
//     which warp computes it;
//   - sc_metric_l32_kernel (L = 32, fft 64: every configuration of the
//     receiver): a warp steps one 128-output row at a time, lane l holding
//     outputs 4l .. 4l+3; the segment prefix and suffix are serial sums
//     over the 4 slots and 3-step scans over 8 lanes, and every value 32
//     back is the same slot 8 lanes back, one shuffle.  Samples come
//     through a ring of 8 rows a warp in shared memory, filled by 8-byte
//     cp.async copies (the samples a row needs start at an odd offset,
//     2L - 1);
//   - sc_metric_kernel (any L): one output a lane per 32-output chunk,
//     5-step warp scans, and the chunk prefixes and suffixes of the last
//     ceil(L/32) + 1 chunks in a ring in shared memory;
//   - each warp owns a strip of S rows (32, or a whole batch row of up to
//     64 rows).  The gated form also computes R for the k rows on either
//     side (the halo, written nowhere), keeps each row's max of R and the
//     last k rows of M and R in shared memory, and applies cap and gate
//     before its one store of M.  P, R and M are each written once;
//   - stores: the L32 kernel writes each lane's 4 outputs as one 16-byte
//     store (P: two), shifted across lanes by one shuffle per value where
//     the batch row does not start 16-byte aligned (the funnel below); the
//     any-L kernel writes one output a lane, coalesced.
// Error bound of the summation order: every window sum is at most
// ceil(L/32) + 1 segment-local partial sums of the window's own terms
// (each of at most 32 float32 terms, to a depth of 9 additions) added
// once, so for L >= 32 its error is within ~(L/32 + 10) eps times the sum
// of the magnitudes of the terms in the window, at any block length (for
// L < 32 a window inside one segment also carries that segment's earlier
// terms).  Every operation that sets an output's bits is an explicitly
// rounded intrinsic, so the raw and the gated form give the same bits for
// P, R and M.
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kRow = 128;            // gate row (coarse_sliding_max_same's g)
constexpr int kSeg = 32;             // segment, and chunk of the any-L kernel
constexpr int kSlots = kRow / kSeg;  // L32 kernel: outputs a lane per row
constexpr int kWarps = 8;
constexpr int kStrip = 32;           // owned rows a warp (longer batch rows)
constexpr int kAhead = 8;            // L32 kernel: rows staged ahead a warp
constexpr int kMaxHalo = 8;
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;
// the any-L kernel's rings: the chunk prefixes C and suffixes X of the
// terms of P re, P im and R
enum { kCre, kCim, kCe, kXre, kXim, kXe, kRings };

__device__ __forceinline__ void terms(float2 u, float2 v, float& re,
                                     float& im, float& e) {
  // conj(u) v and |v|^2
  re = __fmaf_rn(u.x, v.x, __fmul_rn(u.y, v.y));
  im = __fmaf_rn(u.x, v.y, -__fmul_rn(u.y, v.x));
  e = __fmaf_rn(v.x, v.x, __fmul_rn(v.y, v.y));
}

__device__ __forceinline__ float raw_metric(float pre, float pim, float r) {
  const float den = fmaxf(r, 1e-12f);
  return __fdiv_rn(__fmaf_rn(pre, pre, __fmul_rn(pim, pim)),
                   __fmul_rn(den, den));
}

// ops.sync.schmidl_cox after the raw metric: _cap, then the energy gate
__device__ __forceinline__ float gated(float m, float r, float local) {
  const float c = r > 0.f ? fminf(m, 2.f) : 0.f;
  return r > __fmul_rn(0.05f, local) ? c : 0.f;
}

// inclusive prefix sum of s across the warp's lanes, and the sum over the
// lanes after this one
__device__ __forceinline__ float warp_scan(float s, int lane, float& after) {
  float z = s;
#pragma unroll
  for (int o = 1; o < kSeg; o <<= 1) {
    const float t = __shfl_up_sync(kAll, s, o);
    const float u = __shfl_down_sync(kAll, z, o);
    if (lane >= o) s = __fadd_rn(s, t);
    if (lane + o < kSeg) z = __fadd_rn(z, u);
  }
  after = __shfl_down_sync(kAll, z, 1);
  if (lane == kSeg - 1) after = 0.f;
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// One warp's strip: batch row b, owned rows [g0, g1) (outputs [lo, hi)),
// rows computed [c0, c1) (the owned ones and up to K on either side)
struct Strip {
  long long b;
  int g0, g1, c0, c1, lo, hi;

  __device__ bool init(int m, int nrows, int S, int spr, long long B,
                       int K) {
    const long long gs =
        static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    b = gs / spr;
    if (b >= B) return false;
    g0 = static_cast<int>(gs - b * spr) * S;
    g1 = min(nrows, g0 + S);
    c0 = max(0, g0 - K);
    c1 = min(nrows, g1 + K);
    lo = kRow * g0;
    hi = min(kRow * g1, m);
    return true;
  }
};

__device__ __forceinline__ void put4(float* p, const float (&o)[kSlots]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void put4(float2* p, const float2 (&o)[kSlots]) {
  float4* v = reinterpret_cast<float4*>(p);
  v[0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
  v[1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
}
__device__ __forceinline__ float from_prev(float v, int lane) {
  return __shfl_sync(kAll, v, (lane - 1) & 31);
}
__device__ __forceinline__ float2 from_prev(float2 v, int lane) {
  return make_float2(from_prev(v.x, lane), from_prev(v.y, lane));
}

// The L32 kernel's stores: lane l holds outputs d0 .. d0+3 (d0 = 128 g +
// 4l) of a row whose first output sits q elements past a 16-byte boundary.
// It writes the aligned quad d0 - q .. d0 - q + 3: the last q values of
// lane l - 1 (for lane 0, of lane 31 one call earlier: `carry`) and its
// own first 4 - q.  Calls come for consecutive rows; a last call with
// g = g1 writes what lane 31 of the last row held over.  Only outputs in
// [lo, hi) are written.
template <typename T>
struct Funnel {
  T carry[kSlots];
  int q;

  __device__ void init(int q_) {
    q = q_;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) carry[s] = T{};
  }
  __device__ __forceinline__ void store(T* base, const T (&x)[kSlots],
                                        int d0, int lo, int hi, int lane) {
    T o[kSlots];
    if (q == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) o[s] = x[s];
    } else {
      T p[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) p[s] = from_prev(x[s], lane);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const T t = p[s];
          p[s] = carry[s];
          carry[s] = t;
        }
      }
      if (q == 1) {
        o[0] = p[3]; o[1] = x[0]; o[2] = x[1]; o[3] = x[2];
      } else if (q == 2) {
        o[0] = p[2]; o[1] = p[3]; o[2] = x[0]; o[3] = x[1];
      } else {
        o[0] = p[1]; o[1] = p[2]; o[2] = p[3]; o[3] = x[0];
      }
    }
    const int dq = d0 - q;
    if (dq >= lo && dq + kSlots <= hi) {
      put4(base + dq, o);
    } else {
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        if (dq + i >= lo && dq + i < hi) base[dq + i] = o[i];
    }
  }
};

// L = 32.  A warp steps a row (128 outputs) at a time, lane l holding
// outputs 4l .. 4l+3; a 32-output segment is 8 lanes.  The samples of row
// g are r[128 g + 63 + j], j < 128; the lagged sample of each slot (32
// back) is the same slot 8 lanes back, or for lanes 0-7 lanes 24-31 of the
// previous row.
template <bool kGate>
__global__ void __launch_bounds__(kWarps * 32, 2)
sc_metric_l32_kernel(const float2* __restrict__ r, int n, int m, int nrows,
                     int S, int spr, long long B, int K,
                     float2* __restrict__ P, float* __restrict__ R,
                     float* __restrict__ M) {
  constexpr int L = kSeg;
  constexpr int off = 2 * L - 1;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Strip st;
  if (!st.init(m, nrows, S, spr, B, kGate ? K : 0)) return;
  const int per_warp =
      kAhead * (kRow / 2) + (kGate ? (K + 1) * 64 + (2 * K + 1) * 8 : 0);
  float4* wbase = smem + warp * per_warp;
  float2* ring = reinterpret_cast<float2*>(wbase);
  float4* hold = wbase + kAhead * (kRow / 2);  // [slot][lane][M, R]
  float* rcol = reinterpret_cast<float*>(hold + (K + 1) * 64);  // [slot][lane]
  const float2* row = r + st.b * n;
  const long long ob = st.b * m;
  float2* Pb = P + ob;
  float* Rb = R + ob;
  float* Mb = M + ob;
  const int seg_lane = lane & 7;
  const int lag_src = (lane - 8) & 31;        // the same slot 32 back
  const bool lag_prev = lane >= 24;            // its reader wraps

  // row g's samples: lane l copies samples l, l + 32, l + 64, l + 96 of it
  // (coalesced), and later reads back its own 4 consecutive ones
  auto issue = [&](int g) {
    float2* dst = ring + (g & (kAhead - 1)) * kRow;
    if (g < st.c1) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int j = lane + kSeg * i;
        const int p = kRow * g + off + j;
        if (p >= 0 && p < n)
          tpu_ofdm::cp_async8(dst + j, row + p);
        else
          dst[j] = make_float2(0.f, 0.f);
      }
    }
    tpu_ofdm::cp_async_commit();
  };
  auto fetch = [&](int g, float2 (&v)[kSlots]) {
    tpu_ofdm::cp_async_wait<kAhead - 1>();
    __syncwarp();
    const float4* src = reinterpret_cast<const float4*>(
        ring + (g & (kAhead - 1)) * kRow + kSlots * lane);
    const float4 a = src[0], c = src[1];
    v[0] = make_float2(a.x, a.y);
    v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(c.x, c.y);
    v[3] = make_float2(c.z, c.w);
    __syncwarp();  // every lane has read the slot before it is refilled
    issue(g + kAhead);
  };
  // C: the inclusive prefix of each slot inside its segment, X: the sum of
  // the segment's terms after it; each a serial sum over the lane's slots
  // plus a 3-step scan of the lanes' totals over the segment's 8 lanes,
  // shifted by one lane so that no term is added and taken away again
  auto scans = [&](const float (&f)[kSlots], float (&C)[kSlots],
                   float (&X)[kSlots]) {
    float a = 0.f, z = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      a = __fadd_rn(a, f[s]);
      C[s] = a;
    }
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {
      X[s] = z;
      z = __fadd_rn(z, f[s]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float ya = __shfl_up_sync(kAll, a, o, 8);
      const float yz = __shfl_down_sync(kAll, z, o, 8);
      if (seg_lane >= o) a = __fadd_rn(a, ya);
      if (seg_lane + o < 8) z = __fadd_rn(z, yz);
    }
    float before = __shfl_up_sync(kAll, a, 1, 8);
    float after = __shfl_down_sync(kAll, z, 1, 8);
    if (seg_lane == 0) before = 0.f;
    if (seg_lane == 7) after = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      C[s] = __fadd_rn(C[s], before);
      X[s] = __fadd_rn(X[s], after);
    }
  };
  // the window of L ending at each slot: the previous segment's terms
  // after d - 32 (its X, the same slot 8 lanes back), then this segment's
  // prefix
  auto window = [&](const float (&C)[kSlots], const float (&X)[kSlots],
                    const float (&pX)[kSlots], float (&out)[kSlots]) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float back = __shfl_sync(kAll, lag_prev ? pX[s] : X[s], lag_src);
      out[s] = __fadd_rn(back, C[s]);
    }
  };

  for (int i = 0; i < kAhead; ++i) issue(st.c0 - 1 + i);
  float2 vp[kSlots];
  float pXre[kSlots], pXim[kSlots], pXe[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    vp[s] = make_float2(0.f, 0.f);
    pXre[s] = pXim[s] = pXe[s] = 0.f;
  }
  Funnel<float2> fP;
  Funnel<float> fR, fM;
  fP.init(static_cast<int>(ob & 1));
  fR.init(static_cast<int>(ob & 3));
  fM.init(static_cast<int>(ob & 3));
  int hs = 0, rs = 0;  // the slots of the current row in hold and rcol
  if (kGate)
    for (int j = 0; j <= 2 * K; ++j) rcol[j * 32 + lane] = -CUDART_INF_F;
  const int gend = kGate ? st.g1 + K : st.c1;
  for (int g = st.c0 - 1; g < gend; ++g) {
    if (g < st.c1) {
      float2 v[kSlots];
      fetch(g, v);
      float fre[kSlots], fim[kSlots], fe[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float2 u;  // r 32 before v[s]
        u.x = __shfl_sync(kAll, lag_prev ? vp[s].x : v[s].x, lag_src);
        u.y = __shfl_sync(kAll, lag_prev ? vp[s].y : v[s].y, lag_src);
        terms(u, v[s], fre[s], fim[s], fe[s]);
        vp[s] = v[s];
      }
      float Cre[kSlots], Cim[kSlots], Ce[kSlots];
      float Xre[kSlots], Xim[kSlots], Xe[kSlots];
      scans(fre, Cre, Xre);
      scans(fim, Cim, Xim);
      scans(fe, Ce, Xe);
      float Pre[kSlots], Pim[kSlots], Rv[kSlots];
      window(Cre, Xre, pXre, Pre);
      window(Cim, Xim, pXim, Pim);
      window(Ce, Xe, pXe, Rv);
      if (g >= st.c0) {
        const int d0 = kRow * g + kSlots * lane;
        float Mv[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          Mv[s] = raw_metric(Pre[s], Pim[s], Rv[s]);
        if (g >= st.g0 && g < st.g1) {
          float2 Pv[kSlots];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) Pv[s] = make_float2(Pre[s], Pim[s]);
          fP.store(Pb, Pv, d0, st.lo, st.hi, lane);
          fR.store(Rb, Rv, d0, st.lo, st.hi, lane);
          if (!kGate) fM.store(Mb, Mv, d0, st.lo, st.hi, lane);
        }
        if (kGate) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            if (d0 + s < m) mx = fmaxf(mx, Rv[s]);
          rcol[rs * 32 + lane] = warp_max(mx);
          hold[(hs * 32 + lane) * 2] = make_float4(Mv[0], Mv[1], Mv[2], Mv[3]);
          hold[(hs * 32 + lane) * 2 + 1] =
              make_float4(Rv[0], Rv[1], Rv[2], Rv[3]);
        }
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        pXre[s] = Xre[s];
        pXim[s] = Xim[s];
        pXe[s] = Xe[s];
      }
    } else if (kGate) {
      rcol[rs * 32 + lane] = -CUDART_INF_F;  // no row past the batch row
    }
    if (kGate && g >= st.c0) {
      // rcol now holds the maxima of rows g - 2K .. g: row g - K is gated
      const int gf = g - K;
      if (gf >= st.g0 && gf < st.g1) {
        float local = -CUDART_INF_F;
        for (int j = 0; j <= 2 * K; ++j)
          local = fmaxf(local, rcol[j * 32 + lane]);
        const int hf = hs == K ? 0 : hs + 1;
        const float4 mh = hold[(hf * 32 + lane) * 2];
        const float4 rh = hold[(hf * 32 + lane) * 2 + 1];
        const float o[kSlots] = {gated(mh.x, rh.x, local),
                                 gated(mh.y, rh.y, local),
                                 gated(mh.z, rh.z, local),
                                 gated(mh.w, rh.w, local)};
        fM.store(Mb, o, kRow * gf + kSlots * lane, st.lo, st.hi, lane);
      }
      hs = hs == K ? 0 : hs + 1;
      rs = rs == 2 * K ? 0 : rs + 1;
    }
  }
  // what lane 31 of the last row held over
  const int d1 = kRow * st.g1 + kSlots * lane;
  const float2 z2[kSlots] = {};
  const float z[kSlots] = {};
  fP.store(Pb, z2, d1, st.lo, st.hi, lane);
  fR.store(Rb, z, d1, st.lo, st.hi, lane);
  fM.store(Mb, z, d1, st.lo, st.hi, lane);
}

// A warp's ring of the last D chunks' prefixes in shared memory; slot ks
// holds the current chunk, and `dist` counts chunks back from it.
struct Ring {
  float* base;  // kRings x D x 32 floats
  int D, ks;

  __device__ __forceinline__ float& at(int q, int dist, int i) const {
    int s = ks - dist;
    if (s < 0) s += D;
    return base[(q * D + s) * kSeg + i];
  }
  // the sum of the terms of prefix ring q (suffix ring q + 3) over the
  // window ending at this lane's output, whose start lies `dist` chunks
  // back at index i + 1: that chunk's suffix after i, the totals of the
  // chunks between, and `cur`, this lane's chunk prefix.  Within one chunk
  // (dist 0, L < 32) it is the difference of two prefixes.
  __device__ __forceinline__ float window(int q, int dist, int i,
                                          float cur) const {
    if (dist == 0) return __fsub_rn(cur, at(q, 0, i));
    float acc = at(q + 3, dist, i);
    for (int b = dist - 1; b >= 1; --b)
      acc = __fadd_rn(acc, at(q, b, kSeg - 1));
    return __fadd_rn(acc, cur);
  }
  __device__ __forceinline__ void next() { ks = ks + 1 == D ? 0 : ks + 1; }
};

// Any L: outputs d = 32 c + lane, chunk by chunk; the terms of a chunk
// read r at d + L - 1 and d + 2L - 1 directly (coalesced, one chunk ahead).
template <bool kGate>
__global__ void __launch_bounds__(kWarps * 32)
sc_metric_kernel(const float2* __restrict__ r, int n, int m, int L, int D,
                 int nrows, int S, int spr, long long B, int K,
                 float2* __restrict__ P, float* __restrict__ R,
                 float* __restrict__ M) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_warp = kRings * D * kSeg +
                       (kGate ? (K + 1) * 2 * kRow + (2 * K + 1) * kSeg : 0);
  float* wbase = reinterpret_cast<float*>(smem) + warp * per_warp;
  Strip st;
  if (!st.init(m, nrows, S, spr, B, kGate ? K : 0)) return;
  Ring ring{wbase, D, 0};
  for (int i = lane; i < kRings * D * kSeg; i += 32) wbase[i] = 0.f;
  float* hold = wbase + kRings * D * kSeg;  // [slot][M, R][128]
  float* rcol = hold + (K + 1) * 2 * kRow;   // [slot][lane]
  if (kGate)
    for (int j = 0; j <= 2 * K; ++j) rcol[j * 32 + lane] = -CUDART_INF_F;
  __syncwarp();
  const float2* row = r + st.b * n;
  const long long ob = st.b * m;
  float2* Pb = P + ob;
  float* Rb = R + ob;
  float* Mb = M + ob;
  // where the window of L ending at this lane starts: index iL + 1 of the
  // chunk dL back
  const int dL = (L - lane + kSeg - 1) / kSeg;
  const int iL = lane - L + kSeg * dL;
  auto load = [&](int p) {
    return p >= 0 && p < n ? __ldg(row + p) : make_float2(0.f, 0.f);
  };
  const int k0 = kRow / kSeg * st.c0 - (L + kSeg - 1) / kSeg;  // warm-up
  const int k1 = kRow / kSeg * st.c1;
  float2 va = load(kSeg * k0 + lane + 2 * L - 1);
  float2 ua = load(kSeg * k0 + lane + L - 1);
  int hs = 0, rs = 0;
  float mx = -CUDART_INF_F;
  auto finish_row = [&](int g) {
    // rcol holds the maxima of rows g - 2K .. g: row g - K is gated
    const int gf = g - K;
    if (gf >= st.g0 && gf < st.g1) {
      float local = -CUDART_INF_F;
      for (int j = 0; j <= 2 * K; ++j)
        local = fmaxf(local, rcol[j * 32 + lane]);
      const int hf = hs == K ? 0 : hs + 1;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int pos = j * kSeg + lane;
        const int d = kRow * gf + pos;
        if (d < st.hi)
          Mb[d] = gated(hold[hf * 2 * kRow + pos],
                        hold[(hf * 2 + 1) * kRow + pos], local);
      }
    }
    hs = hs == K ? 0 : hs + 1;
    rs = rs == 2 * K ? 0 : rs + 1;
  };
  for (int c = k0; c < k1; ++c) {
    const float2 v = va, u = ua;
    va = load(kSeg * (c + 1) + lane + 2 * L - 1);
    ua = load(kSeg * (c + 1) + lane + L - 1);
    float fre, fim, fe;
    terms(u, v, fre, fim, fe);
    float xre, xim, xe;
    const float cre = warp_scan(fre, lane, xre);
    const float cim = warp_scan(fim, lane, xim);
    const float ce = warp_scan(fe, lane, xe);
    ring.at(kCre, 0, lane) = cre;
    ring.at(kCim, 0, lane) = cim;
    ring.at(kCe, 0, lane) = ce;
    ring.at(kXre, 0, lane) = xre;
    ring.at(kXim, 0, lane) = xim;
    ring.at(kXe, 0, lane) = xe;
    __syncwarp();
    const float pre = ring.window(kCre, dL, iL, cre);
    const float pim = ring.window(kCim, dL, iL, cim);
    const float rv = ring.window(kCe, dL, iL, ce);
    __syncwarp();  // every lane has read the ring before the next write
    ring.next();
    if (c < kRow / kSeg * st.c0) continue;  // warm-up
    const int g = c / (kRow / kSeg);
    const int d = kSeg * c + lane;
    const float mv = raw_metric(pre, pim, rv);
    if (d >= st.lo && d < st.hi) {
      Pb[d] = make_float2(pre, pim);
      Rb[d] = rv;
      if (!kGate) Mb[d] = mv;
    }
    if (kGate) {
      const int pos = (c & (kRow / kSeg - 1)) * kSeg + lane;
      hold[hs * 2 * kRow + pos] = mv;
      hold[(hs * 2 + 1) * kRow + pos] = rv;
      if (d < m) mx = fmaxf(mx, rv);
      if ((c & (kRow / kSeg - 1)) == kRow / kSeg - 1) {
        rcol[rs * 32 + lane] = warp_max(mx);
        mx = -CUDART_INF_F;
        finish_row(g);
      }
    }
  }
  if (kGate) {
    for (int g = st.c1; g < st.g1 + K; ++g) {
      rcol[rs * 32 + lane] = -CUDART_INF_F;  // no row past the batch row
      finish_row(g);
    }
  }
}

int launch(bool gate, const void* r, long long n, long long B, int L, int K,
           void* P, void* R, void* M, void* stream) {
  if (L < 1 || B < 0 || n < 2LL * L || n >= (1LL << 30) || K < 0 ||
      K > kMaxHalo)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int m = static_cast<int>(n - 2LL * L + 1);
  const int nrows = (m + kRow - 1) / kRow;
  // a batch row of up to 2 strips' rows is one strip: no halo inside it
  const int S = nrows <= 2 * kStrip ? nrows : kStrip;
  const int spr = (nrows + S - 1) / S;
  const long long blocks = (B * spr + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool l32 = L == kSeg;
  const int D = (L + kSeg - 1) / kSeg + 1;
  size_t per_warp = l32 ? static_cast<size_t>(kAhead) * kRow * 8
                        : static_cast<size_t>(kRings) * D * kSeg * 4;
  if (gate)
    per_warp += static_cast<size_t>(K + 1) * kRow * 8 +
                static_cast<size_t>(2 * K + 1) * kSeg * 4;
  const size_t smem = per_warp * kWarps;
  if (smem > kSmemMax) return cudaErrorInvalidValue;  // L or K too large
  const auto* rp = static_cast<const float2*>(r);
  auto* Pp = static_cast<float2*>(P);
  auto* Rp = static_cast<float*>(R);
  auto* Mp = static_cast<float*>(M);
  auto* s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto... args) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, s>>>(
        rp, static_cast<int>(n), m, args..., nrows, S, spr, B, K, Pp, Rp,
        Mp);
    return cudaGetLastError();
  };
  cudaError_t e;
  if (l32)
    e = gate ? run(sc_metric_l32_kernel<true>)
             : run(sc_metric_l32_kernel<false>);
  else
    e = gate ? run(sc_metric_kernel<true>, L, D)
             : run(sc_metric_kernel<false>, L, D);
  return static_cast<int>(e);
}

}  // namespace

// r: B rows of n complex64 samples (interleaved float2), contiguous;
// P (complex64), R, M (float32): B rows of n - 2L + 1.  Needs L >= 1,
// 2L <= n < 2^30.  The raw metric.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int sc_metric_launch(const void* r, long long n, long long B,
                                int L, void* P, void* R, void* M,
                                void* stream) {
  return launch(false, r, n, B, L, 0, P, R, M, stream);
}

// The same, with M capped, zeroed where R = 0 and gated by the local
// energy over the rows b - k .. b + k (0 <= k <= 8).
extern "C" int sc_sync_metric_launch(const void* r, long long n, long long B,
                                     int L, int k, void* P, void* R, void* M,
                                     void* stream) {
  return launch(true, r, n, B, L, k, P, R, M, stream);
}
