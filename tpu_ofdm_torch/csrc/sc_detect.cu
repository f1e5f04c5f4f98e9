// Fused Schmidl-Cox detection: per-row summaries for frame selection.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/sc_detect.py in
// both its forms: contiguous (_sc_detect_pallas) and split [history | block]
// (_sc_detect_pallas_hist).  Here both are one kernel that reads the
// virtual buffer [head | x] (h = 0 gives the contiguous form).
//
// Batched: B rows of samples, each its own virtual buffer [head_b | x_b]
// (the wideband receiver's channels; the batched form of the JAX kernel,
// tpu_ofdm/kernels/sc_detect.py:470-502).  B = 1 is the streaming receiver.
//
// Output: a (6, B, rows) float32 array, rows = ceil((h + n) / 128), with the
// six row summaries of tpu_ofdm.ops.sync._detect_rows_jnp, indexed by the
// trailing position t of each window in virtual coordinates (L = fft/2,
// W = cp + 1, c = cp - cp/2):
//   prod(u) = conj(v[u-L]) v[u],  e(u) = |v[u]|^2
//   P(t) = sum_{u=t-L+1..t} prod(u),  R2(t) = sum e(u),  R1(t) = R2(t-L)
//   M(t) = min(|P|^2 / (R1 R2), 2), or 0 where R1 R2 = 0
//   sm(t) = sum_{s=t-W+1..t} M(s) / W + (t & 0xFFFF) * 1e-7 for
//           2L+W-2 <= t < nv, else -inf
//   row 0: max sm; row 1: first argmax, a global int32 position stored as
//   its bit pattern; rows 2-4: P re, P im, R2 at t* - c (0 outside
//   [2L-1, nv)); row 5: max of R2 over the row (0 outside [2L-1, nv)).
//
// The TPU kernel formed the window sums as bf16 hi/lo banded matmuls over
// 2-D VMEM rings and packed a row-relative f32 argmax; those were Mosaic
// and MXU workarounds and are not carried over.
//
// Bound on this card: device memory.  The kernel must read 8 bytes per
// sample and write 24 bytes per 128-sample row; its arithmetic is ~25 flops
// per sample, far under the float32 peak.  What stands between it and that
// bound is the work a warp issues per sample, above all the shuffles and
// shared-memory accesses, which share one pipe on the SM.  So the design
// keeps that work O(1) and small, and keeps enough warps in flight to hide
// the loads:
//   - each warp walks a strip of 16 rows (2048 positions) of one batch row
//     (grid.y), after a warm-up of ceil((2L+W+31)/32) 32-position chunks,
//     and loads its samples coalesced, ahead of their use.  Warps share
//     nothing: no block barrier;
//   - window sums by 32-position segments aligned at position 0 (van Herk /
//     Gil-Werman applied to sums): C is the inclusive prefix inside each
//     segment, and a window of length L ending at t is C(t) plus the totals
//     of the whole segments it spans plus the suffix T_a - C_a(t - L) of
//     the segment a where it starts.  No sum runs longer than one segment,
//     so there is no running total to drift;
//   - R1(t) = R2(t-L) is read back, not summed again; the W-boxcar of M is
//     the same segment sum over M;
//   - each row's max, first argmax and R2 max come from one warp reduction.
// Two kernels share this.  sc_detect_l32_kernel runs at L = 32 and cp = 16
// (fft 64, every configuration of the receiver): a window then reaches
// back one segment at most, so every value it needs stays in registers.
// A warp steps a row at a time, lane l holding positions 4l .. 4l+3; a
// segment prefix is a serial sum over the lane's 4 positions plus a 3-step
// scan over the segment's 8 lanes, and every value 32 positions back is
// the same slot 8 lanes back, one shuffle.  It forms the start of a window
// as E_a(t - 32), the segment's terms after t - 32 summed by a suffix scan,
// in place of T_a - C_a(t - 32), and takes the earlier lanes' part of a
// prefix from the lane before: every partial sum then holds only terms of
// its window, so its error is a few eps of the window's own magnitudes.
// Differences of prefixes lost eps times a strong burst next to a quiet
// window, at a burst's trailing edge: a relative error that grows as the
// SNR squared.
// ~75 shuffles per row.  Its rows
// come through a ring of 8 rows a warp in shared memory, filled by 16-byte
// cp.async copies, so that ~190 KB per SM are under way without holding
// registers (two rows a warp read ahead into registers measured slower).
// sc_detect_kernel takes any L and W: one position a
// lane per 32-position chunk, 5-step warp scans, and the chunk prefixes, P
// and R2 of the last D chunks in a ring in shared memory (D =
// max(ceil(L/32)+1, ceil(W/32)+1, 4+ceil(c/32))), from which the windows,
// R1 and the picks at t* - c are read back.
// Error bound of the summation order: every window sum is at most
// ceil(L/32)+1 segment-local partial sums (each of at most 32 float32
// terms, to a depth of 7 additions) added once, so its error is within
// ~(L/32 + 8) eps times the sum of the magnitudes of the terms in the
// window (sc_detect_l32_kernel) or in the window and the segments at its
// ends (sc_detect_kernel, which still takes T_a - C_a), at any block
// length.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"

namespace {

constexpr int kRow = 128;           // candidate granularity (ops.sync.ROW)
constexpr int kChunk = 32;          // positions a warp handles per step
constexpr int kRowsPerWarp = 16;
constexpr int kWarpsMax = 8;
constexpr int kL32Cp = 16;  // sc_detect_l32_kernel's cp (W <= 32 for its sums)
// rows a warp of sc_detect_l32_kernel keeps in flight (1 KB each): enough
// bytes under way per SM to cover device-memory latency
constexpr int kAhead = 8;
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;
// the any-L kernel's rings: P re, P im, R2, and the chunk prefixes of
// prod re, prod im, e and M
enum { kWre, kWim, kWr2, kCre, kCim, kCe, kCm, kRings };

__device__ __forceinline__ int floor_div32(int a) {
  return (a >= 0 ? a : a - (kChunk - 1)) / kChunk;
}

// inclusive prefix sum of s across the warp's lanes
__device__ __forceinline__ float warp_scan(float s, int lane) {
#pragma unroll
  for (int o = 1; o < kChunk; o <<= 1) {
    const float t = __shfl_up_sync(kAll, s, o);
    if (lane >= o) s += t;
  }
  return s;
}

// A warp's ring of the last D chunks in shared memory; slot ks holds the
// current chunk k, and `dist` counts chunks back from it.
struct Ring {
  float* base;  // rings x D x 32 floats
  int D, ks;

  __device__ __forceinline__ float& at(int q, int dist, int i) const {
    int s = ks - dist;
    if (s < 0) s += D;
    return base[(q * D + s) * kChunk + i];
  }
  // the sum of ring q's terms over the window ending at this lane's
  // position, whose start lies `dist` chunks back at index i + 1; cur is
  // this lane's chunk prefix
  __device__ __forceinline__ float window(int q, int dist, int i,
                                          float cur) const {
    float acc = dist > 0 ? at(q, dist, kChunk - 1) - at(q, dist, i)
                         : -at(q, 0, i);
    for (int b = dist - 1; b >= 1; --b) acc += at(q, b, kChunk - 1);
    return acc + cur;
  }
  __device__ __forceinline__ void next() { ks = ks + 1 == D ? 0 : ks + 1; }
};

// One warp's view of its batch row's virtual buffer [head | x], which it
// reads at positions [lo, hi)
struct Strip {
  const float2* head;
  const float2* x;
  int h, nv;
  bool inside;  // [lo, hi) lies in x: no bounds or head tests

  __device__ Strip(const float2* head_, long long head_stride,
                   const float2* x_, long long x_stride, int h_, int nv_,
                   int lo, int hi)
      : head(head_ ? head_ + blockIdx.y * head_stride : nullptr),
        x(x_ + blockIdx.y * x_stride), h(h_), nv(nv_),
        inside(lo >= h_ && hi <= nv_) {}
  __device__ __forceinline__ float2 load(int p) const {
    if (inside) return x[p - h];
    if (p < 0 || p >= nv) return make_float2(0.f, 0.f);
    return p < h ? head[p] : x[p - h];
  }
};

// A row's running max of sm, its first argmax and the max of R2
struct RowMax {
  float best, rmax;
  int arg;

  __device__ __forceinline__ void reset(int t0) {
    best = -CUDART_INF_F;
    rmax = 0.f;
    arg = t0;  // an all -inf row resolves to its first position
  }
  // position t, its boxcar sum and R2; rW = 1 / W
  __device__ __forceinline__ void add(int t, float box, float r2, float rW,
                                      int t_sm, int t_pr, int nv) {
    if (t >= t_sm && t < nv) {
      const float sm = box * rW + static_cast<float>(t & 0xFFFF) * 1e-7f;
      if (sm > best) {  // strict: the first maximum wins
        best = sm;
        arg = t;
      }
    }
    if (t >= t_pr && t < nv) rmax = fmaxf(rmax, r2);
  }
  // every lane ends with the row's max, first argmax and R2 max
  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kAll, best, off);
      const int oa = __shfl_xor_sync(kAll, arg, off);
      rmax = fmaxf(rmax, __shfl_xor_sync(kAll, rmax, off));
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
  }
  // after the row's last chunk k: reduce, then lane 0 writes the six
  // summaries, P and R2 picked at t* - c from the ring
  __device__ __forceinline__ void finish(const Ring& ring, int k, int lane,
                                         int c, int t_pr, int nv, int rows,
                                         float* out) {
    reduce();
    if (lane == 0) {
      const long long plane = gridDim.y * static_cast<long long>(rows);
      float* o = out + blockIdx.y * static_cast<long long>(rows) + (k >> 2);
      const int tc = arg - c;
      const bool ok = tc >= t_pr && tc < nv;
      const int dist = ok ? k - (tc >> 5) : 0;
      const int i = tc & (kChunk - 1);
      o[0] = best;
      o[plane] = __int_as_float(arg);
      o[2 * plane] = ok ? ring.at(kWre, dist, i) : 0.f;
      o[3 * plane] = ok ? ring.at(kWim, dist, i) : 0.f;
      o[4 * plane] = ok ? ring.at(kWr2, dist, i) : 0.f;
      o[5 * plane] = rmax;
    }
    reset(kChunk * (k + 1) + lane);
  }
};

__device__ __forceinline__ float metric(float pre, float pim, float r1,
                                        float r2) {
  const float den = r1 * r2;
  const float p2 = pre * pre + pim * pim;
  return den > 0.f ? fminf(__fdividef(p2, fmaxf(den, 1e-12f)), 2.f) : 0.f;
}

// The main path's kernel: L = 32, cp = 16 (W = 17, c = 8).  A warp steps
// a row (128 positions) at a time, lane l holding positions 4l .. 4l+3 of
// it; a 32-position segment is 8 lanes.  Every window then reaches back one
// segment at most: to the same slot 8 lanes back (or, for the first
// segment, lanes 24-31 of the previous row, which every lane keeps in
// registers).  So every intermediate lives in registers and moves by
// shuffles: a lane sends its previous row's value where its reader wraps
// into it.
__global__ void __launch_bounds__(kWarpsMax * 32, 3)
sc_detect_l32_kernel(const float2* __restrict__ head, int h,
                     long long head_stride, const float2* __restrict__ x,
                     int nv, long long x_stride, int rows,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int W = kL32Cp + 1;
  constexpr int c = kL32Cp - kL32Cp / 2;
  constexpr int L = kChunk;
  constexpr int kSlots = kRow / kChunk;  // positions a lane holds per row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp;
  if (row0 >= rows) return;
  const int row1 = min(rows, row0 + kRowsPerWarp);
  const int r0 = row0 - 1;  // one row of warm-up covers 2L + W + 31 <= 127
  const Strip st(head, head_stride, x, x_stride, h, nv, kRow * (r0 - 1),
                 kRow * row1);
  const bool vec = st.inside && ((reinterpret_cast<uintptr_t>(st.x) -
                                  8ull * static_cast<unsigned>(h)) & 15) == 0;
  const long long plane = gridDim.y * static_cast<long long>(rows);
  out += blockIdx.y * static_cast<long long>(rows);
  const int t_sm = 2 * L + W - 2;
  const int t_pr = 2 * L - 1;
  const float rW = 1.f / static_cast<float>(W);
  const int seg_lane = lane & 7;
  const int lag_src = (lane - 8) & 31;          // the same slot 32 back
  const bool lag_prev = lane >= 24;              // its reader wraps
  const int tot_src = ((lane & ~7) - 1) & 31;    // the previous segment's end
  const bool tot_prev = lane == 31;

  // rows go through a ring of kAhead rows in shared memory, each lane
  // copying (and later reading back) its own 4 samples of a row: 16-byte
  // asynchronous copies where the strip lies in x, plain loads elsewhere
  float4* ahead = reinterpret_cast<float4*>(smem) +
                  (warp * kAhead) * (kRow / 2) + 2 * lane;
  auto issue = [&](int r) {
    float4* dst = ahead + ((r - r0 + 1) & (kAhead - 1)) * (kRow / 2);
    const int p = kRow * r + kSlots * lane;
    if (r < row1) {
      if (vec) {
        const float2* src = st.x + (p - h);
        tpu_ofdm::cp_async16(dst, src);
        tpu_ofdm::cp_async16(dst + 1, src + 2);
      } else {
        float2 v[kSlots];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) v[s] = st.load(p + s);
        dst[0] = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
        dst[1] = make_float4(v[2].x, v[2].y, v[3].x, v[3].y);
      }
    }
    tpu_ofdm::cp_async_commit();
  };
  // row r's samples, once its copies have landed; then the copies of row
  // r + kAhead start
  auto fetch = [&](int r, float2 (&v)[kSlots]) {
    tpu_ofdm::cp_async_wait<kAhead - 1>();
    const float4* src = ahead + ((r - r0 + 1) & (kAhead - 1)) * (kRow / 2);
    const float4 a = src[0], b = src[1];
    v[0] = make_float2(a.x, a.y);
    v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(b.x, b.y);
    v[3] = make_float2(b.z, b.w);
    issue(r + kAhead);
  };
  // C of this lane's slots: serial over the slots, then an inclusive scan
  // of the lanes' totals over the segment's 8 lanes; `seg` gets the sum of
  // the segment up to and including this lane
  auto prefix = [&](const float (&f)[kSlots], float (&C)[kSlots],
                    float& seg) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      a += f[s];
      C[s] = a;
    }
    seg = a;
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float y = __shfl_up_sync(kAll, seg, o, 8);
      if (seg_lane >= o) seg += y;
    }
    // the earlier lanes' sum, taken from the lane before (not seg - a,
    // which would lose eps * a to a strong term after the slot)
    float before = __shfl_up_sync(kAll, seg, 1, 8);
    if (seg_lane == 0) before = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) C[s] += before;
  };
  // E of this lane's slots: the sum of the segment's terms after each slot,
  // summed directly (serial over the later slots, then an exclusive scan
  // of the later lanes' totals), never as a difference of prefixes
  auto suffix = [&](const float (&f)[kSlots], float (&E)[kSlots]) {
    float b = 0.f;
#pragma unroll
    for (int s = kSlots - 1; s >= 0; --s) {
      E[s] = b;
      b += f[s];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float y = __shfl_down_sync(kAll, b, o, 8);
      if (seg_lane + o < 8) b += y;
    }
    float after = __shfl_down_sync(kAll, b, 1, 8);
    if (seg_lane == 7) after = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) E[s] += after;
  };
  // the window of L ending at each slot: the previous segment's terms past
  // t - 32, E(t - 32), then this segment's prefix.  Both parts hold only
  // terms of the window, so a strong burst just before it costs no
  // precision (T - C(t - 32) would lose eps * T)
  auto window = [&](const float (&C)[kSlots], const float (&E)[kSlots],
                    const float (&pE)[kSlots], float (&out_)[kSlots]) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float back = __shfl_sync(kAll, lag_prev ? pE[s] : E[s], lag_src);
      out_[s] = back + C[s];
    }
  };
  auto pick = [](const float (&a)[kSlots], int s) {
    return s == 0 ? a[0] : s == 1 ? a[1] : s == 2 ? a[2] : a[3];
  };

  for (int i = 0; i < kAhead; ++i) issue(r0 - 1 + i);
  float2 v[kSlots], vp[kSlots];
  fetch(r0 - 1, vp);
  // the previous row: segment suffixes, P, R2, M prefix and segment sum
  float pEre[kSlots] = {}, pEim[kSlots] = {}, pEe[kSlots] = {};
  float pPre[kSlots] = {}, pPim[kSlots] = {}, pR2[kSlots] = {};
  float pCm[kSlots] = {};
  float psm = 0.f;
  for (int r = r0; r < row1; ++r) {
    fetch(r, v);

    float fre[kSlots], fim[kSlots], fe[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float2 l;  // v[t - 32]
      l.x = __shfl_sync(kAll, lag_prev ? vp[s].x : v[s].x, lag_src);
      l.y = __shfl_sync(kAll, lag_prev ? vp[s].y : v[s].y, lag_src);
      fre[s] = l.x * v[s].x + l.y * v[s].y;
      fim[s] = l.x * v[s].y - l.y * v[s].x;
      fe[s] = v[s].x * v[s].x + v[s].y * v[s].y;
      vp[s] = v[s];
    }
    float Cre[kSlots], Cim[kSlots], Ce[kSlots], sre, sim, se;
    float Ere[kSlots], Eim[kSlots], Ee[kSlots];
    prefix(fre, Cre, sre);
    prefix(fim, Cim, sim);
    prefix(fe, Ce, se);
    suffix(fre, Ere);
    suffix(fim, Eim);
    suffix(fe, Ee);
    float Pre[kSlots], Pim[kSlots], R2[kSlots], m[kSlots];
    window(Cre, Ere, pEre, Pre);
    window(Cim, Eim, pEim, Pim);
    window(Ce, Ee, pEe, R2);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float r1 = __shfl_sync(kAll, lag_prev ? pR2[s] : R2[s], lag_src);
      m[s] = metric(Pre[s], Pim[s], r1, R2[s]);
    }
    float Cm[kSlots], sm_seg;
    prefix(m, Cm, sm_seg);
    const float Tm = __shfl_sync(kAll, tot_prev ? psm : sm_seg, tot_src);

    RowMax rm;
    rm.reset(kRow * r + kSlots * lane);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      // the boxcar's prefix ends at t - W: slot s' of the lane dl back
      const int d = s - W;
      const int dl = d >= 0 ? 0 : -((kSlots - 1 - d) / kSlots);
      const int sp = d - kSlots * dl;
      const bool wraps = lane >= kChunk + dl;  // my reader is in the next row
      const float got = __shfl_sync(
          kAll, wraps ? pick(pCm, sp) : pick(Cm, sp), (lane + dl) & 31);
      const int t = kRow * r + kSlots * lane + s;
      const float box = (t & (kChunk - 1)) >= W ? Cm[s] - got
                                                : (Tm - got) + Cm[s];
      rm.add(t, box, R2[s], rW, t_sm, t_pr, nv);
    }
    if (r >= row0) {
      rm.reduce();
      // P and R2 at t* - c: the lane that holds it writes them
      const int tc = rm.arg - c;
      const bool ok = tc >= t_pr && tc < nv;
      const int rel = tc - kRow * (r - 1);  // in [0, 256): previous row first
      const int owner = (rel & (kRow - 1)) / kSlots;
      const int s = rel & (kSlots - 1);
      if (lane == 0) {
        out[r] = rm.best;
        out[plane + r] = __int_as_float(rm.arg);
        out[5 * plane + r] = rm.rmax;
        if (!ok) {
          out[2 * plane + r] = 0.f;
          out[3 * plane + r] = 0.f;
          out[4 * plane + r] = 0.f;
        }
      }
      if (ok && lane == owner) {
        const bool now = rel >= kRow;
        out[2 * plane + r] = now ? pick(Pre, s) : pick(pPre, s);
        out[3 * plane + r] = now ? pick(Pim, s) : pick(pPim, s);
        out[4 * plane + r] = now ? pick(R2, s) : pick(pR2, s);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      pEre[s] = Ere[s];
      pEim[s] = Eim[s];
      pEe[s] = Ee[s];
      pPre[s] = Pre[s];
      pPim[s] = Pim[s];
      pR2[s] = R2[s];
      pCm[s] = Cm[s];
    }
    psm = sm_seg;
  }
}

// Any L and W: the chunk prefixes go to the ring too, and a window sums
// them over as many chunks as it spans.
__global__ void __launch_bounds__(kWarpsMax * 32)
sc_detect_kernel(const float2* __restrict__ head, int h, long long head_stride,
                 const float2* __restrict__ x, int nv, long long x_stride,
                 int L, int W, int c, int D, int rows,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Ring ring{smem + warp * kRings * D * kChunk, D, 0};
  for (int i = lane; i < kRings * D * kChunk; i += 32) ring.base[i] = 0.f;
  __syncwarp();
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * kRowsPerWarp;
  if (row0 >= rows) return;
  // chunks [k0, kf) warm up: every C, P, R2 and M that a position of the
  // strip reads lies at or after chunk k0
  const int k0 = floor_div32(row0 * kRow - 2 * L - W - (kChunk - 1));
  const int kf = row0 * (kRow / kChunk);
  const int k1 = min(rows, row0 + kRowsPerWarp) * (kRow / kChunk);
  const Strip st(head, head_stride, x, x_stride, h, nv, kChunk * k0 - L,
                 kChunk * (k1 + 2));
  // where the windows of L and of W ending at this lane start
  const int dL = (L - lane + kChunk - 1) / kChunk;
  const int iL = lane - L + kChunk * dL;
  const int dW = (W - lane + kChunk - 1) / kChunk;
  const int iW = lane - W + kChunk * dW;
  const int t_sm = 2 * L + W - 2;
  const int t_pr = 2 * L - 1;
  const float rW = 1.f / static_cast<float>(W);

  float2 va = st.load(kChunk * k0 + lane);
  float2 la = st.load(kChunk * k0 + lane - L);
  float2 vb = st.load(kChunk * (k0 + 1) + lane);
  float2 lb = st.load(kChunk * (k0 + 1) + lane - L);
  RowMax rm;
  rm.reset(kChunk * kf + lane);
  for (int k = k0; k < k1; ++k) {
    const float2 v = va, vl = la;
    va = vb;
    la = lb;
    vb = st.load(kChunk * (k + 2) + lane);
    lb = st.load(kChunk * (k + 2) + lane - L);

    const float cre = warp_scan(vl.x * v.x + vl.y * v.y, lane);
    const float cim = warp_scan(vl.x * v.y - vl.y * v.x, lane);
    const float ce = warp_scan(v.x * v.x + v.y * v.y, lane);
    ring.at(kCre, 0, lane) = cre;
    ring.at(kCim, 0, lane) = cim;
    ring.at(kCe, 0, lane) = ce;
    __syncwarp();
    const float pre = ring.window(kCre, dL, iL, cre);
    const float pim = ring.window(kCim, dL, iL, cim);
    const float r2 = ring.window(kCe, dL, iL, ce);
    ring.at(kWre, 0, lane) = pre;
    ring.at(kWim, 0, lane) = pim;
    ring.at(kWr2, 0, lane) = r2;
    __syncwarp();
    const float m = metric(pre, pim, ring.at(kWr2, dL, iL), r2);
    const float cm = warp_scan(m, lane);
    ring.at(kCm, 0, lane) = cm;
    __syncwarp();

    if (k >= kf) {
      rm.add(kChunk * k + lane, ring.window(kCm, dW, iW, cm), r2, rW, t_sm,
             t_pr, nv);
      if ((k & 3) == 3) rm.finish(ring, k, lane, c, t_pr, nv, rows, out);
    }
    ring.next();
  }
}

}  // namespace

// head: B rows of h complex64 samples, row b at head + b * head_stride
// (may be null when h == 0); x: B rows of n samples, row b at
// x + b * x_stride; out: (6, B, rows) float32 with rows = ceil((h + n) /
// 128).  h + n < 2^30.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sc_detect_launch(const void* head, long long h,
                                long long head_stride, const void* x,
                                long long n, long long x_stride, int B, int L,
                                int cp, void* out, long long rows,
                                void* stream) {
  if (L < 1 || cp < 0 || h < 0 || n < 0 || B < 0 || B > 65535 ||
      h + n >= (1LL << 30))
    return cudaErrorInvalidValue;
  if (rows == 0 || B == 0) return cudaSuccess;
  const int W = cp + 1;
  const int c = cp - cp / 2;
  const bool l32 = L == kChunk && cp == kL32Cp;
  // the any-L kernel's ring depth: the picks reach back 3 + ceil(c/32)
  // chunks, the windows ceil(L/32) and ceil(W/32)
  auto chunks = [](int v) { return (v + kChunk - 1) / kChunk; };
  const int D = std::max({chunks(L) + 1, chunks(W) + 1, 4 + chunks(c)});
  const size_t per_warp = static_cast<size_t>(kRings) * D * kChunk * 4;
  const int warps =
      l32 ? kWarpsMax
          : static_cast<int>(std::min<size_t>(kWarpsMax, kSmemMax / per_warp));
  if (warps < 1) return cudaErrorInvalidValue;  // L, cp too large
  const size_t smem =
      l32 ? static_cast<size_t>(warps) * kAhead * kRow * 8 : per_warp * warps;
  const long long strips = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>((strips + warps - 1) / warps), B);
  const auto* hp = static_cast<const float2*>(head);
  const auto* xp = static_cast<const float2*>(x);
  auto* op = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto... args) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, warps * 32, smem, s>>>(
        hp, static_cast<int>(h), head_stride, xp, static_cast<int>(h + n),
        x_stride, args..., static_cast<int>(rows), op);
    return cudaGetLastError();
  };
  return static_cast<int>(l32 ? run(sc_detect_l32_kernel)
                              : run(sc_detect_kernel, L, W, c, D));
}
