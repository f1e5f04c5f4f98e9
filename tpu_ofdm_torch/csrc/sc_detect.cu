// Fused Schmidl-Cox detection: per-row summaries for frame selection.
//
// Replaces the Pallas kernel `_kernel` of tpu_ofdm/kernels/sc_detect.py in
// both its forms: contiguous (_sc_detect_pallas) and split [history | block]
// (_sc_detect_pallas_hist).  Here both are one launch that reads the
// virtual buffer [head | x] (h = 0 gives the contiguous form), of one of
// three kernels chosen by (L, cp) (below).
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
//   - each warp walks a strip of rows of one batch row (grid.y), after a
//     warm-up that covers every window its first row reads, and loads its
//     samples coalesced, ahead of their use.  Warps share nothing: no
//     block barrier;
//   - window sums by segments aligned at position 0 (van Herk / Gil-Werman
//     applied to sums): C is the inclusive prefix inside each segment, and
//     a window of length L ending at t is C(t) plus the totals of the
//     whole segments it spans plus the suffix E_a(t - L) of the segment a
//     where it starts, summed directly.  No sum runs longer than one
//     segment, so there is no running total to drift;
//   - R1(t) = R2(t-L) is read back, not summed again; the W-boxcar of M is
//     the same segment sum over M;
//   - each row's max, first argmax and R2 max come from one warp reduction.
// Three kernels share this, chosen by (L, cp) in sc_detect_launch
// (kernels/sc_detect.py `kernel_form` names them):
// sc_detect_l32_kernel runs at L = 32 and cp = 16
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
// sc_detect_seg_kernel<L / 32> runs at L a multiple of 32 in [64, 512] and
// cp in [0, 2L) (fft 128, 256, 512, 1024, and the other multiples of 64
// up to 1024): the L = 32 kernel's row steps, 4 positions a lane, and its
// cp.async row ring (4 rows a warp to L 128), with segments of S = 64
// positions (16 lanes) below L = 128 and of a whole row (S = 128) from
// there on, so that t - L always lies in an earlier segment than t.  A
// window ending at t is E(t - L), the terms of t - L's segment after it
// (a suffix scan), plus the totals of the whole segments between, plus
// t's segment prefix C(t).  The values at t - L (v, E, and R2 for R1) sit
// in the same slot of the lane L/4 back: at L 64 and 96 a shuffle that
// wraps into the previous row's registers, at L 128 the same lane's
// registers of the previous row, past that a ring of rows in shared
// memory (the samples from the cp.async ring, 8 + L/128 + 2 rows deep; E,
// R2 and P of the last L/128 + 2 rows beside it, from which the picks at
// t* - c are read too).  The W-boxcar of M is Cm(t) + the M totals of the
// rows between - Cm(t - W), on a ring of row prefixes of M in shared
// memory.  A strip of a warp warms up over ceil((2L + W - 2) / 128) rows
// and runs max(32, 10 x that) rows: 3 of 32 (9.4%) at fft 256 / cp 64.
// At L 128 a row costs 58 shuffles (six 6-step scans for P and R2, one
// for M and its total, 15 for the row reduction) and 5 shared-memory
// accesses besides its samples, against the any-L kernel's ~175 shuffles
// and ~120 ring accesses for the same 128 positions: ~0.25 against 0.75
// ms at [4096 | 2^25] on an H100 80GB HBM3 at 700 W (2026-10-17,
// kernel_ab.py; PERF.md).  128 registers a thread at L 128, 105-113 past
// it, no spill; 16 warps an SM.
// sc_detect_kernel takes any L and W: one position a
// lane per 32-position chunk, 5-step warp scans, and the chunk prefixes and
// suffixes, P and R2 of the last D chunks in a ring in shared memory (D =
// max(ceil(L/32)+1, ceil(W/32)+1, 4+ceil(c/32))), from which the windows,
// R1 and the picks at t* - c are read back.  It too forms a window's start
// as the suffix of the chunk where it starts, summed by a reverse warp
// scan (for P, R2 and the W-boxcar of M), never as T_a - C_a.  It runs
// where the other two do not: L not a multiple of 32, L > 512, cp >= 2L.
// Error bound of the summation order: every window sum of P and R2 is at
// most L/S + 1 segment-local partial sums (each of at most S float32
// terms, S = 32 in the L = 32 and any-L kernels and 64 or 128 in the
// segment kernel, to a depth of at most 11 additions), added once, each
// holding only terms of the window, so its error is within ~(L/S + 11)
// eps times the sum of the magnitudes of the terms in the window, in all
// three kernels, at any block length.  The W-boxcar of M is a difference
// of prefixes where its window lies inside one chunk, at lanes past W - 1
// when W < 32, in the any-L kernel; in the L = 32 kernel as T_a - C_a;
// and in the segment kernel throughout (M's terms lie in [0, 2], so it
// loses at most ~eps times the M summed over the rows it spans: ~64 eps
// in the first two, up to ~2W + 256 eps in the third).  P and R2 are a
// difference at L < 32 only (fft_len < 64, no configuration of the
// receiver).
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
// the any-L kernel's rings: P re, P im, R2, the chunk prefixes of prod re,
// prod im, e and M, and their chunk suffixes
enum { kWre, kWim, kWr2, kCre, kCim, kCe, kCm, kSre, kSim, kSe, kSm, kRings };

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

// inclusive suffix sum of s across the warp's lanes (lane i gets the sum
// over lanes i .. 31)
__device__ __forceinline__ float warp_suffix(float s, int lane) {
#pragma unroll
  for (int o = 1; o < kChunk; o <<= 1) {
    const float t = __shfl_down_sync(kAll, s, o);
    if (lane + o < kChunk) s += t;
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
  // the sum of the terms of prefix ring q (suffix ring sq) over the window
  // ending at this lane's position, whose start lies `dist` chunks back at
  // index i + 1; cur is this lane's chunk prefix.  The start chunk gives
  // its suffix past i, the chunks between their totals: each part holds
  // only terms of the window.  A window inside the current chunk (dist 0)
  // is cur - C(i).
  __device__ __forceinline__ float window(int q, int sq, int dist, int i,
                                          float cur) const {
    if (dist == 0) return cur - at(q, 0, i);
    float acc = i + 1 < kChunk ? at(sq, dist, i + 1) : 0.f;
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

// inclusive prefix C of a lane's 4 slots over its segment of kLanes lanes:
// serial over the slots, then a scan of the lanes' totals; `seg` gets the
// segment's sum up to and including this lane, and the earlier lanes' part
// of C comes from the lane before (not seg - a, which would lose eps * a)
template <int kLanes>
__device__ __forceinline__ void seg_prefix(const float (&f)[4], float (&C)[4],
                                           float& seg, int sl) {
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a += f[s];
    C[s] = a;
  }
  seg = a;
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const float y = __shfl_up_sync(kAll, seg, o, kLanes);
    if (sl >= o) seg += y;
  }
  float before = __shfl_up_sync(kAll, seg, 1, kLanes);
  if (sl == 0) before = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) C[s] += before;
}

// E of a lane's 4 slots: the segment's terms after each slot, summed
// directly (serial over the later slots, then the later lanes' totals)
template <int kLanes>
__device__ __forceinline__ void seg_suffix(const float (&f)[4], float (&E)[4],
                                           int sl) {
  float b = 0.f;
#pragma unroll
  for (int s = 3; s >= 0; --s) {
    E[s] = b;
    b += f[s];
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const float y = __shfl_down_sync(kAll, b, o, kLanes);
    if (sl + o < kLanes) b += y;
  }
  float after = __shfl_down_sync(kAll, b, 1, kLanes);
  if (sl == kLanes - 1) after = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) E[s] += after;
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
    seg_prefix<8>(fre, Cre, sre, seg_lane);
    seg_prefix<8>(fim, Cim, sim, seg_lane);
    seg_prefix<8>(fe, Ce, se, seg_lane);
    seg_suffix<8>(fre, Ere, seg_lane);
    seg_suffix<8>(fim, Eim, seg_lane);
    seg_suffix<8>(fe, Ee, seg_lane);
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
    seg_prefix<8>(m, Cm, sm_seg, seg_lane);
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

// -- sc_detect_seg_kernel: L = 32 Q, 2 <= Q <= 16, cp in [0, 2L) ------------

constexpr int kSegWarps = 4;       // warps a block, at most
constexpr int kSegStripMin = 32;   // rows a warp, at least
constexpr int kSegWarmShare = 10;  // a strip runs >= 10 x its warm-up rows
// the per-position values of the segment kernel's row ring in shared memory
// (L > 128): E of prod re, prod im and e, R2, P re, P im
enum { kHEre, kHEim, kHEe, kHR2, kHPre, kHPim, kHistQ };

template <int Q>
struct SegShape {
  static constexpr int L = kChunk * Q;
  // L <= 128: every value at t - L lies in this row or the previous one,
  // in registers
  static constexpr bool kRegs = L <= kRow;
  static constexpr int kLanes = L < kRow ? 16 : 32;  // lanes a segment
  static constexpr int kRowsBack = L / kRow;         // t - L: rows back
  static constexpr int kLaneLag = L % kRow / 4;      // and lanes back
  // rows a warp keeps in flight: 4 measured 2.4% faster than 8 at L 128
  // (0.2482-0.2487 ms against 0.2543-0.2553 at [4096 | 2^25] on an H100
  // 80GB HBM3 at 700 W, 2026-10-17, kernel_ab.py) and 4% slower at L 512,
  // where the ring also feeds v[u - L]
  static constexpr int kAheadRows = kRegs ? 4 : kAhead;
  // sample rows in flight and kept: rows r - kRowsBack - 1 .. r + kAheadRows
  static constexpr int kRing =
      kRegs ? kAheadRows : kAheadRows + kRowsBack + 2;
  static constexpr int kHist = kRegs ? 0 : kRowsBack + 2;
  static constexpr int kMBack = (2 * L + kRow - 1) / kRow;  // t - W, W <= 2L
  static constexpr int kCmRows = kMBack + 1;
  static constexpr size_t kSmemWarp =
      static_cast<size_t>(kRing) * kRow * 8 +
      static_cast<size_t>(kHist * kHistQ + kCmRows) * kRow * 4;
};

__device__ __forceinline__ float elem(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ float4 as4(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void from4(const float4& a, float (&o)[4]) {
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
}

// One warp a strip of `strip` rows of one batch row (grid.y), after `warm`
// rows of warm-up; lane l holds positions 4l .. 4l+3 of a row.
template <int Q>
__global__ void __launch_bounds__(kSegWarps * 32, 4)
sc_detect_seg_kernel(const float2* __restrict__ head, int h,
                     long long head_stride, const float2* __restrict__ x,
                     int nv, long long x_stride, int W, int c, int strip,
                     int warm, int rows, float* __restrict__ out) {
  using S = SegShape<Q>;
  constexpr int L = S::L;
  constexpr int kLb = S::kLaneLag;
  constexpr int kRb = S::kRowsBack;
  constexpr int kSlots = kRow / kChunk;  // positions a lane holds per row
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const base = smem + warp * (S::kSmemWarp / 4);
  float4* const ring = reinterpret_cast<float4*>(base);  // kRing x 64
  float* const hist = base + S::kRing * kRow * 2;       // kHist x kHistQ x 128
  float* const cmr = hist + S::kHist * kHistQ * kRow;   // kCmRows x 128
  for (int i = lane; i < (S::kHist * kHistQ + S::kCmRows) * kRow; i += 32)
    hist[i] = 0.f;
  const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * strip;
  if (row0 >= rows) return;
  const int row1 = min(rows, row0 + strip);
  const int rs = row0 - warm;                   // the first row computed
  const int rf = S::kRegs ? rs : rs - kRb - 1;  // the first row fetched
  const Strip st(head, head_stride, x, x_stride, h, nv, kRow * rf,
                 kRow * row1);
  const bool vec = st.inside && ((reinterpret_cast<uintptr_t>(st.x) -
                                  8ull * static_cast<unsigned>(h)) & 15) == 0;
  const long long plane = gridDim.y * static_cast<long long>(rows);
  out += blockIdx.y * static_cast<long long>(rows);
  const int t_sm = 2 * L + W - 2;
  const int t_pr = 2 * L - 1;
  const float rW = 1.f / static_cast<float>(W);
  const int sl = lane & (S::kLanes - 1);
  // t - L: lane lag_src; at L < 128 the lanes >= 32 - kLb send their
  // previous row, which their readers (lanes < kLb) need; past L 128 the
  // lanes < kLb read one row further back
  const int lag_src = (lane - kLb) & 31;
  const bool lag_prev = lane >= 32 - kLb;
  const bool lag_far = lane < kLb;
  // t - W: slot s of lane l lies in the group of 4 positions g2 = l - W/4
  // (s >= W % 4) or g1 = g2 - 1, kb1 / kb2 rows back; every kb is kq or
  // kq + 1
  const int wr = W & 3, kq = W >> 7;
  const int g2 = lane - (W >> 2), g1 = g2 - 1;
  const int kb1 = -(g1 >> 5), kb2 = -(g2 >> 5);

  auto slot = [&](int r) {
    return static_cast<int>(static_cast<unsigned>(r - rf) % S::kRing);
  };
  // each lane copies (and reads back) its own 4 samples of a row: 16-byte
  // asynchronous copies where the strip lies in x, plain loads elsewhere
  auto issue = [&](int r) {
    float4* dst = ring + slot(r) * (kRow / 2) + 2 * lane;
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
  auto read = [&](int r, int l, float2 (&v)[kSlots]) {
    const float4* src = ring + slot(r) * (kRow / 2) + 2 * l;
    const float4 a = src[0], b = src[1];
    v[0] = make_float2(a.x, a.y);
    v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(b.x, b.y);
    v[3] = make_float2(b.z, b.w);
  };

  for (int i = 0; i < S::kAheadRows; ++i) issue(rf + i);
  // the rows before rs only feed v[u - L] (L > 128)
  for (int r = rf; r < rs; ++r) {
    tpu_ofdm::cp_async_wait<S::kAheadRows - 1>();
    issue(r + S::kAheadRows);
  }
  // the previous row (L <= 128): samples, E, R2, P and segment sums
  float2 vp[kSlots] = {};
  float pEre[kSlots] = {}, pEim[kSlots] = {}, pEe[kSlots] = {};
  float pR2[kSlots] = {}, pPre[kSlots] = {}, pPim[kSlots] = {};
  float pre_seg = 0.f, pim_seg = 0.f, pe_seg = 0.f;
  // the totals of the last kRb rows (L > 128), newest first
  float tre[kRb > 0 ? kRb : 1] = {}, tim[kRb > 0 ? kRb : 1] = {},
        te[kRb > 0 ? kRb : 1] = {};
  float tm[S::kMBack] = {};  // the totals of M over the last kMBack rows
  int ci = 0;                // (r - rs) mod kCmRows: this row's Cm ring slot
  int hi = 0;                // (r - rs) mod kHist
  for (int r = rs; r < row1; ++r) {
    tpu_ofdm::cp_async_wait<S::kAheadRows - 1>();
    float2 v[kSlots], vl[kSlots];
    read(r, lane, v);
    issue(r + S::kAheadRows);
    // every lane's copies up to row r have landed; every read of the rings
    // of the previous row is done
    __syncwarp();
    if constexpr (S::kRegs && kLb == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) vl[s] = vp[s];
    } else if constexpr (S::kRegs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        vl[s].x = __shfl_sync(kAll, lag_prev ? vp[s].x : v[s].x, lag_src);
        vl[s].y = __shfl_sync(kAll, lag_prev ? vp[s].y : v[s].y, lag_src);
      }
    } else {
      read(r - kRb - (lag_far ? 1 : 0), lag_src, vl);
    }

    float fre[kSlots], fim[kSlots], fe[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      fre[s] = vl[s].x * v[s].x + vl[s].y * v[s].y;
      fim[s] = vl[s].x * v[s].y - vl[s].y * v[s].x;
      fe[s] = v[s].x * v[s].x + v[s].y * v[s].y;
    }
    float Cre[kSlots], Cim[kSlots], Ce[kSlots], sre, sim, se;
    float Ere[kSlots], Eim[kSlots], Ee[kSlots];
    seg_prefix<S::kLanes>(fre, Cre, sre, sl);
    seg_prefix<S::kLanes>(fim, Cim, sim, sl);
    seg_prefix<S::kLanes>(fe, Ce, se, sl);
    seg_suffix<S::kLanes>(fre, Ere, sl);
    seg_suffix<S::kLanes>(fim, Eim, sl);
    seg_suffix<S::kLanes>(fe, Ee, sl);

    // E(t - L), R2(t - L) = R1, and the whole segments between
    float bre[kSlots], bim[kSlots], be[kSlots], r1[kSlots];
    float mre = 0.f, mim = 0.f, me = 0.f;
    if constexpr (S::kRegs && kLb == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        bre[s] = pEre[s];
        bim[s] = pEim[s];
        be[s] = pEe[s];
      }
    } else if constexpr (S::kRegs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        bre[s] = __shfl_sync(kAll, lag_prev ? pEre[s] : Ere[s], lag_src);
        bim[s] = __shfl_sync(kAll, lag_prev ? pEim[s] : Eim[s], lag_src);
        be[s] = __shfl_sync(kAll, lag_prev ? pEe[s] : Ee[s], lag_src);
      }
      if constexpr (L > 2 * kChunk) {
        // L 96: at positions < 32 of a 64-segment, t - L lies two
        // segments back, past the whole previous one: the first half's
        // total (lane 15) for the second half, the previous row's second
        // half (lane 31 sends it) for the first
        const int src = lane < 16 ? 31 : 15;
        const bool last = lane == 31;
        const float ore = __shfl_sync(kAll, last ? pre_seg : sre, src);
        const float oim = __shfl_sync(kAll, last ? pim_seg : sim, src);
        const float oe = __shfl_sync(kAll, last ? pe_seg : se, src);
        if (sl < (L - 2 * kChunk) / 4) {
          mre = ore;
          mim = oim;
          me = oe;
        }
      }
    } else {
      int hs = hi - kRb - (lag_far ? 1 : 0);
      if (hs < 0) hs += S::kHist;
      const float4* hrow =
          reinterpret_cast<const float4*>(hist + hs * kHistQ * kRow) + lag_src;
      from4(hrow[kHEre * 32], bre);
      from4(hrow[kHEim * 32], bim);
      from4(hrow[kHEe * 32], be);
      from4(hrow[kHR2 * 32], r1);
      // the whole rows between t - L and t: rows r - 1 .. r - kRb + 1, and
      // r - kRb where t - L lies one row further back
#pragma unroll
      for (int j = 0; j < kRb; ++j) {
        if (j < kRb - 1 || lag_far) {
          mre += tre[j];
          mim += tim[j];
          me += te[j];
        }
      }
    }
    float Pre[kSlots], Pim[kSlots], R2[kSlots], m[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      Pre[s] = (bre[s] + mre) + Cre[s];
      Pim[s] = (bim[s] + mim) + Cim[s];
      R2[s] = (be[s] + me) + Ce[s];
    }
    if constexpr (S::kRegs && kLb == 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) r1[s] = pR2[s];
    } else if constexpr (S::kRegs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        r1[s] = __shfl_sync(kAll, lag_prev ? pR2[s] : R2[s], lag_src);
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) m[s] = metric(Pre[s], Pim[s], r1[s], R2[s]);
    float Cm[kSlots], sm_row;
    seg_prefix<32>(m, Cm, sm_row, lane);
    // the row's total as its last prefix, so that Tm - Cm(t - W) is 0
    // where t - W is the row's last position
    const float Tm = __shfl_sync(kAll, Cm[kSlots - 1], 31);
    reinterpret_cast<float4*>(cmr + ci * kRow)[lane] = as4(Cm);
    if constexpr (!S::kRegs) {
      float4* hrow = reinterpret_cast<float4*>(hist + hi * kHistQ * kRow) + lane;
      hrow[kHEre * 32] = as4(Ere);
      hrow[kHEim * 32] = as4(Eim);
      hrow[kHEe * 32] = as4(Ee);
      hrow[kHR2 * 32] = as4(R2);
      hrow[kHPre * 32] = as4(Pre);
      hrow[kHPim * 32] = as4(Pim);
    }
    __syncwarp();

    // the W-boxcar: Cm(t) + the M totals of rows r - 1 .. r - kb, less
    // Cm(t - W) kb rows back
    float box[kSlots];
    {
      int c1 = ci - kb1, c2 = ci - kb2;
      if (c1 < 0) c1 += S::kCmRows;
      if (c2 < 0) c2 += S::kCmRows;
      const float4 q1 = reinterpret_cast<const float4*>(cmr + c1 * kRow)[g1 & 31];
      const float4 q2 = reinterpret_cast<const float4*>(cmr + c2 * kRow)[g2 & 31];
      float glo = 0.f, tk = 0.f;
#pragma unroll
      for (int j = 0; j < S::kMBack; ++j) {
        if (j < kq) glo += tm[j];
        if (j == kq) tk = tm[j];
      }
      const float ghi = glo + tk;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const bool early = s < wr;
        const float cq = early ? elem(q1, s - wr + 4) : elem(q2, s - wr);
        const float g = (early ? kb1 : kb2) == kq ? glo : ghi;
        box[s] = (g - cq) + Cm[s];
      }
    }
#pragma unroll
    for (int j = S::kMBack - 1; j > 0; --j) tm[j] = tm[j - 1];
    tm[0] = Tm;

    if (r >= row0) {
      RowMax rm;
      rm.reset(kRow * r + kSlots * lane);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        rm.add(kRow * r + kSlots * lane + s, box[s], R2[s], rW, t_sm, t_pr,
               nv);
      rm.reduce();
      // P and R2 at t* - c
      const int tc = rm.arg - c;
      const bool ok = tc >= t_pr && tc < nv;
      if (lane == 0) {
        out[r] = rm.best;
        out[plane + r] = __int_as_float(rm.arg);
        out[5 * plane + r] = rm.rmax;
      }
      if constexpr (S::kRegs) {
        // c <= L <= 128: in this row or the previous one; the lane that
        // holds it writes them
        const int rel = tc - kRow * (r - 1);
        const int owner = (rel & (kRow - 1)) / kSlots;
        const int s = rel & (kSlots - 1);
        if (lane == 0 && !ok) {
          out[2 * plane + r] = 0.f;
          out[3 * plane + r] = 0.f;
          out[4 * plane + r] = 0.f;
        }
        if (ok && lane == owner) {
          const bool now = rel >= kRow;
          float a[kSlots], b[kSlots], d[kSlots];
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            a[i] = now ? Pre[i] : pPre[i];
            b[i] = now ? Pim[i] : pPim[i];
            d[i] = now ? R2[i] : pR2[i];
          }
          out[2 * plane + r] = elem(as4(a), s);
          out[3 * plane + r] = elem(as4(b), s);
          out[4 * plane + r] = elem(as4(d), s);
        }
      } else if (lane == 0) {
        // up to L/128 + 1 rows back: from the ring
        float a = 0.f, b = 0.f, d = 0.f;
        if (ok) {
          int hs = hi - (r - (tc >> 7));
          if (hs < 0) hs += S::kHist;
          const float* hp = hist + hs * kHistQ * kRow + (tc & (kRow - 1));
          a = hp[kHPre * kRow];
          b = hp[kHPim * kRow];
          d = hp[kHR2 * kRow];
        }
        out[2 * plane + r] = a;
        out[3 * plane + r] = b;
        out[4 * plane + r] = d;
      }
    }

    if constexpr (S::kRegs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        vp[s] = v[s];
        pEre[s] = Ere[s];
        pEim[s] = Eim[s];
        pEe[s] = Ee[s];
        pR2[s] = R2[s];
        pPre[s] = Pre[s];
        pPim[s] = Pim[s];
      }
      pre_seg = sre;
      pim_seg = sim;
      pe_seg = se;
    } else {
      const float nre = __shfl_sync(kAll, sre, 31);
      const float nim = __shfl_sync(kAll, sim, 31);
      const float ne = __shfl_sync(kAll, se, 31);
#pragma unroll
      for (int j = kRb - 1; j > 0; --j) {
        tre[j] = tre[j - 1];
        tim[j] = tim[j - 1];
        te[j] = te[j - 1];
      }
      tre[0] = nre;
      tim[0] = nim;
      te[0] = ne;
      hi = hi + 1 == S::kHist ? 0 : hi + 1;
    }
    ci = ci + 1 == S::kCmRows ? 0 : ci + 1;
  }
}

// Any L and W: the chunk prefixes and suffixes go to the ring too, and a
// window sums them over as many chunks as it spans.
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

    const float fre = vl.x * v.x + vl.y * v.y;
    const float fim = vl.x * v.y - vl.y * v.x;
    const float fe = v.x * v.x + v.y * v.y;
    const float cre = warp_scan(fre, lane);
    const float cim = warp_scan(fim, lane);
    const float ce = warp_scan(fe, lane);
    ring.at(kCre, 0, lane) = cre;
    ring.at(kCim, 0, lane) = cim;
    ring.at(kCe, 0, lane) = ce;
    ring.at(kSre, 0, lane) = warp_suffix(fre, lane);
    ring.at(kSim, 0, lane) = warp_suffix(fim, lane);
    ring.at(kSe, 0, lane) = warp_suffix(fe, lane);
    __syncwarp();
    const float pre = ring.window(kCre, kSre, dL, iL, cre);
    const float pim = ring.window(kCim, kSim, dL, iL, cim);
    const float r2 = ring.window(kCe, kSe, dL, iL, ce);
    ring.at(kWre, 0, lane) = pre;
    ring.at(kWim, 0, lane) = pim;
    ring.at(kWr2, 0, lane) = r2;
    __syncwarp();
    const float m = metric(pre, pim, ring.at(kWr2, dL, iL), r2);
    const float cm = warp_scan(m, lane);
    ring.at(kCm, 0, lane) = cm;
    ring.at(kSm, 0, lane) = warp_suffix(m, lane);
    __syncwarp();

    if (k >= kf) {
      rm.add(kChunk * k + lane, ring.window(kCm, kSm, dW, iW, cm), r2, rW,
             t_sm, t_pr, nv);
      if ((k & 3) == 3) rm.finish(ring, k, lane, c, t_pr, nv, rows, out);
    }
    ring.next();
  }
}

// A launch's grid, block and shared memory
struct Launch {
  int warps, strip;
  size_t smem;
};

// sc_detect_seg_kernel<Q>: shared memory a warp (S::kSmemWarp) and warps a
// block, as many (up to 4) as leave room for two blocks an SM:
//   L  64: 5 KB, 4 warps     L 128: 5.5 KB, 4     L 160: 22 KB, 4
//   L 256: 26.5 KB, 4        L 384: 31.5 KB, 3    L 512: 36.5 KB, 3
// (the sample ring 1 KB a row: 4 rows to L 128, 8 + L/128 + 2 past it;
// E, R2 and P 3 KB a row over L/128 + 2 rows past L 128; the row prefixes
// of M 0.5 KB a row over ceil(2L/128) + 1 rows)
template <int Q, typename Run>
cudaError_t seg_run(const Run& run, int W, int c) {
  using S = SegShape<Q>;
  const int warm = (2 * S::L + W - 2 + kRow - 1) / kRow;
  const int strip = std::max(kSegStripMin, kSegWarmShare * warm);
  const int warps = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>(kSegWarps, kSmemMax / (2 * S::kSmemWarp))));
  return run(sc_detect_seg_kernel<Q>,
             Launch{warps, strip, warps * S::kSmemWarp}, W, c, strip, warm);
}

// the segment kernel's instance for L = 32 Q
template <typename Run>
cudaError_t seg_dispatch(const Run& run, int Q, int W, int c) {
  switch (Q) {
    case 2: return seg_run<2>(run, W, c);
    case 3: return seg_run<3>(run, W, c);
    case 4: return seg_run<4>(run, W, c);
    case 5: return seg_run<5>(run, W, c);
    case 6: return seg_run<6>(run, W, c);
    case 7: return seg_run<7>(run, W, c);
    case 8: return seg_run<8>(run, W, c);
    case 9: return seg_run<9>(run, W, c);
    case 10: return seg_run<10>(run, W, c);
    case 11: return seg_run<11>(run, W, c);
    case 12: return seg_run<12>(run, W, c);
    case 13: return seg_run<13>(run, W, c);
    case 14: return seg_run<14>(run, W, c);
    case 15: return seg_run<15>(run, W, c);
    case 16: return seg_run<16>(run, W, c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// head: B rows of h complex64 samples, row b at head + b * head_stride
// (may be null when h == 0); x: B rows of n samples, row b at
// x + b * x_stride; out: (6, B, rows) float32 with rows = ceil((h + n) /
// 128).  h + n < 2^30.  Launches on `stream` and returns cudaGetLastError().
// The kernel follows from (L, cp) alone, before any launch: the L = 32
// kernel at L 32 / cp 16, the segment kernel at L a multiple of 32 in
// [64, 512] with cp < 2L, the any-L kernel elsewhere.
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
  const bool seg =
      L % kChunk == 0 && L >= 2 * kChunk && L <= 16 * kChunk && cp < 2 * L;
  const auto* hp = static_cast<const float2*>(head);
  const auto* xp = static_cast<const float2*>(x);
  auto* op = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, const Launch& ln, auto... args) {
    if (ln.smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(ln.smem));
      if (e != cudaSuccess) return e;
    }
    const long long strips = (rows + ln.strip - 1) / ln.strip;
    const dim3 grid(static_cast<unsigned>((strips + ln.warps - 1) / ln.warps),
                    B);
    kernel<<<grid, ln.warps * 32, ln.smem, s>>>(
        hp, static_cast<int>(h), head_stride, xp, static_cast<int>(h + n),
        x_stride, args..., static_cast<int>(rows), op);
    return cudaGetLastError();
  };
  if (l32)
    return static_cast<int>(run(
        sc_detect_l32_kernel,
        Launch{kWarpsMax, kRowsPerWarp,
               static_cast<size_t>(kWarpsMax) * kAhead * kRow * 8}));
  if (seg) return static_cast<int>(seg_dispatch(run, L / kChunk, W, c));
  // the any-L kernel's ring depth: the picks reach back 3 + ceil(c/32)
  // chunks, the windows ceil(L/32) and ceil(W/32).  Its 11 rings take 7 KB
  // a warp at fft 256 / cp 64 (D 5) and 24 KB at fft 1024 / cp 256 (D 17):
  // 8 warps a block up to fft 1024.  Past that the suffix rings cost warps
  // (fft 2048: 5, against 7 with prefixes alone), the price of sums that
  // hold only their window's terms.
  auto chunks = [](int v) { return (v + kChunk - 1) / kChunk; };
  const int D = std::max({chunks(L) + 1, chunks(W) + 1, 4 + chunks(c)});
  const size_t per_warp = static_cast<size_t>(kRings) * D * kChunk * 4;
  const int warps =
      static_cast<int>(std::min<size_t>(kWarpsMax, kSmemMax / per_warp));
  if (warps < 1) return cudaErrorInvalidValue;  // L, cp too large
  return static_cast<int>(run(sc_detect_kernel,
                              Launch{warps, kRowsPerWarp, per_warp * warps},
                              L, W, c, D));
}
