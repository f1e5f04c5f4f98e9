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
// Bound on this card: the direct window sums.  Each position costs ~L
// multiply-adds on four streams plus W adds for the boxcar, all from shared
// memory; device-memory traffic is only the 8-byte sample read (plus a
// 2L+W-2 sample halo per CTA) and 24 bytes per 128-sample row.  Design, kept
// simple: one CTA of 256 threads owns 8 rows (1024 trailing positions) of
// one batch row (grid.y),
// loads its samples plus the halo into shared memory once, computes P, R1,
// R2 and M for every position its boxcar needs as direct float32 sums (no
// running sums, so no drift), then one warp per row reduces max, first
// argmax and the plateau-centre picks.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "virtual_buffer.cuh"

namespace {

constexpr int kRow = 128;  // candidate granularity (ops.sync.ROW)
constexpr int kRowsPerCta = 8;
constexpr int kTile = kRow * kRowsPerCta;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sc_detect_kernel(const float2* __restrict__ head, long long h,
                 long long head_stride, const float2* __restrict__ x,
                 long long nv, long long x_stride, int L, int W, int c,
                 long long rows, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int halo = 2 * L + W - 2;
  const int span = kTile + halo;  // samples this CTA reads
  const int nm = kTile + W - 1;   // positions s the boxcars need
  float2* xs = reinterpret_cast<float2*>(smem);
  float* pre = reinterpret_cast<float*>(xs + span);
  float* pim = pre + nm;
  float* r2 = pim + nm;
  float* mm = r2 + nm;

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long batch = blockIdx.y;
  const long long plane = gridDim.y * rows;  // one output summary, all rows
  if (head != nullptr) head += batch * head_stride;
  x += batch * x_stride;
  out += batch * rows;
  for (int i = threadIdx.x; i < span; i += kThreads)
    xs[i] = tpu_ofdm::virtual_load(head, h, x, nv, base - halo + i);
  __syncthreads();

  // Window sums at s = base - (W-1) + j; sample s sits at xs[j + 2L - 1].
  for (int j = threadIdx.x; j < nm; j += kThreads) {
    const float2* cur = xs + j + 2 * L - 1;
    const float2* lag = cur - L;
    float ar = 0.f, ai = 0.f, e2 = 0.f, e1 = 0.f;
    for (int q = 0; q < L; ++q) {
      const float2 a = cur[-q];
      const float2 b = lag[-q];
      ar += b.x * a.x + b.y * a.y;
      ai += b.x * a.y - b.y * a.x;
      e2 += a.x * a.x + a.y * a.y;
      e1 += b.x * b.x + b.y * b.y;
    }
    const float den = e1 * e2;
    const float p2 = ar * ar + ai * ai;
    pre[j] = ar;
    pim[j] = ai;
    r2[j] = e2;
    mm[j] = den > 0.f ? fminf(p2 / fmaxf(den, 1e-12f), 2.f) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t_sm = 2LL * L + W - 2;  // first t with a full sm window
  const long long t_pr = 2LL * L - 1;      // first t with full P/R windows
  for (int rr = warp; rr < kRowsPerCta; rr += kThreads / 32) {
    const long long row = static_cast<long long>(blockIdx.x) * kRowsPerCta + rr;
    if (row >= rows) break;  // uniform across the warp
    float best = -CUDART_INF_F;
    int arg = lane;  // an all -inf row resolves to its first position
    float rmax = 0.f;
    for (int i = lane; i < kRow; i += 32) {
      const long long t = row * kRow + i;
      const int jt = static_cast<int>(t - base) + W - 1;
      if (t >= t_sm && t < nv) {
        float acc = 0.f;
        for (int q = 0; q < W; ++q) acc += mm[jt - q];
        const float sm = acc / static_cast<float>(W) +
                         static_cast<float>(t & 0xFFFF) * 1e-7f;
        if (sm > best) {  // strict: the first maximum wins
          best = sm;
          arg = i;
        }
      }
      if (t >= t_pr && t < nv) rmax = fmaxf(rmax, r2[jt]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oa = __shfl_down_sync(0xffffffffu, arg, off);
      const float orm = __shfl_down_sync(0xffffffffu, rmax, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
      rmax = fmaxf(rmax, orm);
    }
    if (lane == 0) {
      const long long ts = row * kRow + arg;
      const long long tc = ts - c;
      const int jc = static_cast<int>(tc - base) + W - 1;  // >= 0: c <= W-1
      const bool ok = tc >= t_pr && tc < nv;
      out[row] = best;
      out[plane + row] = __int_as_float(static_cast<int>(ts));
      out[2 * plane + row] = ok ? pre[jc] : 0.f;
      out[3 * plane + row] = ok ? pim[jc] : 0.f;
      out[4 * plane + row] = ok ? r2[jc] : 0.f;
      out[5 * plane + row] = rmax;
    }
  }
}

}  // namespace

// head: B rows of h complex64 samples, row b at head + b * head_stride
// (may be null when h == 0); x: B rows of n samples, row b at
// x + b * x_stride; out: (6, B, rows) float32 with rows = ceil((h + n) /
// 128).  Launches on `stream` and returns cudaGetLastError().
extern "C" int sc_detect_launch(const void* head, long long h,
                                long long head_stride, const void* x,
                                long long n, long long x_stride, int B, int L,
                                int cp, void* out, long long rows,
                                void* stream) {
  if (L < 1 || cp < 0 || h < 0 || n < 0 || B < 0 || B > 65535)
    return cudaErrorInvalidValue;
  if (rows == 0 || B == 0) return cudaSuccess;
  const int W = cp + 1;
  const int c = cp - cp / 2;
  const size_t smem = (kTile + 2 * L + W - 2) * sizeof(float2) +
                      4 * (kTile + W - 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sc_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (rows + kRowsPerCta - 1) / kRowsPerCta;
  sc_detect_kernel<<<dim3(static_cast<unsigned>(grid), B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(head), h, head_stride,
      static_cast<const float2*>(x), h + n, x_stride, L, W, c, rows,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
