// Prefix sum along the last axis of B rows of n float32 values.
//
// Replaces the Pallas kernel `_cumsum_kernel` of tpu_ofdm/kernels/scan.py
// (through _cumsum_rows_pallas).  The TPU kernel marched one sequential grid
// down the time axis, took each tile's prefix as MXU matmuls against
// triangular ones matrices and carried a float32 running total from tile to
// tile, so its error grew with every tile.  None of that carries over:
// blocks here run in parallel and in no order.
//
// Bound on this card: device memory, 8 bytes per sample (the input read
// once, the output written once); the float64 adds are ~3 per sample.  The
// first design (three launches: tile sums, a per-row scan of them, then
// each tile's scan) read the input twice, 12 bytes a sample, and lost to
// float32 torch.cumsum (PERF.md).
//
// Design: a single-pass chained scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), one kernel:
//   - a CTA takes its tile id from a global counter, not from blockIdx.
//     CTAs are not started in launch order, and a tile may only ever wait
//     on tiles that have started.  Ids run row-major over (row, tile); each
//     row's chain starts from zero at its first tile, and no look-back
//     crosses a row.
//   - the CTA loads its kTile samples once (16-byte loads where the tile is
//     whole and aligned) into a padded shared-memory tile, sums them in
//     float64 (kPerThread consecutive samples a thread, then a block scan of
//     the thread totals) and publishes the tile's aggregate.  A row's first
//     tile publishes its inclusive prefix at once and looks back at nothing.
//   - one warp then looks back over up to 32 * kLook predecessors a pass,
//     summing their aggregates up to the nearest one that has published its
//     inclusive prefix, and the tile publishes its own inclusive prefix.
//   - each thread adds the tile's exclusive prefix to its running float64
//     sum and rounds once to float32 on the way out.
// A tile's status and value are one 16-byte descriptor, written and read
// by single 16-byte accesses at L2 (.cg), so a reader sees a status and its
// value together without fences, in one round trip a pass.  That round
// trip, not the bytes, sets how far behind the newest tile the inclusive
// prefixes run: each look-back pass must cover at least the tiles started
// during one round trip, hence tiles of 8192 samples and 128 predecessors
// a pass (the first design, 4096 samples, a separate flag and value behind
// release/acquire, and 32 predecessors a pass, ran no faster than the three
// launches; PERF.md).  The descriptors and the counter are zeroed by a
// cudaMemsetAsync on the same stream before the kernel; the caller
// allocates all scratch.
//
// Every partial sum is float64, so the error of out[t] is the one final
// rounding plus ~1e-16 * sum_{i<=t} |x_i|: it does not grow with t.  Which
// predecessors a tile finds as aggregates and which as inclusive prefixes
// depends on timing, so the float64 terms are added in an order that may
// change from run to run: two runs may differ by one float32 ulp, rarely,
// always inside that bound.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;
constexpr int kTile = kThreads * kPerThread;  // samples per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kLook = 4;  // predecessors per lane per look-back pass

// descriptor status (0: nothing published yet)
constexpr long long kAggregate = 1;
constexpr long long kInclusive = 2;

struct alignas(16) Desc {
  long long status;  // 0, kAggregate or kInclusive
  double value;      // the tile's own sum, or its row's sum to its end
};

__device__ __forceinline__ void publish(Desc* d, long long status,
                                        double v) {
  asm volatile("st.global.cg.v2.u64 [%0], {%1, %2};\n" ::"l"(d),
               "l"(status), "l"(__double_as_longlong(v))
               : "memory");
}

__device__ __forceinline__ long long read_desc(const Desc* d, double* v) {
  long long status, bits;
  asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(status), "=l"(bits)
               : "l"(d)
               : "memory");
  *v = __longlong_as_double(bits);
  return status;
}

// one padding word per 32: thread i reads words kPerThread*i onward, and
// with the padding the 32 lanes of a warp hit 32 distinct banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Inclusive scan over the block; `ws` holds one double per warp.  Returns
// the thread's inclusive prefix and sets *total to the block's sum.
__device__ double block_inclusive_scan(double v, double* ws, double* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v, lane);
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kWarps ? ws[lane] : 0.0;
    w = warp_inclusive_scan(w, lane);
    if (lane < kWarps) ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  *total = ws[kWarps - 1];
  return v;
}

// By one warp: the sum of the tiles [first, tile) of one row, from their
// descriptors.  In a pass ending at `end`, lane l reads tiles end - 1 - l -
// 32 i (i < kLook), all loads in flight together; tiles before the row's
// first count as an inclusive prefix of zero, so a pass that reaches the
// row's start always ends the walk.
__device__ double look_back(const Desc* desc, long long first,
                            long long tile) {
  const int lane = threadIdx.x & 31;
  double excl = 0.0;
  for (long long end = tile;; end -= 32 * kLook) {
    long long status[kLook];
    double v[kLook];
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      status[i] = end - 1 - lane - 32 * i >= first ? 0 : kInclusive;
      v[i] = 0.0;
    }
    for (bool waiting = true; waiting;) {
      waiting = false;
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        if (status[i] == 0) {
          status[i] = read_desc(desc + end - 1 - lane - 32 * i, &v[i]);
          waiting |= status[i] == 0;
        }
      }
    }
    // the nearest inclusive prefix, by distance lane + 32 i
    int stop = 32 * kLook;
#pragma unroll
    for (int i = kLook - 1; i >= 0; --i) {
      const unsigned inc = __ballot_sync(0xffffffffu, status[i] == kInclusive);
      if (inc != 0) stop = 32 * i + __ffs(inc) - 1;
    }
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < kLook; ++i)
      if (lane + 32 * i <= stop) part += v[i];
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    excl += part;
    if (stop < 32 * kLook) return excl;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, long long n, long long tiles,
            Desc* __restrict__ desc, int* __restrict__ counter,
            float* __restrict__ out) {
  __shared__ float buf[kTile + kTile / 32];
  __shared__ double ws[kWarps];
  __shared__ int s_tile;
  __shared__ double s_excl;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long t = s_tile;
  const long long row = t / tiles;
  const long long j = t - row * tiles;  // tile within its row
  const long long base = row * n + j * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile),
                                       n - j * kTile));
  const bool vec = len == kTile && aligned16(x + base) &&
                   aligned16(out + base);
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float4 v[kPerThread / 4];
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k)
      v[k] = __ldg(x4 + k * kThreads + threadIdx.x);
    // 4q..4q+3 never cross a padding word
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      float* d = buf + padded(4 * (k * kThreads + threadIdx.x));
      d[0] = v[k].x;
      d[1] = v[k].y;
      d[2] = v[k].z;
      d[3] = v[k].w;
    }
  } else {
    for (int k = 0; k < kPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      buf[padded(i)] = i < len ? x[base + i] : 0.f;
    }
  }
  __syncthreads();

  const int j0 = threadIdx.x * kPerThread;
  double own = 0.0;
  for (int k = 0; k < kPerThread; ++k) own += buf[padded(j0 + k)];
  double total;
  const double inc = block_inclusive_scan(own, ws, &total);
  if (threadIdx.x < 32) {
    double excl = 0.0;
    if (j == 0) {
      if (threadIdx.x == 0) publish(desc + t, kInclusive, total);
    } else {
      if (threadIdx.x == 0) publish(desc + t, kAggregate, total);
      excl = look_back(desc, t - j, t);
      if (threadIdx.x == 0) publish(desc + t, kInclusive, excl + total);
    }
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();

  double run = s_excl + (inc - own);
  for (int k = 0; k < kPerThread; ++k) {
    run += buf[padded(j0 + k)];
    buf[padded(j0 + k)] = static_cast<float>(run);
  }
  __syncthreads();
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(out + base);
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int q = k * kThreads + threadIdx.x;
      const float* s = buf + padded(4 * q);
      o4[q] = make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
    for (int k = 0; k < kPerThread; ++k) {
      const int i = k * kThreads + threadIdx.x;
      if (i < len) out[base + i] = buf[padded(i)];
    }
  }
}

}  // namespace

// x, out: B rows of n float32 values, contiguous; scratch: float64 scratch of
// scratch_len >= 2 * T + 1 entries for T = B * ceil(n / 8192) tiles (a
// 16-byte descriptor per tile, then the int32 tile counter).  Zeroes the
// descriptors and the counter, then launches the kernel, both on `stream`;
// returns the first CUDA error.
extern "C" int scan_launch(const void* x, long long n, long long B,
                           void* scratch, long long scratch_len, void* out,
                           void* stream) {
  if (n < 0 || B < 0) return cudaErrorInvalidValue;
  if (n == 0 || B == 0) return cudaSuccess;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long T = B * tiles;
  if (T >= INT_MAX || B > INT_MAX || scratch_len < 2 * T + 1 ||
      !aligned16(scratch))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Desc* desc = static_cast<Desc*>(scratch);
  int* counter = reinterpret_cast<int*>(desc + T);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (2 * T + 1) * sizeof(double), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<static_cast<unsigned>(T), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, tiles, desc, counter,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
