// Prefix sum along the last axis of B rows of n float32 values.
//
// Replaces the Pallas kernel `_cumsum_kernel` of tpu_ofdm/kernels/scan.py
// (through _cumsum_rows_pallas).  The TPU kernel marched one sequential grid
// down the time axis, took each tile's prefix as MXU matmuls against
// triangular ones matrices and carried a float32 running total from tile to
// tile, so its error grew with every tile.  None of that carries over:
// blocks here run in parallel and in no order.
//
// Design: three phases, all in one launch function.
//   1. tile_sums      one CTA per 4096-sample tile: the tile's sum (float64)
//   2. tile_offsets   one CTA per row: exclusive scan of its tile sums, in
//                     float64, in place
//   3. scan_tiles     one CTA per tile: the tile's own prefix (each thread 16
//                     consecutive samples, then a block scan of the thread
//                     totals), plus the tile's offset, in float64; rounded
//                     once to float32 on the way out
// Every partial sum is float64, so the error of out[t] is the one final
// rounding plus ~1e-16 * sum_{i<=t} |x_i|: it does not grow with t.
//
// Bound on this card: device memory.  The input is read twice (phases 1
// and 3) and the output written once, 12 bytes per sample; the float64
// arithmetic is ~5 operations per sample.  Loads and stores are coalesced
// through a padded shared-memory tile, so each thread's 16 consecutive
// samples are read without bank conflicts.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // samples per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// one padding word per 32: thread i reads words 16i..16i+15, and with the
// padding the 32 lanes of a warp hit 32 distinct banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Inclusive scan over the block; `ws` holds one double per warp.  Returns
// the thread's inclusive prefix and sets *total to the block's sum.
template <int kBlock>
__device__ double block_inclusive_scan(double v, double* ws, double* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kW = kBlock / 32;
  v = warp_inclusive_scan(v, lane);
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < kW ? ws[lane] : 0.0;
    w = warp_inclusive_scan(w, lane);
    if (lane < kW) ws[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  *total = ws[kW - 1];
  __syncthreads();  // ws is free again on return
  return v;
}

__global__ void __launch_bounds__(kThreads)
tile_sums_kernel(const float* __restrict__ x, long long n, long long tiles,
                 double* __restrict__ sums) {
  __shared__ double ws[kWarps];
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) * kTile;
  const float* xr = x + row * n;
  double acc = 0.0;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) acc += xr[i];
  }
  double total;
  block_inclusive_scan<kThreads>(acc, ws, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
tile_offsets_kernel(double* __restrict__ sums, long long tiles) {
  __shared__ double ws[kScanThreads / 32];
  double* s = sums + static_cast<long long>(blockIdx.x) * tiles;
  double carry = 0.0;
  for (long long c0 = 0; c0 < tiles; c0 += kScanThreads) {
    const long long i = c0 + threadIdx.x;
    const double v = i < tiles ? s[i] : 0.0;
    double total;
    const double inc = block_inclusive_scan<kScanThreads>(v, ws, &total);
    if (i < tiles) s[i] = carry + (inc - v);
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tiles_kernel(const float* __restrict__ x, long long n, long long tiles,
                  const double* __restrict__ offs, float* __restrict__ out) {
  __shared__ float tile[kTile + kTile / 32];
  __shared__ double ws[kWarps];
  const long long row = blockIdx.x / tiles;
  const long long base = (blockIdx.x % tiles) * kTile;
  const float* xr = x + row * n;
  float* outr = out + row * n;
  for (int k = 0; k < kPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const long long g = base + i;
    tile[padded(i)] = g < n ? xr[g] : 0.f;
  }
  __syncthreads();

  const int j0 = threadIdx.x * kPerThread;
  double loc[kPerThread];
  double run = 0.0;
  for (int k = 0; k < kPerThread; ++k) {
    run += tile[padded(j0 + k)];
    loc[k] = run;
  }
  double total;
  const double inc = block_inclusive_scan<kThreads>(run, ws, &total);
  const double off = offs[blockIdx.x] + (inc - run);
  for (int k = 0; k < kPerThread; ++k)
    tile[padded(j0 + k)] = static_cast<float>(off + loc[k]);
  __syncthreads();

  for (int k = 0; k < kPerThread; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const long long g = base + i;
    if (g < n) outr[g] = tile[padded(i)];
  }
}

}  // namespace

// x, out: B rows of n float32 values, contiguous; scratch: float64 scratch of
// scratch_len >= B * ceil(n / 4096) entries.  Launches on `stream` and
// returns the first CUDA error.
extern "C" int scan_launch(const void* x, long long n, long long B,
                           void* scratch, long long scratch_len, void* out,
                           void* stream) {
  if (n < 0 || B < 0) return cudaErrorInvalidValue;
  if (n == 0 || B == 0) return cudaSuccess;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = B * tiles;
  if (scratch_len < blocks || blocks > INT_MAX || B > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* sums = static_cast<double*>(scratch);
  tile_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, tiles, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_offsets_kernel<<<static_cast<unsigned>(B), kScanThreads, 0, s>>>(
      sums, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(x), n, tiles, sums,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
