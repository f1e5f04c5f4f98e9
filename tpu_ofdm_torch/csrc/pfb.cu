// Polyphase filterbank channelizer: commutator, J-tap FIR per arm and the
// cross-arm N-point DFT in one pass over the wideband stream.
//
// Replaces both Pallas kernels of tpu_ofdm/kernels/pfb.py: `_kernel`
// (through _pfb_pallas, N <= 128, lane-folded) and `_kernel_wide` (through
// _pfb_pallas_wide, N a multiple of 128 up to 512, one commutator load per
// row).  The narrow/wide split was a TPU lane-layout artifact; here both
// are one kernel, instantiated per channel count.  The bf16 hi/lo split of
// the DFT operands was a TPU matmul-precision workaround and is not carried
// over: everything is float32.
//
// Semantics (spectrum.channelizer.channelize_ext): over the virtual buffer
// [head | x] (head = the stream's raw-sample tail carry), output row m of
// x, channel k:
//   out[m, k] = sum_a z[m, a] exp(+2 pi i a k / N)
//   z[m, a]   = sum_j poly[j, a] * v[h + (m - j) N + (N - 1 - a)]
// i.e. arm a consumes the reference's reversed commutator order, and the
// unnormalized inverse DFT equals channelize_ext's ifft(acc) * N.  Virtual
// positions before the buffer read as zero (stream start).
//
// Bound on this card: device memory, 16 bytes per sample (8 in, 8 out);
// the FIR and the FFT cost ~2J + 5 log2(N) flops per sample, far under the
// float32 peak.  Design:
//   - N is a template parameter (every N <= 128 dividing 128, and 256, 384
//     and 512), so all index arithmetic is constant;
//   - one CTA of 256 threads owns R = 8192 / N output rows; its input is
//     one contiguous span of (R + J - 1) N samples, staged in shared memory
//     once with 16-byte loads (the J - 1 lookback rows are 5% at N 64), and
//     poly (J, N) and the twiddles W_N^(l k) beside it;
//   - a frame is one warp (N >= 32: lane l holds the P = N/32 arms
//     l, l + 32, .., l + 32 (P-1), so each shared-memory load of a warp
//     reads 32 consecutive samples, free of bank conflicts) or 32/N frames
//     share a warp (N < 32, one arm per lane).  Each lane forms its arms'
//     FIR sums in registers, then the N-point DFT runs in registers: a
//     P-point DFT inside the lane (compile-time roots), the twiddle
//     W_N^(l k), log2(min(N, 32)) radix-2 decimation-in-frequency stages
//     across the lanes with __shfl_xor_sync butterflies, and one shuffle
//     that undoes the bit reversal.  No block barrier after staging;
//   - row form (out (rows, N), `pfb_launch`): lane l then holds bins
//     P l .. P l + P - 1 of its frame, in natural order, and writes them as
//     one contiguous run of 16-byte stores;
//   - channel-major form (out (N, rows), `pfb_chan_launch`, the layout the
//     wideband receiver batches its demods over): a direct store would put
//     each frame's N bins on N cache lines, 8 bytes apiece.  Instead the
//     CTA (R = 4096 / N rows up to N 128, half the row form's, so that the
//     stage fits beside the input span with three CTAs an SM) stages its
//     R x N tile channel by channel in shared memory (row stride R rounded
//     up to 16; each frame's column XOR-swizzled by its lane so that a
//     half-warp's 8-byte stores land on 16 distinct bank pairs; the
//     bit-reversal shuffle is not needed), and after one barrier writes
//     each channel's R samples as one contiguous run of 16-byte stores.
//     The FIR, the DFT and the summation order are the row form's, so the
//     output is the row form's transposed, bit for bit.  A template
//     parameter selects the form; neither pays a runtime branch.
// Twiddles are exp(2 pi i e / n) from the integer exponent e reduced mod n
// before it becomes a float (cf. tpu_ofdm/kernels/pfb.py:84, :191).
// Error bound of the summation order: each arm is a float32 sum of J
// products in tap order, then each bin a P-term sum and log2(N/P)
// butterfly levels; within ~(J + P + log2 N) eps of sum_a sum_j |poly x|.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "virtual_buffer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileSamples = 8192;  // a CTA's output samples, row form
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;

// floats of the taps in shared memory, rounded up to 16 bytes
__host__ __device__ constexpr int tap_floats(int J, int N) {
  return (J * N + 3) & ~3;
}

// The channel-major form's tile and CTAs an SM (measured at N 64 on 2^25
// samples and N 512 on 2^23, H100): up to N 128, 4096 output samples a CTA
// (72 KB of shared memory at N 64) and registers held to 80 so that three
// CTAs share an SM (N 64: 0.259 ms; two CTAs 0.289, 2048 samples 0.341,
// 8192 0.401); above, the row form's tile and bounds, as one CTA an SM is
// all that fits either way and three would spill (N 512: 0.126 ms; 4096
// samples 0.134, three CTAs 0.167).
template <int N>
constexpr int chan_tile_samples() { return N <= 128 ? 4096 : kTileSamples; }
template <int N, bool kChan>
constexpr int min_ctas() { return kChan && N <= 128 ? 3 : 2; }

// float4 offset of the channel-major stage in shared memory: 16-byte aligned
// after the span (float2), the taps and the twiddles (N float2)
__host__ __device__ constexpr int stage_offset(int span, int J, int N) {
  return (2 * span + tap_floats(J, N) + 2 * N + 3) / 4;
}

// float2 row stride of the channel-major stage of R rows: room for every
// swizzled column (below 16 past a multiple of 16), each row 16-byte aligned
// and starting on bank 0
__host__ __device__ constexpr int stage_stride(int R) {
  return (R + 15) & ~15;
}

// XOR mask of the stage column of bin lane kl, below 16: the lanes of a
// half-warp (one frame's bin lanes for NL >= 16, which hold kl = bitrev(lp):
// the even kl, then the odd, at NL 32; 16 / NL frames of NL lanes below)
// store to 16 distinct 8-byte bank pairs
template <int NL>
__host__ __device__ constexpr int stage_swizzle(int kl) {
  return NL >= 32 ? (kl >> 1) & 15 : (kl * (16 / NL)) & 15;
}

// cos(2 pi a / 48) for a multiple of 3 or 4: the roots of unity of the
// P-point DFTs inside a lane (P = 1, 2, 4, 8, 16 or 12), as compile-time
// constants
__host__ __device__ constexpr float cos48(int a) {
  a %= 48;
  if (a > 24) a = 48 - a;
  const float sign = a > 12 ? -1.f : 1.f;
  if (a > 12) a = 24 - a;
  const float v = a == 0   ? 1.f
                  : a == 3 ? 0.92387953251128674f
                  : a == 4 ? 0.86602540378443865f
                  : a == 6 ? 0.70710678118654752f
                  : a == 8 ? 0.5f
                  : a == 9 ? 0.38268343236508977f
                           : 0.f;  // a == 12
  return sign * v;
}

// exp(+2 pi i m / P), m >= 0
template <int P>
__device__ __forceinline__ float2 unit_root(int m) {
  const int a = (m % P) * (48 / P);
  return make_float2(cos48(a), cos48(a + 36));  // sin x = cos(x - pi/2)
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(+2 pi i e / n) for an integer exponent 0 <= e < n
__device__ __forceinline__ float2 root(int e, int n) {
  float s, c;
  sincospif(2.f * static_cast<float>(e) / static_cast<float>(n), &s, &c);
  return make_float2(c, s);
}

template <int N, bool kChan>
__global__ void __launch_bounds__(kThreads, (min_ctas<N, kChan>()))
pfb_kernel(const float2* __restrict__ head, long long h,
           const float2* __restrict__ x, long long nv,
           const float* __restrict__ poly, int J, int R, long long rows,
           float2* __restrict__ out) {
  constexpr int NL = N < 32 ? N : 32;  // lanes per frame
  constexpr int P = N / NL;            // arms (and bins) per lane
  constexpr int FPW = 32 / NL;         // frames per warp pass
  constexpr int LOG_NL = NL >= 32 ? 5 : NL >= 16 ? 4 : NL >= 8 ? 3
                         : NL >= 4 ? 2 : NL >= 2 ? 1 : 0;
  extern __shared__ float4 smem[];
  const int span = (R + J - 1) * N;
  float2* xs = reinterpret_cast<float2*>(smem);
  // span is even for every N > 2, so the taps start 16-byte aligned
  float* ps = reinterpret_cast<float*>(xs + span);
  // W_N^(lp kp) for every (kp, lp), 16-byte aligned after the taps
  float2* tws = reinterpret_cast<float2*>(ps + tap_floats(J, N));
  // channel-major form: the (N, RS) stage
  float2* stage = reinterpret_cast<float2*>(smem + stage_offset(span, J, N));
  const int RS = stage_stride(R);

  // stage [v0, v0 + span): asynchronous 16-byte copies, all in flight
  // together, when the span lies inside x
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const long long v0 = h + (r0 - (J - 1)) * N;  // virtual position of xs[0]
  bool fast = v0 >= h && v0 + span <= nv;
  if (fast)
    fast = (reinterpret_cast<uintptr_t>(x + (v0 - h)) & 15) == 0;
  if (fast) {
    const float2* src = x + (v0 - h);
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < span / 2; i += kThreads)
      tpu_ofdm::cp_async16(smem + i, src4 + i);
    if ((span & 1) && threadIdx.x == 0) xs[span - 1] = src[span - 1];
    tpu_ofdm::cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < span; i += kThreads)
      xs[i] = tpu_ofdm::virtual_load(head, h, x, nv, v0 + i);
  }
  for (int i = threadIdx.x; i < J * N; i += kThreads) ps[i] = __ldg(poly + i);
  for (int i = threadIdx.x; i < N; i += kThreads)
    tws[i] = root(((i % NL) * (i / NL)) % N, N);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lp = lane & (NL - 1);  // lane within its frame
  const int fw = lane / NL;        // frame within the warp pass
  float2 wst[LOG_NL > 0 ? LOG_NL : 1];  // butterfly twiddle per stage
#pragma unroll
  for (int s = 0; s < LOG_NL; ++s) {
    const int half = NL >> (s + 1);
    wst[s] = root(lp & (half - 1), 2 * half);
  }
  const int src_rev =
      (lane & ~(NL - 1)) |
      (LOG_NL == 0 ? 0 : static_cast<int>(__brev(lp) >> (32 - LOG_NL)));

  const int passes = (R + FPW - 1) / FPW;
  for (int g = warp; g < passes; g += kWarps) {
    const int f = g * FPW + fw;  // frame (output row) within the tile
    // the FIR of arms a = lp + NL p; arm a reads span row f + J-1-j at
    // N-1-a, so a warp's loads of one (j, p) are 32 consecutive samples
    float2 z[P];
#pragma unroll
    for (int p = 0; p < P; ++p) z[p] = make_float2(0.f, 0.f);
    if (f < R) {
      for (int j = 0; j < J; ++j) {
        const float2* row = xs + (f + J - 1 - j) * N + (N - 1 - lp);
        const float* tap = ps + j * N + lp;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float q = tap[NL * p];
          const float2 s = row[-NL * p];
          z[p].x += q * s.x;
          z[p].y += q * s.y;
        }
      }
    }
    // the P-point DFT inside the lane, then the twiddle W_N^(lp kp)
    float2 y[P];
#pragma unroll
    for (int kp = 0; kp < P; ++kp) {
      float2 acc = z[0];
#pragma unroll
      for (int p = 1; p < P; ++p) {
        const float2 t = cmul(z[p], unit_root<P>(p * kp));
        acc.x += t.x;
        acc.y += t.y;
      }
      y[kp] = P > 1 ? cmul(acc, tws[kp * NL + lp]) : acc;
    }
    // the NL-point DFT across the frame's lanes, radix-2 DIF: lane lp ends
    // up holding bin bitrev(lp) of each of its P transforms
#pragma unroll
    for (int s = 0; s < LOG_NL; ++s) {
      const int half = NL >> (s + 1);
      const bool upper = (lp & half) != 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float bx = __shfl_xor_sync(kAll, y[p].x, half);
        const float by = __shfl_xor_sync(kAll, y[p].y, half);
        y[p] = upper ? cmul(make_float2(bx - y[p].x, by - y[p].y), wst[s])
                     : make_float2(y[p].x + bx, y[p].y + by);
      }
    }
    if constexpr (kChan) {
      // bin kp + P kl of each transform, kl = bitrev(lp), into stage row
      // kp + P kl at the frame's swizzled column
      const int kl = src_rev & (NL - 1);
      if (f < R) {
        float2* col = stage + (f ^ stage_swizzle<NL>(kl));
#pragma unroll
        for (int p = 0; p < P; ++p) col[(p + P * kl) * RS] = y[p];
      }
    } else {
      // natural order: lane lp holds bins P lp .. P lp + P - 1, one
      // contiguous run, stored 16 bytes at a time
#pragma unroll
      for (int p = 0; p < P; ++p) {
        y[p].x = __shfl_sync(kAll, y[p].x, src_rev);
        y[p].y = __shfl_sync(kAll, y[p].y, src_rev);
      }
      const long long row = r0 + f;
      if (f < R && row < rows) {
        float2* dst = out + row * N + P * lp;
        if constexpr (P % 2 == 0) {
#pragma unroll
          for (int p = 0; p < P; p += 2)
            reinterpret_cast<float4*>(dst)[p / 2] =
                make_float4(y[p].x, y[p].y, y[p + 1].x, y[p + 1].y);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) dst[p] = y[p];
        }
      }
    }
  }

  if constexpr (kChan) {
    // each channel's samples of the tile, out[k, r0 ..], two a thread: a
    // warp writes 32 x 16 contiguous bytes of one channel (R >= 64), or
    // whole runs of several channels
    __syncthreads();
    const long long left = rows - r0;
    const int valid = left < R ? static_cast<int>(left) : R;
    const int pairs = (R + 1) >> 1;
    for (int i = threadIdx.x; i < N * pairs; i += kThreads) {
      const int k = i / pairs;
      const int t = 2 * (i - k * pairs);  // time within the tile
      const int s = stage_swizzle<NL>(k / P);
      const float4 v =
          reinterpret_cast<const float4*>(stage + k * RS)[(t ^ s) >> 1];
      const float2 a = s & 1 ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
      const float2 b = s & 1 ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
      float2* dst = out + k * rows + r0 + t;
      if (t + 1 < valid && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
      } else {
        if (t < valid) dst[0] = a;
        if (t + 1 < valid) dst[1] = b;
      }
    }
  }
}

template <int N, bool kChan>
int launch(const float2* head, long long h, const float2* x, long long n,
           const float* poly, int J, float2* out, cudaStream_t stream) {
  const long long rows = n / N;
  if (rows == 0) return cudaSuccess;
  auto smem_of = [&](int r) {
    const int span = (r + J - 1) * N;
    if (kChan)
      return static_cast<size_t>(stage_offset(span, J, N)) * sizeof(float4) +
             static_cast<size_t>(N) * stage_stride(r) * sizeof(float2);
    return static_cast<size_t>(span) * sizeof(float2) +
           static_cast<size_t>(tap_floats(J, N)) * sizeof(float) +
           static_cast<size_t>(N) * sizeof(float2);
  };
  constexpr int tile = kChan ? chan_tile_samples<N>() : kTileSamples;
  int R = N >= tile ? 1 : tile / N;
  while (R > 1 && smem_of(R) > kMaxSmem) R /= 2;
  const size_t smem = smem_of(R);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // J * N too large
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pfb_kernel<N, kChan>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (rows + R - 1) / R;
  pfb_kernel<N, kChan>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      head, h, x, h + n, poly, J, R, rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kChan>
int dispatch(const void* head, long long h, const void* x, long long n,
             const void* poly, int J, int N, void* out, void* stream) {
  if (J < 1 || h < 0 || n < 0 || N < 1 || n % N != 0)
    return cudaErrorInvalidValue;
  const auto* hp = static_cast<const float2*>(head);
  const auto* xp = static_cast<const float2*>(x);
  const auto* pp = static_cast<const float*>(poly);
  auto* op = static_cast<float2*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return launch<1, kChan>(hp, h, xp, n, pp, J, op, s);
    case 2: return launch<2, kChan>(hp, h, xp, n, pp, J, op, s);
    case 4: return launch<4, kChan>(hp, h, xp, n, pp, J, op, s);
    case 8: return launch<8, kChan>(hp, h, xp, n, pp, J, op, s);
    case 16: return launch<16, kChan>(hp, h, xp, n, pp, J, op, s);
    case 32: return launch<32, kChan>(hp, h, xp, n, pp, J, op, s);
    case 64: return launch<64, kChan>(hp, h, xp, n, pp, J, op, s);
    case 128: return launch<128, kChan>(hp, h, xp, n, pp, J, op, s);
    case 256: return launch<256, kChan>(hp, h, xp, n, pp, J, op, s);
    case 384: return launch<384, kChan>(hp, h, xp, n, pp, J, op, s);
    case 512: return launch<512, kChan>(hp, h, xp, n, pp, J, op, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// head: h complex64 samples immediately preceding x (may be null when
// h == 0); x: n complex64 samples, n % N == 0; poly: (J, N) float32;
// out: (n / N, N) complex64.  N: every N <= 128 dividing 128, and 256, 384
// and 512.  Launches on `stream` and returns cudaGetLastError().
extern "C" int pfb_launch(const void* head, long long h, const void* x,
                          long long n, const void* poly, int J, int N,
                          void* out, void* stream) {
  return dispatch<false>(head, h, x, n, poly, J, N, out, stream);
}

// pfb_launch's channel-major form: the same arguments, out (N, n / N)
// complex64, pfb_launch's output transposed.
extern "C" int pfb_chan_launch(const void* head, long long h, const void* x,
                               long long n, const void* poly, int J, int N,
                               void* out, void* stream) {
  return dispatch<true>(head, h, x, n, poly, J, N, out, stream);
}
