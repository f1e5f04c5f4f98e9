"""csrc/sc_detect.cu itself, run on the CPU: the CUDA source compiled with
g++ against a small emulation of the CUDA surface it uses (a warp's 32
lanes take turns at every shuffle and __syncwarp, cp.async is a plain
copy), and held against the plain version at chip_smoke.py's bars, for
each of its three kernels and the specs that reach their branches.  The
emulation runs a warp's lanes as coroutines of one thread, in lockstep at
every shuffle, so it checks the kernels' index arithmetic, rings and
dispatch, not the card's memory ordering or speed; chip_smoke.py phase 3
runs the same checks on the card."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.kernels import build as kbuild
from tpu_ofdm_torch.kernels import sc_detect as tk
from tpu_ofdm_torch.ops import sync as tsync

# the CUDA runtime, math constants and cp.async as the kernels use them
CUDA_RUNTIME_H = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef void* cudaStream_t;
template <typename T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float __fdividef(float a, float b) { return a / b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// A warp's 32 lanes as coroutines of one thread, switched round robin at
// every shuffle and __syncwarp: lane i passes to lane i + 1, lane 31 back
// to lane 0, which then finds every lane arrived.
namespace emu {
struct Index { unsigned x, y, z; };
struct Lane {
  ucontext_t ctx;
  Index tid;
  int phase;
};
inline Lane lanes[32];
inline int lane = 0;
inline ucontext_t home;
inline uint64_t vals[2][32];
inline Index block;
inline dim3 grid_dim, block_dim;
inline std::vector<float> shared;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;

inline void pass() {
  const int me = lane;
  lane = (me + 1) & 31;
  swapcontext(&lanes[me].ctx, &lanes[lane].ctx);
  lane = me;
}

inline void entry() {
  body(body_arg);
  const int me = lane;
  if (me == 31) {
    setcontext(&home);
  } else {
    lane = me + 1;
    setcontext(&lanes[me + 1].ctx);
  }
}

template <typename T>
T exchange(T v, int src) {
  const int p = lanes[lane].phase;
  lanes[lane].phase ^= 1;
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  vals[p][lane] = u;
  pass();
  const uint64_t got = vals[p][src];
  T out;
  std::memcpy(&out, &got, sizeof(T));
  return out;
}

template <typename F>
void trampoline(void* f) { (*static_cast<F*>(f))(); }

// blocks one after another, a block's warps one after another (the
// kernels share nothing between warps); shared memory starts as NaN, so
// that a read before a write shows
template <typename K, typename... A>
void launch(dim3 grid, int threads, size_t smem, cudaStream_t, K kernel,
            A... args) {
  grid_dim = grid;
  block_dim = dim3(threads);
  static std::vector<char> stacks(32 << 16);
  auto run = [&] { kernel(args...); };
  body = &trampoline<decltype(run)>;
  body_arg = &run;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      shared.assign(smem / 4 + 1, std::nanf(""));
      block = {bx, by, 0};
      for (int w = 0; w < threads / 32; ++w) {
        for (int l = 0; l < 32; ++l) {
          getcontext(&lanes[l].ctx);
          lanes[l].ctx.uc_stack.ss_sp = stacks.data() + (l << 16);
          lanes[l].ctx.uc_stack.ss_size = 1 << 16;
          lanes[l].ctx.uc_link = nullptr;
          makecontext(&lanes[l].ctx, entry, 0);
          lanes[l].tid = {unsigned(w * 32 + l), 0, 0};
          lanes[l].phase = 0;
        }
        lane = 0;
        swapcontext(&home, &lanes[0].ctx);
      }
    }
}
}  // namespace emu

#define threadIdx (emu::lanes[emu::lane].tid)
#define blockIdx (emu::block)
#define blockDim (emu::block_dim)
#define gridDim (emu::grid_dim)

template <typename T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int l = emu::lane;
  return emu::exchange(v, l / width * width + (src % width + width) % width);
}
template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const int l = emu::lane;
  return emu::exchange(v, l % width >= int(d) ? l - int(d) : l);
}
template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned d, int width = 32) {
  const int l = emu::lane;
  return emu::exchange(v, l % width + int(d) < width ? l + int(d) : l);
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int m, int width = 32) {
  const int l = emu::lane;
  const int s = l ^ m;
  return emu::exchange(v, s / width == l / width ? s : l);
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu::pass(); }
"""
MATH_CONSTANTS_H = "#pragma once\n#include <cmath>\n#define CUDART_INF_F INFINITY\n"
CP_ASYNC_CUH = r"""
#pragma once
#include <cstring>
namespace tpu_ofdm {
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async_commit() {}
template <int kPending> inline void cp_async_wait() {}
}  // namespace tpu_ofdm
"""
DRIVER_CC = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
extern "C" int sc_detect_launch(const void*, long long, long long,
                                const void*, long long, long long, int, int,
                                int, void*, long long, void*);
// IN OUT B h n L cp: IN holds B rows of h head samples, then B rows of n
int main(int argc, char** argv) {
  const int B = atoi(argv[3]), L = atoi(argv[6]), cp = atoi(argv[7]);
  const long long h = atoll(argv[4]), n = atoll(argv[5]);
  const long long rows = (h + n + 127) / 128;
  std::vector<float> head(2 * B * h + 2), x(2 * B * n), out(6 * B * rows);
  FILE* f = fopen(argv[1], "rb");
  if (fread(head.data(), 8, B * h, f) != size_t(B * h) ||
      fread(x.data(), 8, B * n, f) != size_t(B * n))
    return 2;
  fclose(f);
  const int rc = sc_detect_launch(h ? head.data() : nullptr, h, h, x.data(),
                                  n, n, B, L, cp, out.data(), rows, nullptr);
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return rc;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated csrc/sc_detect.cu as an executable."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("sc_detect_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "math_constants.h").write_text(MATH_CONSTANTS_H)
    (d / "cp_async.cuh").write_text(CP_ASYNC_CUH)
    src = (kbuild.CSRC / "sc_detect.cu").read_text()
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = emu::shared.data();")
    src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu::launch(\2, \1, ", src,
                 flags=re.S)
    (d / "sc_detect.cc").write_text(src)
    (d / "driver.cc").write_text(DRIVER_CC)
    exe = d / "sc_detect"
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(d),
                    "-o", str(exe), str(d / "sc_detect.cc"),
                    str(d / "driver.cc")], check=True, capture_output=True,
                   timeout=300)
    return exe


def _run(exe, x, head, L, cp):
    """The emulated sc_detect_rows on [head | x] (complex64, (n,) or
    (B, n))."""
    B = x.shape[0] if x.ndim == 2 else 1
    h = 0 if head is None else head.shape[-1]
    path = exe.parent / "io"
    with open(f"{path}.in", "wb") as f:
        if h:
            f.write(head.numpy().tobytes())
        f.write(x.numpy().tobytes())
    subprocess.run([str(exe), f"{path}.in", f"{path}.out", str(B), str(h),
                    str(x.shape[-1]), str(L), str(cp)], check=True,
                   timeout=300)
    rows = -(-(h + x.shape[-1]) // tk.ROW)
    o = torch.from_numpy(np.fromfile(f"{path}.out", np.float32))
    o = o.reshape(6, *x.shape[:-1], rows)
    return (o[0], o[1].view(torch.int32), o[2], o[3], o[4], o[5])


# (fft_len, cp, h, n, B): every kernel and the branches of the segment one
CASES = [
    (64, 16, 3072, 16384, 1),    # the L = 32 kernel
    (96, 24, 0, 16384, 1),       # the any-L kernel (L 48)
    (128, 32, 4096, 16384, 1),   # L 64: a lag of 16 lanes into the last row
    (192, 48, 1001, 16384, 1),   # L 96: one half row between; x unaligned
    (256, 64, 4096, 20000, 1),   # L 128: the last row's registers
    (256, 0, 0, 16384, 1),       # W 1, c 0 (noise alone)
    (256, 64, 1024, 8192, 3),    # a batch
    (320, 80, 5, 20000, 1),      # L 160: shared memory, a lag of 8 lanes
    (512, 128, 4096, 24000, 1),  # L 256: rows between, picks from the ring
    (1024, 256, 0, 32768, 1),    # L 512
    (256, 64, 50, 400, 1),       # shorter than a strip's warm-up
]


@pytest.mark.parametrize("fft_len,cp,h,n,B", CASES)
def test_emulated_kernel_matches_plain(emulated, fft_len, cp, h, n, B):
    """Rows at compare_rows' bars (argmax identical on >= 99% of rows, the
    rest at rtol 1e-4 / atol 1e-5 where it agrees, -inf where the plain
    version has it); where frames lie in the buffer, the selection finds
    each of them, as on the plain rows (a start may sit on a float32 tie
    at fft 1024, as in chip_smoke.check_selection)."""
    L = fft_len // 2
    rng = np.random.RandomState(fft_len + cp + h)
    v = ((rng.randn(B, h + n) + 1j * rng.randn(B, h + n)) * 0.02).astype(
        np.complex64)
    gp = G.GoldenOfdmParams(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40))).astype(np.complex64)
    # no frames at cp 0: a frame's peak there is flat to float32's last
    # bit, and every other row ties it on a 16384-sample buffer
    starts = [] if cp == 0 else list(range(300 + h, h + n - 2 * len(frame),
                                           2 * len(frame)))
    for b in range(B):
        for p in starts:
            v[b, p + b:p + b + len(frame)] += frame
    v = torch.from_numpy(v if B > 1 else v[0])
    x = v[..., h:].contiguous()
    head = v[..., :h].contiguous() if h else None
    got = _run(emulated, x, head, L, cp)
    ref = tk.sc_detect_rows_plain(x, L, cp, head=head)
    same = got[1] == ref[1]
    assert same.float().mean() >= 0.99
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))
    live = torch.isfinite(ref[0]) & same
    for i in (0, 2, 3, 4, 5):
        m = live if i < 5 else torch.ones_like(live)
        torch.testing.assert_close(got[i][m], ref[i][m], rtol=1e-4,
                                   atol=1e-5)
    if not starts or cp == 0 or B > 1:
        return
    spec = tconfig.OfdmConfig(fft_len=fft_len, cp_len=cp,
                              modulation="qpsk").spec
    n_sm = h + n - fft_len - cp + 1
    sel = [tsync._select_from_rows(spec, *r, n_sm=n_sm,
                                   max_frames=len(starts) + 8,
                                   threshold=spec.cfg.sync_threshold)
           for r in (got, ref)]
    assert torch.equal(sel[0].valid, sel[1].valid)
    ok = sel[1].valid
    assert int(ok.sum()) == len(starts)
    moved = sel[0].start[ok] != sel[1].start[ok]
    assert ((sel[0].start[ok] - sel[1].start[ok]).abs() <= 2).all()
    a, b = sel[0][3][ok][moved], sel[1][3][ok][moved]
    assert ((a - b).abs() <= 2 * torch.finfo(torch.float32).eps
            * b.abs()).all()
