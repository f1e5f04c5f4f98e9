"""A small emulation of the CUDA surface the port's kernels use, so that a
source of tpu_ofdm_torch/csrc/ compiles with g++ and runs on the CPU.

A block's threads are coroutines of one host thread.  A warp's 32 lanes
take turns at every shuffle and __syncwarp (lane i passes to lane i + 1,
lane 31 back to lane 0, which then finds every lane arrived); at
__syncthreads lane 31 of warp w passes to warp w + 1 and the last warp back
to warp 0, so every warp has reached the barrier before any goes on.
Blocks run one after another; cp.async is a plain copy; shared memory
starts as NaN, so that a read before a write shows.  It checks a kernel's
index arithmetic, rings, barriers and dispatch, not the card's memory
ordering, rounding or speed.

`build(d, source, driver)` writes the headers into the directory d, puts
the source beside them with its `extern __shared__` array and `<<<...>>>`
launches rewritten, and compiles it with a driver of the caller's."""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

from tpu_ofdm_torch.kernels import build as kbuild

# the CUDA runtime, math constants and intrinsics as the kernels use them
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
#define __host__
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
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
}
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline void sincospif(float x, float* s, float* c) {
  const double a = M_PI * static_cast<double>(x);
  *s = static_cast<float>(std::sin(a));
  *c = static_cast<float>(std::cos(a));
}

namespace emu {
struct Index { unsigned x, y, z; };
struct Lane {
  ucontext_t ctx;
  Index tid;
  int phase;
};
inline std::vector<Lane> lanes;  // the block's threads
inline int lane = 0;             // the running thread's index in its block
inline int threads = 0;
inline ucontext_t home;
inline std::vector<uint64_t> vals[2];
inline Index block;
inline dim3 grid_dim, block_dim;
inline std::vector<float> shared;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;

inline void switch_to(int next) {
  const int me = lane;
  lane = next;
  swapcontext(&lanes[me].ctx, &lanes[next].ctx);
  lane = me;
}

// the next lane of the running warp
inline void pass() { switch_to((lane & ~31) | ((lane + 1) & 31)); }

// the next lane of the warp; from lane 31 the next warp, from the last
// warp's lane 31 warp 0
inline void barrier() {
  switch_to((lane & 31) != 31 ? lane + 1 : (lane + 1) % threads);
}

inline void entry() {
  body(body_arg);
  const int me = lane;
  if (me == threads - 1) setcontext(&home);
  lane = me + 1;
  setcontext(&lanes[me + 1].ctx);
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

template <typename K, typename... A>
void launch(dim3 grid, int nthreads, size_t smem, cudaStream_t, K kernel,
            A... args) {
  grid_dim = grid;
  block_dim = dim3(nthreads);
  threads = nthreads;
  lanes.resize(nthreads);
  vals[0].assign(nthreads, 0);
  vals[1].assign(nthreads, 0);
  static std::vector<char> stacks;
  stacks.resize(static_cast<size_t>(nthreads) << 16);
  auto run = [&] { kernel(args...); };
  body = &trampoline<decltype(run)>;
  body_arg = &run;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      shared.assign(smem / 4 + 4, std::nanf(""));
      block = {bx, by, 0};
      for (int t = 0; t < nthreads; ++t) {
        getcontext(&lanes[t].ctx);
        lanes[t].ctx.uc_stack.ss_sp = stacks.data() + (size_t(t) << 16);
        lanes[t].ctx.uc_stack.ss_size = 1 << 16;
        lanes[t].ctx.uc_link = nullptr;
        makecontext(&lanes[t].ctx, entry, 0);
        lanes[t].tid = {unsigned(t), 0, 0};
        lanes[t].phase = 0;
      }
      lane = 0;
      swapcontext(&home, &lanes[0].ctx);
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
inline void __syncthreads() { emu::barrier(); }
"""
MATH_CONSTANTS_H = "#pragma once\n#include <cmath>\n#define CUDART_INF_F INFINITY\n"
CP_ASYNC_CUH = r"""
#pragma once
#include <cstring>
namespace tpu_ofdm {
inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async8(void* dst, const void* src) { std::memcpy(dst, src, 8); }
inline void cp_async_commit() {}
template <int kPending> inline void cp_async_wait() {}
inline void cp_async_wait_all() {}
}  // namespace tpu_ofdm
"""


def build(d: Path, source: str, driver: str) -> Path | None:
    """Compile csrc/<source> against the emulation, with `driver` (C++
    holding main) into an executable in d; None where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "math_constants.h").write_text(MATH_CONSTANTS_H)
    (d / "cp_async.cuh").write_text(CP_ASYNC_CUH)
    shutil.copy(kbuild.CSRC / "virtual_buffer.cuh", d / "virtual_buffer.cuh")
    src = (kbuild.CSRC / source).read_text()
    src = re.sub(r"extern __shared__ (\w+) smem\[\];",
                 r"\1* smem = reinterpret_cast<\1*>(emu::shared.data());",
                 src)
    src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                 r"emu::launch(\2, \1, ", src, flags=re.S)
    stem = Path(source).stem
    (d / f"{stem}.cc").write_text(src)
    (d / "driver.cc").write_text(driver)
    exe = d / stem
    subprocess.run([gxx, "-std=c++17", "-O2", "-I", str(d), "-o", str(exe),
                    str(d / f"{stem}.cc"), str(d / "driver.cc")], check=True,
                   capture_output=True, timeout=300)
    return exe
