"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every source in `tpu_ofdm_torch/csrc/` compiles with nvcc for sm_90a, one
nvcc process per source, all started together, and the objects link into
ONE shared library with a plain C interface (no PyTorch headers, so the
build takes seconds, not minutes).  The library lands in
`tpu_ofdm_torch/_build/<hash of sources and flags>/` and is loaded once per
process.  Nothing here runs at import time: the CPU-only test environment
imports every module and has no nvcc.

Each launch function takes raw device pointers and the CUDA stream (all
`c_void_p`), launches on PyTorch's current stream and returns
cudaGetLastError(); `KernelLibrary.launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
LIB_NAME = "libtpu_ofdm_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# C signatures of csrc/*.cu; the trailing pointer of each launch is the stream
_SIGNATURES = {
    "sc_detect_launch": [_P, _LL, _LL, _P, _LL, _LL, _I, _I, _I, _P, _LL,
                         _P],
    "gather_launch": [_P, _LL, _LL, _P, _LL, _LL, _I, _P, _I, _I, _P, _P],
    "pfb_launch": [_P, _LL, _P, _LL, _P, _I, _I, _P, _P],
    "psd_launch": [_P, _LL, _P, _I, _P, _P],
    "scan_launch": [_P, _LL, _LL, _P, _LL, _P, _P],
    "sc_metric_launch": [_P, _LL, _LL, _I, _P, _P, _P, _P],
}


def source_digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    build_log: str        # nvcc / ptxas -v output of the build

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call launch function `fn` on `device`'s current stream."""
        with torch.cuda.device(device):
            rc = getattr(self.lib, fn)(
                *args, torch._C._cuda_getCurrentRawStream(device.index))
        if rc != 0:
            msg = self.lib.tpu_ofdm_error_string(rc).decode()
            raise RuntimeError(f"{fn} failed: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library of this checkout."""
    return build_library(CSRC, BUILD_ROOT)


def build_library(csrc: Path, build_root: Path) -> KernelLibrary:
    """Build (if needed) and load the kernels of the sources in `csrc`,
    under `build_root` (kernel_ab.py builds other trees this way)."""
    out_dir = build_root / source_digest(csrc)
    so = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        nvcc = nvcc_path()
        sources = sorted(csrc.glob("*.cu"))
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        compiles = [[nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
                     str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [proc.communicate()[0] for proc in procs]
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        steps = list(zip(compiles, procs, logs))
        if all(proc.returncode == 0 for proc in procs):
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc, proc.stdout + proc.stderr))
        seconds = time.perf_counter() - t0
        log = "".join(out for _, _, out in steps)
        for cmd, proc, out in steps:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        log_path.write_text(log)
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu_ofdm_error_string.argtypes = [ctypes.c_int]
    lib.tpu_ofdm_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, so, seconds, log)


ANY_RANK = tuple(range(1, 17))  # check_vector's ndims for "any rank >= 1"


def check_vector(t, name: str, dtype: torch.dtype,
                 device: torch.device | None = None,
                 ndims: tuple[int, ...] = (1,)) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` with a rank in
    `ndims` (on `device`, when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim not in ndims:
        raise ValueError(f"{name} must have rank in {ndims}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def complex_ptr(t: torch.Tensor | None) -> int | None:
    """Device address of a complex64 tensor, read as interleaved float2
    (None for an absent or empty tensor)."""
    if t is None or t.numel() == 0:
        return None
    return t.data_ptr()
