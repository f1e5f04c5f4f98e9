"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every source in `tpu_ofdm_torch/csrc/` compiles with nvcc for sm_90a into
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# C signatures of csrc/*.cu; the trailing pointer of each launch is the stream
_SIGNATURES = {
    "sc_detect_launch": [_P, _LL, _P, _LL, _I, _I, _P, _LL, _P],
    "gather_launch": [_P, _LL, _P, _LL, _P, _I, _I, _P, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
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
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(self.lib, fn)(*args, stream)
        if rc != 0:
            msg = self.lib.tpu_ofdm_error_string(rc).decode()
            raise RuntimeError(f"{fn} failed: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=1)
def library() -> KernelLibrary:
    """Build (if needed) and load the kernel library."""
    out_dir = BUILD_ROOT / source_digest()
    so = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *map(str, _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tpu_ofdm_error_string.argtypes = [ctypes.c_int]
    lib.tpu_ofdm_error_string.restype = ctypes.c_char_p
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib, so, seconds, log)


def check_vector(t, name: str, dtype: torch.dtype,
                 device: torch.device | None = None) -> None:
    """Raise unless `t` is a contiguous 1-D tensor of `dtype` (on
    `device`, when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def complex_ptr(t: torch.Tensor | None) -> int | None:
    """Device address of a complex64 tensor read as interleaved float2
    (None for an absent or empty tensor)."""
    if t is None or t.numel() == 0:
        return None
    return torch.view_as_real(t).data_ptr()
