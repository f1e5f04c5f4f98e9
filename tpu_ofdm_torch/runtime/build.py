"""Build the native host runtime (native/*.cc) with g++ at first use.

The library lands in `tpu_ofdm_torch/_build/runtime-<hash>/`, keyed by a
hash of the sources, the flags and the host CPU (the flags include
-march=native, so a library built on one machine is never loaded on
another), and never beside the sources.  Nothing runs at import time.

    python -m tpu_ofdm_torch.runtime.build      # build now, print the path
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
NATIVE = Path(__file__).resolve().parent / "native"
SOURCES = ("ringbuf.cc", "convert.cc", "reader.cc")
BUILD_ROOT = PKG / "_build"
LIB_NAME = "libtpu_ofdm_runtime.so"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-Wall")


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor()
    keep = [line for line in text.splitlines()
            if line.startswith(("model name", "flags", "Features"))]
    return "\n".join(sorted(set(keep)))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_id().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return h.hexdigest()[:16]


def compiler() -> str | None:
    """g++ on PATH, or None (then the runtime takes its numpy engine)."""
    return shutil.which("g++")


def build(gxx: str) -> Path:
    """Build (if needed) the runtime library under BUILD_ROOT; returns its
    path.  Raises RuntimeError with g++'s output if the build fails."""
    out_dir = BUILD_ROOT / f"runtime-{source_digest()}"
    so = out_dir / LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [gxx, *FLAGS, "-o", str(tmp),
           *(str(NATIVE / name) for name in SOURCES), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed (exit "
                           f"{proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)   # atomic: concurrent builds each install a whole file
    return so


if __name__ == "__main__":
    gxx = compiler()
    if gxx is None:
        raise SystemExit("g++ not found: the runtime would use its numpy engine")
    print(build(gxx))
