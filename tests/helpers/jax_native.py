"""The JAX runtime's native engine, loaded whole in a test process.

tpu_ofdm.runtime builds `_native.so` with g++ in place at import.  xdist
workers that import it at once on a tree without the library each run g++
on that one file, and a worker that loads it half-written takes the numpy
engine (NATIVE False).  The module's `_load()` alone cannot bring the
engine back: it declares the ring and reader prototypes, but the five
converters get their argtypes in the module body after it, and without
them ctypes passes their pointers and sizes as 32-bit ints.  So the whole
module is reloaded, once a child process has shown that a fresh import
loads the library and converts with it (a half-written library then kills
the child, not the worker)."""

import importlib
import os
import shutil
import subprocess
import sys
import time

import pytest

CONVERTERS = ("conv_i8c_to_planar_f32", "conv_i16c_to_planar_f32",
              "conv_f32c_to_planar", "conv_planar_to_f32c",
              "conv_planar_to_i16c")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# A fresh import that loads the library and puts i16c bytes through it.
_PROBE = """
import sys
import numpy as np
from tpu_ofdm import runtime as r
if not r.NATIVE:
    sys.exit(1)
wire = np.arange(-8, 8, dtype=np.int16)
re, im = r.to_planar(wire, "i16c", 1.0)
sys.exit(0 if r.from_planar(re, im, "i16c", 1.0) == wire.tobytes() else 1)
"""


def _fresh_import_loads(timeout_s):
    try:
        return subprocess.run(
            [sys.executable, "-c", _PROBE], cwd=_ROOT, capture_output=True,
            timeout=max(timeout_s, 1.0)).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def ensure_jax_native(jrt, deadline_s=120.0):
    """Bring `jrt` (the tpu_ofdm.runtime module) to its native engine if
    g++ can build it within `deadline_s`, and fail the caller's tests if
    the loaded library lacks a converter's argtypes.  Returns jrt.NATIVE."""
    deadline = time.monotonic() + deadline_s
    while (not jrt.NATIVE and shutil.which("g++")
           and time.monotonic() < deadline):
        if _fresh_import_loads(deadline - time.monotonic()):
            importlib.reload(jrt)
        if not jrt.NATIVE:
            time.sleep(0.5)
    if jrt.NATIVE:
        bare = [f for f in CONVERTERS
                if getattr(jrt._lib, f).argtypes is None]
        if bare:
            pytest.fail("tpu_ofdm.runtime loaded its native library without "
                        f"the argtypes of {', '.join(bare)}; calling them "
                        "would pass pointers as 32-bit ints")
    return jrt.NATIVE
