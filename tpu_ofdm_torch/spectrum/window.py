"""Window functions (counterpart of tpu_ofdm/spectrum/window.py).

Numpy tables, built once per (name, length) by the callers and moved to the
device with the rest of their constants.  The JAX module is numpy-only too,
but it cannot be shared: importing it runs tpu_ofdm/spectrum/__init__.py,
which imports jax.  The formulas and float32 casts are the reference's, so
the tables are bit-identical.
"""

from __future__ import annotations

import numpy as np


def rectangular(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.float32)


def hann(n: int) -> np.ndarray:
    """Periodic Hann, matches tests/golden/golden_ofdm.hann."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def hamming(n: int) -> np.ndarray:
    return (0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def blackman(n: int) -> np.ndarray:
    x = 2 * np.pi * np.arange(n) / n
    return (0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)).astype(np.float32)


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris (the reference's default analyzer window)."""
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    x = 2 * np.pi * np.arange(n) / n
    return (
        a[0] - a[1] * np.cos(x) + a[2] * np.cos(2 * x) - a[3] * np.cos(3 * x)
    ).astype(np.float32)


def kaiser(n: int, beta: float = 9.0) -> np.ndarray:
    return np.kaiser(n, beta).astype(np.float32)


_WINDOWS = {
    "rect": rectangular,
    "rectangular": rectangular,
    "hann": hann,
    "hanning": hann,
    "hamming": hamming,
    "blackman": blackman,
    "blackman_harris": blackman_harris,
    "blackmanharris": blackman_harris,
}


def get(name: str, n: int) -> np.ndarray:
    try:
        return _WINDOWS[name](n)
    except KeyError:
        raise ValueError(f"unknown window {name!r}; have {sorted(_WINDOWS)}")
