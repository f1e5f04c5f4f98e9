"""Host-side sample sources and sinks (counterpart of
tpu_ofdm/io/sources.py, a numpy-only copy: that module's package imports
jax).

File and synthetic sources stand in for the SDR front ends.  All sources
yield fixed-size numpy blocks (the executor's static-shape contract; the
executor copies them to its device); float32 interleaved and int16 (SC16 /
SDR capture) formats are supported for files.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def _to_c64(raw: np.ndarray, fmt: str) -> np.ndarray:
    if fmt == "c64":
        return raw.view(np.complex64)
    if fmt == "f32":  # interleaved float32 I/Q
        f = raw.view(np.float32)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    if fmt == "i16":  # interleaved int16 I/Q (SC16), full-scale -> +-1
        i = raw.view(np.int16).astype(np.float32) / 32768.0
        return (i[0::2] + 1j * i[1::2]).astype(np.complex64)
    raise ValueError(f"unknown sample format {fmt!r}")


_ITEM_BYTES = {"c64": 8, "f32": 8, "i16": 4}


def file_source(
    path: str,
    block_size: int,
    fmt: str = "c64",
    repeat: bool = False,
    pad_tail: bool = True,
) -> Iterator[np.ndarray]:
    """Stream complex64 blocks from a raw capture file (cf. blocks.file_source).

    fmt: 'c64' (native complex64), 'f32' (interleaved float I/Q), 'i16'
    (interleaved 16-bit I/Q, the common SDR recording format).
    """
    item = _ITEM_BYTES[fmt]
    chunk = block_size * item
    while True:
        with open(path, "rb") as f:
            while True:
                raw = f.read(chunk)
                if not raw:
                    break
                buf = np.frombuffer(raw, dtype=np.uint8)
                x = _to_c64(buf, fmt)
                if len(x) < block_size:
                    if not pad_tail:
                        break
                    x = np.concatenate(
                        [x, np.zeros(block_size - len(x), np.complex64)]
                    )
                yield x
        if not repeat:
            return


def file_sink(path: str, fmt: str = "c64"):
    """Append-mode sample sink (cf. blocks.file_sink).  Returns (write, close)."""
    f = open(path, "ab")

    def write(x: np.ndarray):
        x = np.asarray(x, dtype=np.complex64)
        if fmt == "c64":
            f.write(x.tobytes())
        elif fmt == "f32":
            inter = np.empty(2 * x.size, np.float32)
            inter[0::2], inter[1::2] = x.real, x.imag
            f.write(inter.tobytes())
        elif fmt == "i16":
            inter = np.empty(2 * x.size, np.float32)
            inter[0::2], inter[1::2] = x.real, x.imag
            f.write((np.clip(inter, -1, 1) * 32767).astype(np.int16).tobytes())
        else:
            raise ValueError(fmt)

    return write, f.close


def sig_source(
    block_size: int,
    freq_rel: float,
    amplitude: float = 1.0,
    phase: float = 0.0,
) -> Iterator[np.ndarray]:
    """Endless complex exponential at freq_rel (fraction of fs), phase-
    continuous across blocks (cf. analog.sig_source_c)."""
    n = 0
    w = 2.0 * np.pi * freq_rel
    while True:
        t = np.arange(n, n + block_size, dtype=np.float64)
        yield (amplitude * np.exp(1j * (w * t + phase))).astype(np.complex64)
        n += block_size


def noise_source(
    block_size: int, amplitude: float = 1.0, seed: int = 0
) -> Iterator[np.ndarray]:
    """Endless complex Gaussian noise (cf. analog.noise_source_c)."""
    rng = np.random.RandomState(seed)
    s = amplitude / np.sqrt(2.0)
    while True:
        yield (
            (rng.randn(block_size) + 1j * rng.randn(block_size)) * s
        ).astype(np.complex64)


def vector_source(
    data: np.ndarray, block_size: int, repeat: bool = False
) -> Iterator[np.ndarray]:
    """Blocks from an in-memory vector, zero-padded tail (cf. vector_source_c)."""
    data = np.asarray(data, dtype=np.complex64)
    while True:
        for i in range(0, len(data), block_size):
            x = data[i : i + block_size]
            if len(x) < block_size:
                x = np.concatenate([x, np.zeros(block_size - len(x), np.complex64)])
            yield x
        if not repeat:
            return


def head(source: Iterator[np.ndarray], n_blocks: int) -> Iterator[np.ndarray]:
    """Pass at most n_blocks blocks (cf. blocks.head)."""
    for i, x in enumerate(source):
        if i >= n_blocks:
            return
        yield x


def file_size_samples(path: str, fmt: str = "c64") -> int:
    return os.path.getsize(path) // _ITEM_BYTES[fmt]
