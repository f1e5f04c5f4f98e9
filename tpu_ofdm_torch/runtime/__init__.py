"""Native host runtime: ring buffers, format converters, threaded readers
(counterpart of tpu_ofdm/runtime).

C++ equivalents of the reference's native runtime around the compute path
(vmcircbuf circular buffers, VOLK format conversions, file_source and its
scheduler thread): `native/*.cc`, copies of the JAX package's sources,
built with g++ at first use into `tpu_ofdm_torch/_build/` (`build.py`).

Engines.  Where no g++ is found the same API runs on numpy; where g++ is
found and the build or the load fails, the first call raises (the JAX
package falls back to numpy silently there).  `NATIVE` says which engine
loaded: reading it builds and loads the library.

Two faults of the JAX `FileStreamer` are not copied: a block larger than the
ring raises ValueError here (the JAX consumer waits for bytes a full ring
can never hold, and hangs), and a failed read raises OSError (the JAX one
ends the stream as if at EOF).
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Iterator

import numpy as np

from tpu_ofdm_torch.runtime import build as _build
from tpu_ofdm_torch.utils import metrics

_lock = threading.Lock()
_engine: tuple | None = None   # (library or None,) once decided


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, N, F = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float
    sigs = {
        "rb_create": (P, [N]), "rb_destroy": (None, [P]),
        "rb_capacity": (N, [P]), "rb_readable": (N, [P]),
        "rb_writable": (N, [P]), "rb_write_ptr": (P, [P]),
        "rb_read_ptr": (P, [P]), "rb_commit": (None, [P, N]),
        "rb_consume": (None, [P, N]),
        "reader_start": (P, [P, ctypes.c_char_p, N]),
        "reader_state": (ctypes.c_int, [P]), "reader_stop": (None, [P]),
        "conv_i8c_to_planar_f32": (None, [P, P, P, N, F]),
        "conv_i16c_to_planar_f32": (None, [P, P, P, N, F]),
        "conv_f32c_to_planar": (None, [P, P, P, N]),
        "conv_planar_to_f32c": (None, [P, P, P, N]),
        "conv_planar_to_i16c": (None, [P, P, P, N, F]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def native_lib() -> ctypes.CDLL | None:
    """The runtime library, built and loaded at the first call; None where
    no g++ is found (the numpy engine).  Raises where g++ is found and the
    build or the load fails."""
    global _engine
    with _lock:
        if _engine is None:
            gxx = _build.compiler()
            lib = None if gxx is None else _bind(ctypes.CDLL(
                str(_build.build(gxx)), use_errno=True))
            _engine = (lib,)
        return _engine[0]


def __getattr__(name):
    if name == "NATIVE":
        return native_lib() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _u8(lib, ptr, n: int) -> np.ndarray:
    """A zero-copy uint8 view of n bytes at a native address."""
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(n,))


class RingBuffer:
    """Double-mapped SPSC byte ring (native) or a bytearray (numpy engine).

    The native ring hands out zero-copy numpy views of the doubly-mapped
    region, so a read spanning the wrap point is still one contiguous view
    (the vmcircbuf property)."""

    def __init__(self, capacity: int):
        self._lib = native_lib()
        if self._lib is not None:
            self._h = self._lib.rb_create(capacity)
            if not self._h:
                raise MemoryError(f"rb_create({capacity}) failed")
            self.capacity = self._lib.rb_capacity(self._h)
        else:
            self._h = None
            self.capacity = capacity
            self._buf = bytearray()
            self._buf_lock = threading.Lock()

    # --- producer side -----------------------------------------------------
    def writable(self) -> int:
        if self._h:
            return self._lib.rb_writable(self._h)
        with self._buf_lock:
            return self.capacity - len(self._buf)

    def write(self, data: np.ndarray | bytes) -> int:
        data = np.frombuffer(
            data.tobytes() if isinstance(data, np.ndarray) else data,
            dtype=np.uint8,
        )
        n = min(len(data), self.writable())
        if n == 0:
            return 0
        if self._h:
            _u8(self._lib, self._lib.rb_write_ptr(self._h), n)[:] = data[:n]
            self._lib.rb_commit(self._h, n)
        else:
            with self._buf_lock:
                self._buf.extend(data[:n].tobytes())
        return n

    # --- consumer side -----------------------------------------------------
    def readable(self) -> int:
        if self._h:
            return self._lib.rb_readable(self._h)
        with self._buf_lock:
            return len(self._buf)

    def peek(self, n: int) -> np.ndarray:
        """The next n readable bytes: a zero-copy view (native, valid until
        consume) or a copy (numpy engine)."""
        n = min(n, self.readable())
        if self._h:
            return _u8(self._lib, self._lib.rb_read_ptr(self._h), n)
        with self._buf_lock:
            return np.frombuffer(bytes(self._buf[:n]), dtype=np.uint8)

    def consume(self, n: int) -> None:
        if self._h:
            self._lib.rb_consume(self._h, n)
        else:
            with self._buf_lock:
                del self._buf[:n]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


_ITEM = {"i8c": 2, "i16c": 4, "f32c": 8}
_DEFAULT_SCALE = {"i8c": 1.0 / 127.0, "i16c": 1.0 / 32767.0}


def _planar_into(lib, raw: np.ndarray, n: int, fmt: str, scale, re, im):
    """Deinterleave the first n samples of wire bytes `raw` into the
    float32 planes re[:n], im[:n] (native, or numpy with the same float32
    arithmetic, so both engines give the same bits)."""
    if fmt == "f32c":
        if lib is not None:
            lib.conv_f32c_to_planar(raw.ctypes.data, re.ctypes.data,
                                    im.ctypes.data, n)
        else:
            iq = raw[: 8 * n].view(np.float32).reshape(n, 2)
            re[:n], im[:n] = iq[:, 0], iq[:, 1]
        return
    if fmt not in _DEFAULT_SCALE:
        raise ValueError(f"unknown format {fmt!r}")
    s = np.float32(scale if scale is not None else _DEFAULT_SCALE[fmt])
    if lib is not None:
        conv = (lib.conv_i8c_to_planar_f32 if fmt == "i8c"
                else lib.conv_i16c_to_planar_f32)
        conv(raw.ctypes.data, re.ctypes.data, im.ctypes.data, n, s)
    else:
        wire = np.int8 if fmt == "i8c" else np.int16
        iq = raw[: _ITEM[fmt] * n].view(wire).reshape(n, 2)
        np.multiply(iq[:, 0], s, out=re[:n], dtype=np.float32)
        np.multiply(iq[:, 1], s, out=im[:n], dtype=np.float32)


def to_planar(raw: np.ndarray, fmt: str, scale: float | None = None):
    """Interleaved IQ bytes -> (re, im) float32 planes."""
    if fmt not in _ITEM:
        raise ValueError(f"unknown format {fmt!r}")
    raw = np.ascontiguousarray(raw.view(np.uint8).ravel())
    n = len(raw) // _ITEM[fmt]
    re = np.empty(n, dtype=np.float32)
    im = np.empty(n, dtype=np.float32)
    _planar_into(native_lib(), raw, n, fmt, scale, re, im)
    return re, im


def from_planar(re: np.ndarray, im: np.ndarray, fmt: str,
                scale: float | None = None) -> bytes:
    """(re, im) float32 planes -> interleaved IQ wire bytes."""
    lib = native_lib()
    n = len(re)
    if len(im) != n:
        raise ValueError(f"planes of {n} and {len(im)} samples")
    re = np.ascontiguousarray(re, dtype=np.float32)
    im = np.ascontiguousarray(im, dtype=np.float32)
    if fmt == "f32c":
        out = np.empty(2 * n, dtype=np.float32)
        if lib is not None:
            lib.conv_planar_to_f32c(re.ctypes.data, im.ctypes.data,
                                    out.ctypes.data, n)
        else:
            out[0::2], out[1::2] = re, im
        return out.tobytes()
    if fmt == "i16c":
        s = np.float32(scale if scale is not None else 32767.0)
        out = np.empty(2 * n, dtype=np.int16)
        if lib is not None:
            lib.conv_planar_to_i16c(re.ctypes.data, im.ctypes.data,
                                    out.ctypes.data, n, s)
        else:
            out[0::2] = np.clip(re * s, -32768, 32767).astype(np.int16)
            out[1::2] = np.clip(im * s, -32768, 32767).astype(np.int16)
        return out.tobytes()
    raise ValueError(f"unknown format {fmt!r}")


class FileStreamer:
    """Stream fixed-size planar sample blocks from a capture file.

    Native engine: a C++ reader thread fills the ring while Python converts
    from zero-copy views of it; numpy engine: plain incremental reads.
    Iterating yields (re, im) float32 planes of exactly block_size samples
    (zero-padded at EOF); `read_into` converts the next block into the
    caller's planes instead, which is how DeviceFeed fills its pinned
    buffers in one host pass.  `last_times` is the last block's (read,
    convert) seconds: the wait for the reader thread's bytes (native) or
    the file read (numpy), then the conversion into the planes, the same
    clock reads as its spans "file.read" and "file.convert" (utils.metrics).
    Close it (or use it in a `with`) to stop the reader thread.
    """

    def __init__(self, path: str, fmt: str = "f32c", block_size: int = 1 << 17,
                 ring_bytes: int = 1 << 24, scale: float | None = None):
        if fmt not in _ITEM:
            raise ValueError(f"unknown format {fmt!r}")
        self.path, self.fmt = path, fmt
        self.block = block_size
        self.scale = scale
        self.item = _ITEM[fmt]
        self._rd = self._fh = None
        self._done = False
        self.last_times = (0.0, 0.0)
        self._ring = RingBuffer(ring_bytes)
        self._lib = self._ring._lib
        want = block_size * self.item
        if want > self._ring.capacity:
            cap = self._ring.capacity
            self._ring.close()
            raise ValueError(
                f"one block of {block_size} {fmt} samples is {want} bytes, "
                f"more than the ring's capacity of {cap} bytes: pass "
                f"ring_bytes >= {want}")
        if self._lib is not None:
            self._rd = self._lib.reader_start(self._ring._h,
                                              os.fsencode(path), 1 << 18)
            if not self._rd:
                err = ctypes.get_errno() or None
                self._ring.close()
                raise OSError(err, f"cannot open {path}")
        else:
            try:
                self._fh = open(path, "rb")
            except OSError:
                self._ring.close()
                raise

    def read_into(self, re: np.ndarray, im: np.ndarray) -> int:
        """Convert the next block into the float32 planes re and im (each
        block_size long, C-contiguous), zero-padding past EOF; returns the
        samples read, 0 at the end of the stream.  Raises OSError where the
        read failed."""
        for plane in (re, im):
            if (plane.dtype != np.float32 or plane.shape != (self.block,)
                    or not plane.flags.c_contiguous):
                raise ValueError(f"read_into takes C-contiguous float32 "
                                 f"planes of ({self.block},), got "
                                 f"{plane.dtype} {plane.shape}")
        if self._done:
            return 0
        want = self.block * self.item
        with metrics.timed("file.read") as read:
            if self._rd is not None:
                lib = self._lib
                while (self._ring.readable() < want
                       and lib.reader_state(self._rd) == 0):
                    time.sleep(0.0005)
                state = lib.reader_state(self._rd)
                if state < 0:
                    raise OSError(-state, os.strerror(-state), self.path)
                n = min(want, self._ring.readable())
                raw = self._ring.peek(n)
            else:
                raw = np.frombuffer(self._fh.read(want), dtype=np.uint8)
                n = len(raw)
        with metrics.timed("file.convert") as convert:
            n_samp = n // self.item
            _planar_into(self._lib, raw, n_samp, self.fmt, self.scale, re,
                         im)
            if self._rd is not None:
                self._ring.consume(n)
            if n_samp < self.block:
                re[n_samp:] = 0
                im[n_samp:] = 0
                self._done = True
        self.last_times = (read.seconds, convert.seconds)
        return n_samp

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            re = np.empty(self.block, dtype=np.float32)
            im = np.empty(self.block, dtype=np.float32)
            if self.read_into(re, im) == 0:
                return
            yield re, im

    def packed(self) -> "FileStreamer":
        """What DeviceFeed stages: the streamer itself, whose blocks the
        feed converts straight into its pinned buffers and joins into
        complex64 on the card (the JAX package's packed() yielded
        PackedComplex blocks, which only its TPU backend needed)."""
        return self

    def close(self):
        if self._rd is not None:
            self._lib.reader_stop(self._rd)
            self._rd = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._ring.close()

    def __enter__(self) -> "FileStreamer":
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # stop the reader thread before the ring it writes is unmapped
        if hasattr(self, "_ring"):
            self.close()
