"""The port's native host runtime (tpu_ofdm_torch/runtime) against the JAX
package's (tpu_ofdm/runtime), on both of the port's engines: the g++-built
library and the numpy engine it keeps for machines without g++.  Planes,
wire bytes and streamed blocks are held bit for bit.  Also the faults of
the JAX FileStreamer that the port does not copy: a block larger than the
ring raises instead of hanging, and a failed read raises instead of ending
the stream."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tests.helpers.jax_native import ensure_jax_native
from tpu_ofdm import runtime as jrt
from tpu_ofdm_torch import runtime as rt
from tpu_ofdm_torch.runtime import build as rbuild

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 2048
FORMATS = [("i8c", np.int8), ("i16c", np.int16), ("f32c", np.float32)]


@pytest.fixture(autouse=True, scope="module")
def _jax_native_engine():
    """The JAX runtime's native engine in this worker, reloaded whole if
    this worker lost the race to build it (tests/helpers/jax_native.py)."""
    ensure_jax_native(jrt)


@pytest.fixture(params=["native", "numpy"])
def engine(request, monkeypatch):
    """Run the test on one engine of the port's runtime."""
    if request.param == "numpy":
        monkeypatch.setattr(rt, "native_lib", lambda: None)
    else:
        assert rt.native_lib() is not None
    return request.param


def _wire(fmt, dtype, n, seed):
    rng = np.random.RandomState(seed)
    if fmt == "f32c":
        return rng.randn(2 * n).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.randint(info.min, info.max, size=2 * n).astype(dtype)


def _in_thread(fn, timeout=20.0):
    """fn() in a thread: its exception or result, or a failure if it does
    not return within `timeout` s (a hang fails instead of stalling)."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the test thread
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no return within {timeout} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def test_engine_reported():
    """g++ here, so the native engine loads; NATIVE names it."""
    assert rbuild.compiler() is not None
    assert rt.NATIVE is True
    assert jrt.NATIVE is True


# A worker that lost the race to build the JAX library: its import finds no
# loadable library (ctypes.CDLL raises) and takes the numpy engine.  The
# helper then brings the native engine back, and every converter and the
# streamer must equal the port's bit for bit.
_LOST_RACE = """
import ctypes, os, sys, tempfile
import numpy as np
import jax, tpu_ofdm  # the patch below then touches only the runtime's load
from tests.helpers.jax_native import ensure_jax_native
from tpu_ofdm_torch import runtime as rt

def lost_race(*args, **kwargs):
    raise OSError("half-written _native.so")

cdll, ctypes.CDLL = ctypes.CDLL, lost_race
from tpu_ofdm import runtime as jrt
ctypes.CDLL = cdll
assert jrt.NATIVE is False
assert ensure_jax_native(jrt) is True

rng = np.random.RandomState(7)
for fmt, dtype in (("i8c", np.int8), ("i16c", np.int16)):
    wire = rng.randint(-100, 100, 2000).astype(dtype).view(np.uint8)
    for g, w in zip(rt.to_planar(wire, fmt), jrt.to_planar(wire, fmt)):
        assert g.tobytes() == w.tobytes(), fmt
wire = rng.randn(2000).astype(np.float32).view(np.uint8)
for g, w in zip(rt.to_planar(wire, "f32c"), jrt.to_planar(wire, "f32c")):
    assert g.tobytes() == w.tobytes(), "f32c"
re, im = (rng.randn(2, 999) * 0.5).astype(np.float32)
for fmt in ("f32c", "i16c"):
    assert rt.from_planar(re, im, fmt) == jrt.from_planar(re, im, fmt), fmt
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "c.i16c")
    rng.randint(-30000, 30000, 2 * 4 * 512).astype(np.int16).tofile(path)
    with rt.FileStreamer(path, "i16c", block_size=512) as fs:
        got = list(fs)
    jfs = jrt.FileStreamer(path, "i16c", block_size=512)
    want = list(jfs)
    jfs.close()
assert len(got) == len(want) == 4
for (gr, gi), (wr, wi) in zip(got, want):
    assert gr.tobytes() == wr.tobytes() and gi.tobytes() == wi.tobytes()
print("JAX_ENGINE_WHOLE")
"""


def test_jax_engine_reloaded_after_a_lost_build_race():
    """The helper reloads the module whole: `_load()` alone would leave the
    converters without argtypes, and the first conversion would crash the
    process on its truncated pointers."""
    proc = subprocess.run([sys.executable, "-c", _LOST_RACE], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "JAX_ENGINE_WHOLE" in proc.stdout, \
        f"rc {proc.returncode}\n{proc.stderr}"


def test_no_compiler_takes_the_numpy_engine(monkeypatch):
    monkeypatch.setattr(rt, "_engine", None)
    monkeypatch.setattr(rbuild, "compiler", lambda: None)
    assert rt.NATIVE is False
    re, im = rt.to_planar(np.arange(8, dtype=np.int16).view(np.uint8), "i16c")
    np.testing.assert_array_equal(
        re, np.arange(0, 8, 2, dtype=np.float32) * np.float32(1 / 32767))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails raises; the engine is not switched quietly."""
    monkeypatch.setattr(rt, "_engine", None)
    monkeypatch.setattr(rbuild, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(rbuild, "compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        rt.native_lib()
    with pytest.raises(RuntimeError):
        rt.NATIVE
    assert rt._engine is None


def test_failed_load_raises(monkeypatch, tmp_path):
    bogus = tmp_path / "not_a_library.so"
    bogus.write_bytes(b"not an ELF file")
    monkeypatch.setattr(rt, "_engine", None)
    monkeypatch.setattr(rbuild, "build", lambda gxx: bogus)
    with pytest.raises(OSError):
        rt.native_lib()


def test_build_lands_under_build_dir():
    """Keyed by the sources' hash, never beside them."""
    so = rbuild.build(rbuild.compiler())
    assert so.parent.parent == rbuild.BUILD_ROOT
    assert so.parent.name == f"runtime-{rbuild.source_digest()}"
    assert not any(p.suffix == ".so" for p in rbuild.NATIVE.iterdir())


def test_native_sources_are_the_jax_packages():
    """Copies: ringbuf.cc and convert.cc byte for byte in their code (the
    header comments differ); reader.cc also stores -errno on a failed
    read."""
    jdir = os.path.join(os.path.dirname(jrt.__file__), "native")

    def code(path):
        text = open(path).read()
        return text[text.index("#include"):]

    for name in ("ringbuf.cc", "convert.cc"):
        assert code(rbuild.NATIVE / name) == code(os.path.join(jdir, name))
    assert "-errno" in code(rbuild.NATIVE / "reader.cc")


def test_ring_roundtrip_with_wraparound(engine):
    rb = rt.RingBuffer(1 << 12)
    cap = rb.capacity
    rng = np.random.RandomState(0)
    chunk = rng.randint(0, 256, size=cap // 3 + 7, dtype=np.uint8)
    got = []
    for _ in range(10):
        assert rb.write(chunk) == len(chunk)
        got.append(rb.peek(len(chunk)).copy())
        rb.consume(len(chunk))
    for g in got:
        np.testing.assert_array_equal(g, chunk)
    rb.close()


def test_ring_backpressure(engine):
    rb = rt.RingBuffer(4096)
    n = rb.write(np.zeros(2 * rb.capacity, dtype=np.uint8))
    assert n == rb.capacity
    assert rb.writable() == 0
    rb.consume(100)
    assert rb.writable() == 100
    rb.close()


def test_ring_spsc_threaded(engine):
    rb = rt.RingBuffer(1 << 14)
    total = 1 << 20
    src = np.arange(total, dtype=np.uint8)
    out = np.empty(total, dtype=np.uint8)

    def producer():
        sent = 0
        while sent < total:
            sent += rb.write(src[sent: sent + 4096])

    t = threading.Thread(target=producer)
    t.start()
    rcvd = 0
    while rcvd < total:
        n = min(rb.readable(), total - rcvd)
        if n == 0:
            continue
        out[rcvd: rcvd + n] = rb.peek(n)
        rb.consume(n)
        rcvd += n
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_array_equal(out, src)
    rb.close()


@pytest.mark.parametrize("scale", [None, 0.25])
@pytest.mark.parametrize("fmt,dtype", FORMATS, ids=[f for f, _ in FORMATS])
def test_to_planar_equals_jax(engine, fmt, dtype, scale):
    wire = _wire(fmt, dtype, 1000, seed=1).view(np.uint8)
    got = rt.to_planar(wire, fmt, scale)
    want = jrt.to_planar(wire, fmt, scale)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt,scale", [("f32c", None), ("i16c", None),
                                       ("i16c", 1000.0)])
def test_from_planar_equals_jax(engine, fmt, scale):
    rng = np.random.RandomState(2)
    re = (rng.randn(777) * 0.5).astype(np.float32)
    im = (rng.randn(777) * 0.5).astype(np.float32)
    re[:4] = [2.0, -2.0, 1.0, -1.0]            # clipped ends
    assert rt.from_planar(re, im, fmt, scale) == \
        jrt.from_planar(re, im, fmt, scale)


def test_planar_roundtrip_i16(engine):
    rng = np.random.RandomState(2)
    re = rng.uniform(-0.9, 0.9, 500).astype(np.float32)
    im = rng.uniform(-0.9, 0.9, 500).astype(np.float32)
    wire = rt.from_planar(re, im, "i16c")
    re2, im2 = rt.to_planar(np.frombuffer(wire, np.uint8), "i16c")
    np.testing.assert_allclose(re2, re, atol=1e-4)
    np.testing.assert_allclose(im2, im, atol=1e-4)


@pytest.mark.parametrize("fmt,dtype", FORMATS, ids=[f for f, _ in FORMATS])
def test_file_streamer_equals_jax(engine, tmp_path, fmt, dtype):
    """Every block's planes as the JAX FileStreamer yields them, the
    zero-padded tail included."""
    n = 5 * BLOCK - 300
    path = str(tmp_path / f"capture.{fmt}")
    _wire(fmt, dtype, n, seed=3).tofile(path)
    scale = 0.5 if fmt != "f32c" else None
    with rt.FileStreamer(path, fmt, block_size=BLOCK, scale=scale) as fs:
        got = list(fs)
    jfs = jrt.FileStreamer(path, fmt, block_size=BLOCK, scale=scale)
    want = list(jfs)
    jfs.close()
    assert len(got) == len(want) == 5
    for (gr, gi), (wr, wi) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gi, wi)


def test_file_streamer_roundtrip(engine, tmp_path):
    rng = np.random.RandomState(3)
    n = 300000
    samples = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    path = os.path.join(tmp_path, "capture.c64")
    samples.view(np.float32).tofile(path)
    block = 1 << 16
    with rt.FileStreamer(path, fmt="f32c", block_size=block) as fs:
        got = []
        for re, im in fs:
            assert re.shape == (block,)
            got.append(re + 1j * im)
    np.testing.assert_array_equal(np.concatenate(got)[:n], samples)


def test_read_into_fills_the_callers_planes(engine, tmp_path):
    """read_into converts into the given planes (what DeviceFeed hands it:
    its pinned buffer) and returns the samples read, 0 at the end."""
    n = 2 * BLOCK + 5
    path = str(tmp_path / "c.i16c")
    wire = _wire("i16c", np.int16, n, seed=4)
    wire.tofile(path)
    want_re, want_im = rt.to_planar(wire.view(np.uint8), "i16c")
    planes = np.full((2, BLOCK), np.nan, np.float32)
    counts = []
    with rt.FileStreamer(path, "i16c", block_size=BLOCK) as fs:
        assert fs.packed() is fs
        for i in range(3):
            counts.append(fs.read_into(planes[0], planes[1]))
            lo = i * BLOCK
            hi = min(lo + BLOCK, n)
            np.testing.assert_array_equal(planes[0, : hi - lo],
                                          want_re[lo:hi])
            np.testing.assert_array_equal(planes[1, : hi - lo],
                                          want_im[lo:hi])
            assert not planes[:, hi - lo:].any()
        assert fs.read_into(planes[0], planes[1]) == 0
        with pytest.raises(ValueError, match="float32"):
            fs.read_into(planes[0].astype(np.float64), planes[1])
    assert counts == [BLOCK, BLOCK, 5]


def test_read_into_times_read_and_convert(engine, tmp_path):
    """last_times is the last block's (read, convert) seconds: zeros before
    the first read, then two non-negative times a block."""
    path = str(tmp_path / "c.i16c")
    _wire("i16c", np.int16, 2 * BLOCK, seed=5).tofile(path)
    planes = np.empty((2, BLOCK), np.float32)
    with rt.FileStreamer(path, "i16c", block_size=BLOCK) as fs:
        assert fs.last_times == (0.0, 0.0)
        for _ in range(2):
            assert fs.read_into(planes[0], planes[1]) == BLOCK
            read, convert = fs.last_times
            assert read >= 0.0 and convert >= 0.0 and read + convert > 0.0


@pytest.mark.parametrize("fmt", ["f32c", "i16c"])
def test_block_larger_than_ring_raises(engine, tmp_path, fmt):
    """The JAX streamer hangs here (its consumer waits for more bytes than
    a full ring holds); the port's raises at construction, naming both
    sizes, within the thread's timeout."""
    path = str(tmp_path / "c.raw")
    np.zeros(1 << 16, np.uint8).tofile(path)
    item = {"f32c": 8, "i16c": 4}[fmt]
    block = (1 << 20) // item * 2                 # 2 MiB of wire bytes
    with pytest.raises(ValueError, match=f"{block * item} bytes.*1048576"):
        _in_thread(lambda: rt.FileStreamer(path, fmt, block_size=block,
                                           ring_bytes=1 << 20))
    # exactly one block fits
    fs = _in_thread(lambda: rt.FileStreamer(path, fmt, block_size=block // 2,
                                            ring_bytes=1 << 20))
    assert len(_in_thread(lambda: list(fs))) == 1
    fs.close()


def test_read_error_raises(engine, tmp_path):
    """A failed read is an error, not the end of the stream: reading a
    directory fails with EISDIR (at the first read on the native engine,
    at open on the numpy one)."""
    def stream():
        with rt.FileStreamer(str(tmp_path), "f32c", block_size=BLOCK) as fs:
            return list(fs)

    with pytest.raises(IsADirectoryError):
        _in_thread(stream)


def test_missing_file_raises(engine, tmp_path):
    with pytest.raises(OSError):
        rt.FileStreamer(str(tmp_path / "absent.raw"), "f32c", block_size=BLOCK)
