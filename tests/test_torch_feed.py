"""The port's DeviceFeed (tpu_ofdm_torch/io/feed.py) against the JAX
package's on the same sources, on the CPU (device="cpu": plain copies, no
pinning, no streams; the card's pinned path runs in chip_smoke.py phase
11): blocks equal bit for bit, (re, im) planes joined into complex64, a
FileStreamer read straight into the feed's buffers, source errors passed
to the consumer, and an undrained feed stopped by close()."""

import threading

import numpy as np
import pytest
import torch

from tests.helpers.jax_native import ensure_jax_native
from tpu_ofdm import runtime as jrt
from tpu_ofdm.io import DeviceFeed as JaxFeed
from tpu_ofdm_torch import runtime as rt
from tpu_ofdm_torch.io import DeviceFeed
from tpu_ofdm_torch.utils import metrics

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _jax_native_engine():
    """The JAX runtime's native engine in this worker, reloaded whole if
    this worker lost the race to build it (tests/helpers/jax_native.py)."""
    ensure_jax_native(jrt)


def _blocks(n=10, size=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(size) + 1j * rng.randn(size)).astype(np.complex64)
            for _ in range(n)]


def test_feed_matches_source_and_jax():
    data = _blocks()
    got = list(DeviceFeed(iter(data), depth=2, device=CPU))
    want = [np.asarray(b) for b in JaxFeed(iter(data), depth=2)]
    assert len(got) == len(want) == 10
    for g, w, d in zip(got, want, data):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.complex64
        np.testing.assert_array_equal(g.numpy(), d)
        np.testing.assert_array_equal(g.numpy(), w)


def test_feed_copies_the_block():
    """A yielded tensor does not share memory with the source's array,
    which the source may reuse."""
    buf = np.ones(16, np.complex64)
    (got,) = DeviceFeed(iter([buf]), device=CPU)
    buf[:] = 0
    assert (got.numpy() == 1).all()


def test_feed_narrows_64_bit_types():
    got = list(DeviceFeed(iter([np.arange(4.0), np.ones(4, np.complex128)]),
                          device=CPU))
    assert [g.dtype for g in got] == [torch.float32, torch.complex64]


def test_planes_become_complex64():
    rng = np.random.RandomState(1)
    re, im = rng.randn(2, 128).astype(np.float32)
    (got,) = DeviceFeed(iter([(re, im)]), device=CPU)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.real.numpy(), re)
    np.testing.assert_array_equal(got.imag.numpy(), im)


def test_bad_tuple_block_reaches_the_consumer():
    feed = DeviceFeed(iter([(np.zeros(4), np.zeros(4), np.zeros(4))]),
                      device=CPU)
    with pytest.raises(TypeError, match="re, im"):
        list(feed)


@pytest.mark.parametrize("fmt", ["i16c", "f32c"])
def test_file_streamer_through_the_feed_equals_jax(tmp_path, fmt):
    """The streamer's blocks, converted by read_into straight into the
    feed's buffers, equal the JAX streamer's planes through the JAX feed."""
    n, block = 5 * 2048 - 100, 2048
    rng = np.random.RandomState(2)
    re, im = (rng.randn(2, n) * 0.3).astype(np.float32)
    path = str(tmp_path / f"c.{fmt}")
    with open(path, "wb") as f:
        f.write(rt.from_planar(re, im, fmt))
    with rt.FileStreamer(path, fmt, block_size=block) as fs:
        got = list(DeviceFeed(fs.packed(), depth=2, device=CPU))
    jfs = jrt.FileStreamer(path, fmt, block_size=block)
    want = [np.asarray(b.re) + 1j * np.asarray(b.im)
            for b in JaxFeed(jfs.packed(), depth=2)]
    jfs.close()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.complex64))


def test_feed_times_its_fills():
    fs_blocks = _blocks(n=4)
    was_on = metrics.enable(True)
    try:
        list(DeviceFeed(iter(fs_blocks), device=CPU))
    finally:
        metrics.enable(was_on)
    spans = metrics.drain().spans
    assert [s.name for s in spans].count("feed.fill") == 4


def test_feed_propagates_errors():
    def bad():
        yield np.zeros(8, np.complex64)
        raise RuntimeError("source died")

    it = iter(DeviceFeed(bad(), depth=2, device=CPU))
    next(it)
    with pytest.raises(RuntimeError, match="source died"):
        next(it)


def test_feed_propagates_a_streamer_read_error(tmp_path):
    """A FileStreamer's OSError (here: reading a directory, which the
    native reader opens and fails to read) reaches the consumer."""
    assert rt.NATIVE
    with rt.FileStreamer(str(tmp_path), "f32c", block_size=256) as fs:
        with pytest.raises(IsADirectoryError):
            list(DeviceFeed(fs.packed(), device=CPU))


def test_close_stops_an_undrained_feed():
    """A consumer that stops early closes the feed: the worker, blocked on
    a full queue, exits and the staged blocks are dropped."""
    feed = DeviceFeed(iter(_blocks(n=50)), depth=2, device=CPU)
    it = iter(feed)
    next(it)
    done = threading.Event()
    t = threading.Thread(target=lambda: (feed.close(), done.set()),
                         daemon=True)
    t.start()
    t.join(20)
    assert done.is_set() and not feed._t.is_alive()
    assert feed._q.empty()
