"""Double-buffered host->device sample feed (counterpart of
tpu_ofdm/io/feed.py).

A background thread stages upcoming blocks on the device while the
executor crunches the current one.  On the card each block is written into
one of two pinned host buffers and copied with non_blocking=True on the
feed's own CUDA stream, so the copy runs beside the consumer's kernels; an
event recorded after it tells the consumer when the block is ready.  The
consumer's stream waits on that event (on the card, not the host) and the
yielded tensor is recorded on that stream, so the caching allocator cannot
hand its memory back to the copy stream while a push still reads it.  A
pinned buffer is refilled only once its last copy has completed.

Blocks: numpy arrays (64-bit types narrowed as the executor narrows them)
or (re, im) float32 plane pairs, which become complex64.  A source with a
`read_into(re, im)` method (runtime.FileStreamer) converts each block
straight into the pinned buffer: one host pass per block.

On the CPU (`device="cpu"`) blocks are copied plainly: no pinning, no
streams.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from tpu_ofdm_torch.stream.executor import _NARROW
from tpu_ofdm_torch.utils.metrics import PerfCounters

_END = object()
_SLOTS = 2


def _host_block(block):
    """A source's block -> (numpy array, is_planes): a (re, im) pair
    stacked as (2, n) float32, else the array with 64-bit types narrowed."""
    if isinstance(block, tuple):
        if len(block) != 2:
            raise TypeError(f"a tuple block must be (re, im) planes, got "
                            f"{len(block)} leaves")
        re, im = (np.asarray(p) for p in block)
        if re.dtype != np.float32 or im.dtype != np.float32 \
                or re.shape != im.shape or re.ndim != 1:
            raise TypeError("(re, im) planes must be 1-D float32 of one "
                            "length")
        return np.stack([re, im]), True
    a = np.asarray(block)
    return a.astype(_NARROW.get(a.dtype, a.dtype), copy=False), False


class _Slot:
    """A pinned staging buffer and the event of the last copy out of it."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.copied: torch.cuda.Event | None = None

    def host(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned (shape, dtype) view of the buffer, once it is free."""
        # wait until its last copy has left it: polled, not a CUDA sync,
        # so a consumer's push under sync-debug "error" is not disturbed
        while self.copied is not None and not self.copied.query():
            time.sleep(0.0002)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = None
            self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.buf[:nbytes].view(dtype).view(shape)


class DeviceFeed:
    """Iterate device-staged blocks from a host block source.

    Usage:
        for dev_block in DeviceFeed(source, depth=3):
            out = executor.push(dev_block)

    `device` is where blocks go: the card unless the caller names the CPU
    (where torch has no card, construction raises).  Errors of the source
    reach the consumer.  `counters` times, on the worker thread, "fill"
    (the source's read and convert into the staging buffer).  `close()`
    stops the worker of a feed that is not drained.
    """

    def __init__(self, source: Iterable, depth: int = 3, device="cuda"):
        self.device = torch.empty(0, device=device).device  # resolve index
        self._src = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Exception | None = None
        self._stop = threading.Event()
        self.counters = PerfCounters()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [_Slot() for _ in range(_SLOTS)]
            self._next_slot = 0
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    # --- worker thread -------------------------------------------------------
    def _worker(self):
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    self._produce(self._stage_cuda)
            else:
                self._produce(self._stage_cpu)
        except Exception as e:  # surface in the consumer thread
            self._err = e
        finally:
            self._put(_END)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, stage):
        """Stage every block of the source; stage(shape, dtype, planes,
        fill) makes a staging buffer, fill(buffer) writes the next block
        into it (False at the source's end)."""
        read_into = getattr(self._src, "read_into", None)
        if read_into is not None:
            shape = (2, self._src.block)
            while not self._stop.is_set():
                staged = stage(shape, np.float32, True,
                               lambda host: read_into(host[0], host[1]) > 0)
                if staged is None or not self._put(staged):
                    return
        else:
            for block in self._src:
                src, planes = _host_block(block)
                staged = stage(src.shape, src.dtype, planes,
                               lambda host: np.copyto(host, src) or True)
                if not self._put(staged):
                    return

    def _fill(self, fill, host: np.ndarray) -> bool:
        with self.counters.stage("fill", items=host.size):
            return fill(host)

    def _stage_cpu(self, shape, dtype, planes: bool, fill):
        host = np.empty(shape, dtype)
        if not self._fill(fill, host):
            return None
        t = torch.from_numpy(host)
        return (torch.complex(t[0], t[1]) if planes else t), None

    def _stage_cuda(self, shape, dtype, planes: bool, fill):
        dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % _SLOTS
        host = slot.host(shape, dtype)
        if not self._fill(fill, host.numpy()):
            return None
        s = self._stream
        dev = torch.empty(shape, dtype=dtype, device=self.device)
        dev.copy_(host, non_blocking=True)
        slot.copied = torch.cuda.Event()
        slot.copied.record(s)
        if planes:
            dev = torch.complex(dev[0], dev[1])
        ready = torch.cuda.Event()
        ready.record(s)
        return dev, ready

    # --- consumer ------------------------------------------------------------
    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            item = self._q.get()
            if item is _END:
                if self._err is not None:
                    raise self._err
                return
            x, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                x.record_stream(stream)
            yield x

    def close(self):
        """Stop the worker and drop the blocks it staged."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._t.join()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc):
        self.close()
