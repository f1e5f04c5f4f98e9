"""Observability: link metrics, per-stage perf counters, profiler hooks
(counterpart of tpu_ofdm/utils/metrics.py).

GNU Radio's opt-in per-block performance counters (work-time EWMA in
block_detail, exposed over ControlPort and plotted by gr-perf-monitorx) and
blocks.probe_rate become:

  * PerfCounters  -- host-side per-stage wall-time/throughput EWMAs
  * LinkMetrics   -- frames ok/failed, BER proxy (EVM), CFO stats,
                     aggregated from RX outputs host-side
  * trace()       -- context manager around torch.profiler (a Chrome trace
                     of the host and the card)
  * span(), count() -- the program's stages and counts at its layer
                     boundaries, off by default; drain() hands them over

`Ewma`, `PerfCounters` and `LinkMetrics` are copies of the JAX module's.
No RPC layer: metrics are plain dataclasses the caller logs/serializes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


class Ewma:
    """Exponentially-weighted moving average (cf. block_detail's pc_* EWMAs)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value: float | None = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value
        )
        return self.value


class PerfCounters:
    """Per-stage wall-time and items/s counters, on the host's clock.

    Usage:
        pc = PerfCounters()
        with pc.stage("rx_step", items=block_size):
            out = executor.push(block)
        pc.report()

    On the card a stage measures what the host spends enqueueing its work,
    unless the stage ends with a readback or a synchronize: a push returns
    before the card has run it (as the JAX counters measured dispatch under
    its async dispatch).  One object per thread: the counters take no lock.
    """

    def __init__(self, alpha: float = 0.1):
        self._t: dict[str, Ewma] = {}
        self._rate: dict[str, Ewma] = {}
        self._calls: dict[str, int] = {}
        self._alpha = alpha

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._t.setdefault(name, Ewma(self._alpha)).update(dt)
            if items and dt > 0:
                self._rate.setdefault(name, Ewma(self._alpha)).update(items / dt)
            self._calls[name] = self._calls.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        return {
            name: {
                "calls": self._calls[name],
                "ewma_ms": round(1e3 * (self._t[name].value or 0), 3),
                "ewma_items_per_s": round(
                    self._rate[name].value or 0.0, 1
                ) if name in self._rate else None,
            }
            for name in self._calls
        }

    def report_json(self) -> str:
        return json.dumps(self.report())


@dataclass
class LinkMetrics:
    """Aggregated OFDM link statistics (host-side message sink role)."""

    frames_ok: int = 0
    frames_crc_fail: int = 0
    frames_detected: int = 0
    bytes_ok: int = 0
    evm_sum: float = 0.0
    evm_max: float = 0.0
    cfo_last: float = 0.0
    samples_seen: int = 0
    _t0: float = field(default_factory=time.time)

    def update_from_frames(self, frames: list[dict]):
        """Consume collect_frames()-style dicts."""
        for f in frames:
            self.frames_detected += 1
            if f["crc_ok"]:
                self.frames_ok += 1
                self.bytes_ok += f.get("payload_len", len(f.get("payload", b"")))
                self.evm_sum += f.get("evm", 0.0)
                self.evm_max = max(self.evm_max, f.get("evm", 0.0))
            else:
                self.frames_crc_fail += 1
            if "fine_cfo" in f:
                self.cfo_last = f["fine_cfo"]

    def add_samples(self, n: int):
        self.samples_seen += n

    @property
    def frame_error_rate(self) -> float:
        return self.frames_crc_fail / max(self.frames_detected, 1)

    @property
    def mean_evm(self) -> float:
        return self.evm_sum / max(self.frames_ok, 1)

    @property
    def evm_db(self) -> float:
        return 20.0 * np.log10(max(self.mean_evm, 1e-12))

    @property
    def samples_per_sec(self) -> float:
        return self.samples_seen / max(time.time() - self._t0, 1e-9)

    def summary(self) -> dict:
        return {
            "frames_ok": self.frames_ok,
            "frames_crc_fail": self.frames_crc_fail,
            "frame_error_rate": round(self.frame_error_rate, 4),
            "bytes_ok": self.bytes_ok,
            "mean_evm": round(self.mean_evm, 5),
            "evm_db": round(self.evm_db, 2),
            "cfo_last": round(self.cfo_last, 5),
            "samples_seen": self.samples_seen,
            "samples_per_sec": round(self.samples_per_sec, 1),
        }


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the CPU and, where torch has a card, CUDA
    activities around a pipeline section; on exit the Chrome trace is
    written to `log_dir`/trace.json (open it in Perfetto or
    chrome://tracing).  It replaces the JAX module's jax.profiler trace.
    Spans are on for its duration, so the trace shows the program's stages
    on the calling thread as ranges "ofdm.<name>" above the kernels."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    was_on = enable(True)
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        enable(was_on)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# --- spans and counters ------------------------------------------------------
#
# The program's stages (`span`) and counts (`count`) at its layer boundaries:
# StreamExecutor.push, rx_block's detection and demod, the radio's TX half,
# the wideband channelizer, the sinks' wait / copy / unpack, DeviceFeed's
# waits, fill and copy, FileStreamer's read and conversion.  Off by default,
# and then `span` hands back one shared null context and `count` returns at
# once: no clock read, no allocation.  On (`enable(True)`, or inside
# `trace()`), each span is kept in memory (at most SPAN_CAP of them, the rest
# counted as dropped) with its push number, its parent on its own thread and
# its host-clock start and end, until `drain()`; while a torch.profiler runs,
# it is also the profiler range "ofdm.<name>", beside the card's kernels.

SPAN_CAP = 1 << 16
PROFILER_PREFIX = "ofdm."

_NULL = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_spans: list = []
_counters: dict[str, int] = {}
_dropped = 0


class Span(NamedTuple):
    """One finished span.  `push` is the number of the executor's push it
    belongs to (StreamExecutor.push's count of pushes, the block_index its
    sink reads; None outside a push); `parent` is the `id` of the span open
    around it on the same thread; times are time.perf_counter_ns()."""
    id: int
    name: str
    push: int | None
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int


class Drained(NamedTuple):
    spans: list[Span]
    counters: dict[str, int]
    dropped: int              # spans lost past SPAN_CAP


class _Span:
    """A span while it is open.  Its push number is its own, else its
    parent's; it may be set while the span is open (a sink learns the
    push it drains from the block's output)."""

    __slots__ = ("name", "push", "keep", "id", "parent", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, push: int | None, keep: bool):
        self.name, self.push, self.keep = name, push, keep

    def __enter__(self) -> "_Span":
        self._range = None
        if self.keep:
            stack = _stack()
            up = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = None if up is None else up.id
            if self.push is None and up is not None:
                self.push = up.push
            stack.append(self)
            if torch.autograd.profiler._is_profiler_enabled:
                self._range = torch.profiler.record_function(
                    PROFILER_PREFIX + self.name)
                self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if not self.keep:
            return
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _keep(Span(self.id, self.name, self.push, self.parent,
                   threading.get_ident(), self.start_ns, self.end_ns))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < SPAN_CAP:
            _spans.append(rec)
        else:
            _dropped += 1


def enable(on: bool = True) -> bool:
    """Turn spans and counters on or off for the whole process; returns
    whether they were on."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


def span(name: str, push: int | None = None):
    """Context manager around one stage of the program: a recorded span
    while spans are on, else the shared null context."""
    if not _on:
        return _NULL
    return _Span(name, push, True)


def timed(name: str) -> _Span:
    """A span that reads the clock whether spans are on or not, for a
    stage the program also times for itself (`.seconds` once it closes):
    the stage is timed once for both."""
    return _Span(name, None, _on)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while spans are on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def drain() -> Drained:
    """The spans and counters kept so far, which are cleared."""
    global _spans, _counters, _dropped
    with _lock:
        out = Drained(_spans, _counters, _dropped)
        _spans, _counters, _dropped = [], {}, 0
    return out


def summary(spans: list[Span]) -> dict[str, dict]:
    """By span name: calls, total and mean host ms, and self ms (the total
    less the time of the spans opened inside them)."""
    inner: dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
    out: dict[str, dict] = {}
    for s in spans:
        d = out.setdefault(s.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
        ns = s.end_ns - s.start_ns
        d["calls"] += 1
        d["ms"] += ns / 1e6
        d["self_ms"] += (ns - inner.get(s.id, 0)) / 1e6
    for d in out.values():
        d["mean_ms"] = d["ms"] / d["calls"]
    return out
