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

`Ewma`, `PerfCounters` and `LinkMetrics` are copies of the JAX module's.
No RPC layer: metrics are plain dataclasses the caller logs/serializes.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

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
    chrome://tracing).  It replaces the JAX module's jax.profiler trace."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
