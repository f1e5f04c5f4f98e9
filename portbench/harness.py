"""One run of one cell: set-up, the measured window, the traced stretch,
the check, and the result line.

The window is a closed loop, as a receiver replaying a capture as fast as
the card takes it: each push starts as soon as the one before it returns,
and a block's frames are copied to the host (through the program's own
sink) once the next block's push is enqueued, so one block is in flight.
A block's latency runs from the start of its push to the moment its
frames are on the host; the window ends when the last block's are.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import numpy as np
import torch

from portbench import cells, check, tracing


class Reservoir:
    """A seeded uniform sample of k pushes of the window (Algorithm R):
    what the check judges frame by frame."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = k, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = item
        self.seen += 1


@dataclasses.dataclass
class Loop:
    """The closed loop over a path; every push's frame tally and latency
    is recorded."""
    path: object
    step: int = 0
    tallies: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)

    def run(self, until=None, pushes=None, keep=None) -> tuple[int, float]:
        """Push until `until` (a perf_counter time) or for `pushes`
        pushes; returns (pushes, seconds to the last block's frames)."""
        prev = None
        t0 = time.perf_counter()
        n = 0
        while True:
            now = time.perf_counter()
            if (pushes is not None and n >= pushes) or \
                    (until is not None and now >= until):
                break
            out = self.path.push(self.step)
            if prev is not None:
                self._finish(prev, keep)
            prev = (self.step, out, now)
            self.step += 1
            n += 1
        if prev is not None:
            self._finish(prev, keep)
        return n, time.perf_counter() - t0

    def _finish(self, item, keep) -> None:
        step, out, started = item
        frames = self.path.collect(out)
        self.latencies.append(time.perf_counter() - started)
        self.tallies.append((step, len(frames),
                             sum(not f["crc_ok"] for f in frames)))
        if keep is not None:
            keep.offer((step, out, frames))


@dataclasses.dataclass
class Ctx:
    """What a metric's reader reads."""
    path: object
    spans: dict            # name -> host seconds of each call in the window
    pushes: int            # pushes in the window
    wall_s: float          # the window's wall time
    latencies: list        # each block's seconds, push start to frames
    setup_s: float
    trace: tracing.Trace | None = None
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def samples(self) -> int:
        return self.pushes * self.path.samples_per_push


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index}"],
        capture_output=True, text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "power_limit": smi.stdout.strip() or smi.stderr.strip()}


def setup(cell: cells.Cell, seed: int, device) -> tuple[object, Loop]:
    """Build the cell's path and warm every shape it uses: warm_rounds
    passes over the staged blocks through the same loop as the window."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device()
                           if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    spans = tracing.Spans()
    path = cells.path_class(cell.traffic["path"])(cell.config, cell.traffic,
                                                  seed, dev, spans)
    path.setup()
    loop = getattr(path, "loop", Loop)(path)
    loop.run(pushes=cell.traffic["warm_rounds"] * cell.traffic["blocks"])
    sync(path.dev)
    spans.times.clear()
    loop.tallies.clear()
    loop.latencies.clear()
    return path, loop


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """One run; returns the result line (a dict)."""
    t_start = time.perf_counter() if t_start is None else t_start
    path, loop = setup(cell, seed, device)
    dev = path.dev
    try:
        keep = Reservoir(cell.traffic["kept_pushes"], seed)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        source = getattr(path, "source", None)
        n_conv = len(source.times) if source is not None else 0
        pushes, wall = loop.run(until=t0 + seconds, keep=keep)
        ctx = Ctx(path, {k: list(v) for k, v in path.spans.times.items()},
                  pushes, wall, list(loop.latencies), setup_s)
        if source is not None:
            ctx.counters["convert"] = source.times[n_conv:]
        if trace:
            ctx.trace = traced_stretch(loop, cell.traffic["trace_pushes"])
        info = device_info(dev)
        numbers = check.judge(path, keep.kept, loop.tallies)
        del keep
    finally:
        path.close()
    correct = check.verdict(numbers, cell.limits)
    metrics = {}
    kind = "metrics" if trace else "end_to_end"
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.reader(kind, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(loop.tallies),
              "failed": check.pushes_wrong(path, loop.tallies),
              "metrics": metrics, "device": info}
    if trace and ctx.trace is not None:
        info["busy_s"] = ctx.trace.busy_s
        info["window_s"] = ctx.trace.wall_s
        result["breakdown"] = {
            "device_ops": ctx.trace.top_ops(),
            "idle_gaps": tracing.idle_gaps(ctx.trace.device, ctx.trace.host)}
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                        for k, v in numbers.items()}
    return result


def traced_stretch(loop: Loop, pushes: int) -> tracing.Trace:
    """`pushes` more pushes of the same loop under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if loop.path.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans = loop.path.spans
    saved = {k: list(v) for k, v in spans.times.items()}
    spans.profiling = True
    try:
        with profile(activities=acts) as prof:
            n, wall = loop.run(pushes=pushes)
            sync(loop.path.dev)
    finally:
        spans.profiling = False
        spans.times = saved
    return tracing.from_profiler(prof, n, wall)
