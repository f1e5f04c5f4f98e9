"""The harness's host spans, and the traced stretch: a torch.profiler trace
of a few pushes, reduced to device busy time, time by operation name,
time by stage and idle gaps.

The busy-interval union follows chip_smoke.py's `busy_union`, and the
per-name sums profile_paths.py's `device_profile`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time


class Spans:
    """Host-clock spans of the harness's calls into the program, by name;
    inside a profiled stretch each is also a profiler range "pb.<name>"."""

    def __init__(self):
        self.times: dict[str, list[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            import torch

            rf = torch.profiler.record_function("pb." + name)
        else:
            rf = contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            yield
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_union(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(spans))


def idle_gaps(device, host, n: int = 10) -> list[list]:
    """The n longest gaps between device-busy intervals, each named by the
    harness's host span open at its middle ("other" where none is);
    [[name, seconds], ...] with times in microseconds in and seconds out."""
    busy = merged((a, b) for _, a, b in device)
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        name = next((nm for nm, a, b in host if a <= mid <= b), "other")
        gaps.append([name, (s1 - e0) / 1e6])
    return sorted(gaps, key=lambda g: -g[1])[:n]


@dataclasses.dataclass
class Trace:
    """Device events (name, start us, end us) and the harness's host spans
    of a stretch of `pushes` pushes that took `wall_s` on the host clock."""
    device: list
    host: list
    pushes: int
    wall_s: float

    @property
    def busy_s(self) -> float:
        return busy_union((a, b) for _, a, b in self.device) / 1e6

    def seconds(self, pattern: str) -> float | None:
        """Device seconds of the operations whose name matches `pattern`
        (a regular expression searched for); None where none ran."""
        rx = re.compile(pattern)
        hit = [(b - a) for name, a, b in self.device if rx.search(name)]
        return sum(hit) / 1e6 if hit else None

    def stage_seconds(self, first: str, until: str) -> float | None:
        """Device seconds of the operations from one whose name matches
        `first` up to, not including, the next one whose name matches
        `until` (regular expressions searched for), in the order the
        device ran them, summed over the stretch; None where no such
        stretch closed."""
        a, b = re.compile(first), re.compile(until)
        total, stage, closed = 0.0, None, False
        for name, s, e in sorted(self.device, key=lambda d: d[1]):
            if a.search(name):
                stage = 0.0 if stage is None else stage
            elif stage is not None and b.search(name):
                total, stage, closed = total + stage, None, True
            if stage is not None:
                stage += e - s
        return total / 1e6 if closed else None

    def top_ops(self, n: int = 10) -> list[list]:
        by = collections.Counter()
        for name, a, b in self.device:
            by[name[:160]] += (b - a) / 1e6
        return [[k, v] for k, v in by.most_common(n)]


def from_profiler(prof, pushes: int, wall_s: float) -> Trace:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith("pb."):
            # the harness's ranges; the profiler also mirrors each onto the
            # device's timeline, where it is no operation
            if e.device_type != DeviceType.CUDA:
                host.append((e.name[3:], span[1], span[2]))
        elif e.device_type == DeviceType.CUDA:
            dev.append(span)
    return Trace(dev, host, pushes, wall_s)
