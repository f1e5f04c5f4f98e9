"""The step budget of the benchmark's cells by the program's own spans and
counters (tpu_ofdm_torch.utils.metrics), on one CUDA card.

    python3 span_budget.py [--cells rx64_dense,...] [--seed N] \
        [--cost-cells rx64_dense,...] --out <file.json>

From the root of a checkout.  For each cell of BENCHMARK.json, through
portbench's own set-up, paths and closed loop:

  window    10 s, spans off: the harness's host ms a push in each of its
            spans (push, collect, feed, air), as its window reads them;
  spanned   3 s, spans on, the profiler off: each program span's host ms a push
            (all its calls in the stretch over its pushes) and self ms a
            push, the counters, and slot_use = 100 * rx.frames / rx.slots;
  traced    spans on under torch.profiler: the card's busy ms a push, the
            loop's host ms a push outside the harness's spans, and the
            card's idle gaps, each named "<harness span>/<innermost program
            span>" open at its middle on the loop's thread ("<harness
            span>" where none is) and, apart, the feed worker's innermost
            span there.  The profiler records only the thread that started
            it, so the worker's spans are put on its clock by the offset
            between the loop thread's span records and their ranges.

With --cost-cells, each of those cells then alternates 3-s stretches with
spans off and on, ten of each, and gives
the harness's push + collect host ms a push on each side: the median and
quartiles (statistics.quantiles).  Every pushed block is tallied as the
benchmark tallies it (`pushes_wrong`).  Writes one JSON object to --out and
a line a cell to standard output.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cells, check, harness, tracing  # noqa: E402
from tpu_ofdm_torch.utils import metrics  # noqa: E402

HARNESS_SPANS = ("push", "collect", "feed", "air")
WINDOW_S, SPANNED_S, COST_PAIRS = 10.0, 3.0, 10


def stretch(loop, seconds: float) -> dict:
    """One stretch of the closed loop; the harness's host ms a push."""
    spans = loop.path.spans
    spans.times.clear()
    n, wall = loop.run(until=time.perf_counter() + seconds)
    harness.sync(loop.path.dev)
    out = {"pushes": n, "wall_s": wall}
    for name in HARNESS_SPANS:
        t = spans.times.get(name)
        if t:
            out[f"{name}_ms"] = sum(t) / n * 1e3
    return out


def budget(spans, counters: dict, pushes: int) -> dict:
    """Each program span's calls and host ms a push (total and self)."""
    out = {name: {"calls": d["calls"], "ms": d["ms"] / pushes,
                  "self_ms": d["self_ms"] / pushes}
           for name, d in sorted(metrics.summary(spans).items())}
    slots, frames = counters.get("rx.slots"), counters.get("rx.frames")
    return {"spans": out, "counters": dict(counters),
            "slot_use": 100.0 * frames / slots if slots else None}


def innermost(ranges, t: float):
    """The name of the latest-opened range holding t, or None."""
    best = None
    for name, a, b in ranges:
        if a <= t <= b and (best is None or a > best[1]):
            best = (name, a)
    return best and best[0]


def match(records, ranges) -> tuple[float | None, list]:
    """The loop thread's span records against their profiler ranges, in
    order by name: (profiler microseconds less perf_counter_ns / 1000, the
    median over the pairs; the ranges that executor.push opened, as (start,
    push number))."""
    recs = sorted(records, key=lambda s: s.start_ns)
    rngs = sorted(ranges, key=lambda r: r[1])
    pairs = [(r, a) for r, (name, a, _) in zip(recs, rngs) if r.name == name]
    if not pairs:
        return None, []
    off = statistics.median(a - r.start_ns / 1e3 for r, a in pairs)
    return off, [(a, r.push) for r, a in pairs if r.name == "executor.push"]


def label(host, program, t: float) -> str:
    """"<harness span>/<innermost program span>" open at t."""
    name = innermost(host, t) or "other"
    prog = innermost(program, t)
    return name if prog is None else name + "/" + prog


def label_gaps(device, host, program, worker, pushes,
               n: int = 10) -> dict:
    """The n longest device idle gaps, named at their middles by the
    harness's span and the loop thread's innermost program span, with the
    names at their two ends, the worker's span at the middle and the last
    push begun before the card resumed; and the idle seconds by name over
    the stretch."""
    busy = tracing.merged((a, b) for _, a, b in device)
    gaps, by_label = [], {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        at = label(host, program, mid)
        push = max((p for p in pushes if p[0] <= s1), default=(0, None))[1]
        gaps.append({"label": at, "s": (s1 - e0) / 1e6,
                     "from": label(host, program, e0),
                     "to": label(host, program, s1),
                     "worker": innermost(worker, mid), "last_push": push})
        by_label[at] = by_label.get(at, 0.0) + (s1 - e0) / 1e6
    gaps.sort(key=lambda g: -g["s"])
    return {"longest": gaps[:n],
            "idle_s_by_label": dict(sorted(by_label.items(),
                                           key=lambda kv: -kv[1]))}


def traced(loop, pushes: int) -> dict:
    """`pushes` pushes with spans on under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = loop.path.spans
    saved = {k: list(v) for k, v in spans.times.items()}
    metrics.drain()
    metrics.enable(True)
    spans.profiling = True
    acts = [ProfilerActivity.CPU]
    if loop.path.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=acts) as prof:
            n, wall = loop.run(pushes=pushes)
            harness.sync(loop.path.dev)
    finally:
        spans.profiling = False
        metrics.enable(False)
        spans.times = saved
    got = metrics.drain()
    device, host, program = [], [], []
    prefix = metrics.PROFILER_PREFIX
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        on_card = e.device_type == DeviceType.CUDA
        if e.name.startswith("pb."):
            if not on_card:
                host.append((e.name[3:], *rng))
        elif e.name.startswith(prefix):
            if not on_card:
                program.append((e.name[len(prefix):], *rng))
        elif on_card:
            device.append((e.name, *rng))
    me = threading.get_ident()
    off, pushes = match([s for s in got.spans if s.thread == me], program)
    worker = [] if off is None else [
        (s.name, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
        for s in got.spans if s.thread != me]
    trace = tracing.Trace(device, host, n, wall)
    spanned = tracing.busy_union((a, b) for _, a, b in host) / 1e3
    return {"pushes": n, "busy_ms": trace.busy_s / n * 1e3,
            "outside_harness_spans_ms": (wall * 1e3 - spanned) / n,
            "program_ranges": len(program), "span_records": len(got.spans),
            "worker_spans_placed": len(worker),
            "gaps": label_gaps(device, host, program, worker, pushes)}


def quartiles(xs: list[float]) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"median": q[1], "q1": q[0], "q3": q[2], "runs": xs}


def cost(loop, pairs: int, seconds: float) -> dict:
    """Stretches with spans off and on in turns (the first of each pair
    alternating); the harness's push + collect ms a push of each."""
    sides: dict[str, list[float]] = {"off": [], "on": []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            metrics.enable(on)
            try:
                s = stretch(loop, seconds)
            finally:
                metrics.enable(False)
                metrics.drain()
            sides["on" if on else "off"].append(
                s.get("push_ms", 0.0) + s.get("collect_ms", 0.0))
    return {k: quartiles(v) for k, v in sides.items()}


def run_cell(cell: cells.Cell, seed: int, device="cuda", window=WINDOW_S,
             spanned=SPANNED_S, cost_pairs=0) -> dict:
    """One cell: set-up, the window, the spanned and traced stretches and,
    with cost_pairs, the stretches with spans off and on in turns."""
    t0 = time.perf_counter()
    path, loop = harness.setup(cell, seed, device)
    out = {"cell": cell.name, "setup_s": time.perf_counter() - t0}
    try:
        out["window"] = stretch(loop, window)
        metrics.drain()
        metrics.enable(True)
        try:
            sp = stretch(loop, spanned)
        finally:
            metrics.enable(False)
        got = metrics.drain()
        out["spanned"] = {**sp, **budget(got.spans, got.counters,
                                         sp["pushes"]),
                          "dropped": got.dropped}
        out["traced"] = traced(loop, cell.traffic["trace_pushes"])
        if cost_pairs:
            out["cost"] = cost(loop, cost_pairs, spanned)
        out["pushes_wrong"] = check.pushes_wrong(path, loop.tallies)
        out["pushes"] = len(loop.tallies)
    finally:
        path.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="rx64_dense,wideband64_3ch,"
                    "rx64_file_i16c,radio64_duplex")
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--cost-cells", default="")
    ap.add_argument("--out", required=True, help="the JSON result")
    args = ap.parse_args(argv)
    cost_cells = set(args.cost_cells.split(","))
    if not torch.cuda.is_available():
        print("span_budget: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    result = {"device": harness.device_info(dev), "seed": args.seed,
              "cells": []}
    for i, name in enumerate(filter(None, args.cells.split(","))):
        r = run_cell(cells.cell(name), args.seed + i,
                     cost_pairs=COST_PAIRS if name in cost_cells else 0)
        result["cells"].append(r)
        sp = r["spanned"]
        print(json.dumps({
            "cell": name, "pushes_wrong": r["pushes_wrong"],
            "window": {k: round(v, 4) for k, v in r["window"].items()},
            "spanned_ms": {k: round(v["ms"], 4)
                           for k, v in sp["spans"].items()},
            "slot_use": sp["slot_use"],
            "gaps": [[g["label"], g["s"], g["worker"]]
                     for g in r["traced"]["gaps"]["longest"][:4]]}),
            flush=True)
        torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0 if all(r["pushes_wrong"] == 0 for r in result["cells"]) else 1


if __name__ == "__main__":
    sys.exit(main())
