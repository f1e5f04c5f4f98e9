"""Where a step's time goes, for each path that chip_smoke.py drives.

    python3 profile_paths.py [--out chiprun_out/profile_paths.json]

Needs one CUDA card and this checkout; imports no JAX.  Builds each cell
with chip_smoke.py's shapes and inputs -- the headline stream, the stream
at BASELINE configs 1-3 (chip_smoke.py phase 13's blocks: BPSK, fft 256
QPSK with CFO 1.3, 16-QAM over multipath with soft output), the config-4
wideband receiver, the spectrum probe, logpwrfft and waterfall, the
512-channel scan, the radio loopback (hard and soft), the sync metric on
the CFO-statistics captures, and through the flowgraph layer the headline
stream as a one-node grc spec, the DDC example (decimate_and_measure at
run_flowgraph's block of 2^15) and the power meter (2^22), and the
headline stream read from chip_smoke.py phase 11's i16c capture file
through FileStreamer and DeviceFeed (read again from its start at its end),
and phase 12's sharded cells on meshes that repeat the card (the headline
stream on 1x4, config 5 at 512 channels on 4x2: one card stepping through
the shards in turn, not a scaling figure) -- and measures, per push:

  wall ms      host clock over three windows of 10 pushes, each ended by
               torch.cuda.synchronize(), without the profiler (min-max)
  enqueue ms   host time spent inside those 10 push() calls (min-max)
  busy ms      the union of the device's kernel, copy and set intervals in
               a torch.profiler trace of 5 pushes after 3 warm-ups
  ops          device operations per push in that trace
  idle share   1 - busy / wall, for the fastest and slowest window
  top          device ms per push by operation name, largest first
  port         device ms per push of each of the port's own CUDA kernels
               (csrc/*.cu) that ran, by function name
  h2d ms       device ms per push of host-to-card copies in that trace
               (ingest: the feed's copy of each block's pinned planes)
  read ms      (ingest) host ms per block waiting for the reader thread's
               bytes, mean, min and max over the blocks read, the first
               of each pass over the file left out (FileStreamer.last_times)
  convert ms   (ingest) host ms per block converting i16c into the feed's
               pinned planes, the same blocks

Prints one line per cell and writes all of it as JSON to --out.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from tpu_ofdm_torch import grc
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.io import DeviceFeed
from tpu_ofdm_torch.modem.rx_stream import rx_stream_block
from tpu_ofdm_torch.ops.sync import schmidl_cox
from tpu_ofdm_torch.stream.executor import StreamExecutor

STEPS = 5                # profiled pushes per cell
CONFIG_CELLS = ("rx_stream_config1", "rx_stream_config2",
                "rx_stream_config3_soft")   # chip_smoke.BASELINES, in order
DDC_BLOCK = 1 << 15      # run_flowgraph's default block
# the port's kernels (csrc/*.cu), as the trace names them
PORT_KERNEL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")
PORT_KERNELS = {"sc_detect_l32_kernel", "sc_detect_seg_kernel",
                "sc_detect_kernel", "gather_kernel", "pfb_kernel",
                "psd_kernel", "psd_tile_kernel", "scan_kernel",
                "sc_metric_l32_kernel", "sc_metric_kernel"}


class Loopback:
    """One push of the radio cell: the radio takes a batch of PDUs and the
    air block, and its TX block goes through the channel to become the next
    push's air block (chip_smoke.py phase 8, at steady state)."""

    def __init__(self, dev, **options):
        self.radio = cs.radio_executor(dev, **options)
        self.chan = cs.radio_channel(dev)
        self.air = torch.zeros(cs.BLOCK, dtype=torch.complex64, device=dev)

    def push(self, tx_in):
        out = self.radio.push((tx_in, self.air))
        self.air = self.chan.push(out.tx.samples)
        return out


class SyncCell:
    """One push of the sync cell: schmidl_cox over the 4096 captures of
    chip_smoke.py phase 9 at 10 dB."""

    def push(self, r):
        return schmidl_cox(cs.HEADLINE.spec, r)


class LoopingCapture:
    """chip_smoke.py phase 11's capture as DeviceFeed's planar reader, read
    again from its start at its end; keeps each block's (read, convert)
    seconds but the first of each pass, which pays the reader's start."""

    def __init__(self, paths):
        self.paths = paths
        self.fs = cs.capture_streamer(paths)
        self.block = self.fs.block
        self.times = []
        self._first = True

    def read_into(self, re, im):
        n = self.fs.read_into(re, im)
        if n == 0:
            self.fs.close()
            self.fs = cs.capture_streamer(self.paths)
            self._first = True
            n = self.fs.read_into(re, im)
        if not self._first:
            self.times.append(self.fs.last_times)
        self._first = False
        return n

    def close(self):
        self.fs.close()


class IngestCell:
    """One push of the ingest cell: the next block that the DeviceFeed
    staged from the capture, through the headline receiver (chip_smoke.py
    phase 11's path); the block given to push() is ignored."""

    def __init__(self, dev, paths):
        self.ex = cs.ingest_executor(dev)
        self.source = LoopingCapture(paths)
        self.feed = DeviceFeed(self.source, depth=cs.INGEST_DEPTH, device=dev)
        self.blocks = iter(self.feed)

    def push(self, _):
        return self.ex.push(next(self.blocks))

    def close(self):
        self.feed.close()
        self.source.close()


def cells(dev):
    """(name, executor, block) for each cell, built one at a time."""
    sc = StreamConfig(block_size=cs.BLOCK, max_frames_per_block=cs.SLOTS)
    blocks, _ = cs.staged_blocks(cs.HEADLINE.spec, 1, dev)
    yield ("rx_stream_headline", StreamExecutor(
        rx_stream_block(cs.HEADLINE.spec, sc), cs.BLOCK, device=dev),
        blocks[0])
    for k, (name, bc) in enumerate(zip(CONFIG_CELLS, cs.BASELINES)):
        spec = bc.cfg.spec
        frame = cs.baseline_frame(bc, cs.baseline_payload(spec, k))
        block = cs.staged_blocks(spec, 1, dev, seed=30 + k, frame=frame)[0]
        yield (name, StreamExecutor(rx_stream_block(spec, sc,
                                                    output=bc.output),
                                    cs.BLOCK, device=dev), block[0])
        del block
    yield "wideband_config4", cs.wideband_executor(dev), \
        cs.wideband_capture(dev)
    block = cs.spectrum_blocks(dev)[0]
    for name, make in cs.SPECTRUM_PATHS.items():
        yield (f"spectrum_{name}",
               StreamExecutor(make(), cs.PSD_BLOCK, device=dev), block)
    yield ("scan512", StreamExecutor(cs.scanner(), cs.SCAN_BLOCK, device=dev),
           cs.scan_blocks(dev)[0])
    tx_in = cs.radio_traffic(cs.HEADLINE.spec, dev, seed=90)[0][0]
    yield "radio_loopback", Loopback(dev), tx_in
    yield ("radio_loopback_soft",
           Loopback(dev, equalizer="simpledfe", output="soft"), tx_in)
    spec = cs.HEADLINE.spec
    payload = torch.zeros(spec.max_payload_bytes - 4, dtype=torch.uint8)
    payload[:32] = torch.arange(32)
    frame = cs.tx_frame(spec, payload, 32)
    frame = frame.samples[: int(frame.n_samples)].numpy()
    yield "sync_cfo_stats", SyncCell(), cs.sync_captures(
        frame, spec.fft_len, spec.cp_len, 10.0, dev, seed=10)[0]
    yield ("graph_headline", StreamExecutor(
        grc.build(cs.HEADLINE_SPEC), cs.BLOCK, device=dev), blocks[0])
    yield ("graph_ddc", StreamExecutor(
        grc.load(str(cs.EXAMPLES / "decimate_and_measure.json")), DDC_BLOCK,
        device=dev), cs.tone(DDC_BLOCK, DDC_BLOCK // 4, DDC_BLOCK, dev))
    yield ("graph_power_meter", StreamExecutor(
        grc.build(cs.METER_SPEC), cs.PSD_BLOCK, device=dev),
        cs.spectrum_blocks(dev)[0])
    with tempfile.TemporaryDirectory() as d:
        paths = cs.write_capture(cs.HEADLINE.spec, dev, pathlib.Path(d))
        yield "ingest_headline", IngestCell(dev, paths), None
    yield ("sharded_headline_1x4", StreamExecutor(cs.sharded_rx_stream_block(
        cs.HEADLINE.spec, cs.make_mesh(1, cs.SHARD_T,
                                       devices=[dev] * cs.SHARD_T),
        1, cs.BLOCK // cs.SHARD_T, cs.SHARD_K), cs.BLOCK, device=dev),
        blocks[0:1])
    n_c, n_t = cs.C5_MESH
    yield ("sharded_wideband_config5", cs.c5_executor(
        cs.make_mesh(n_c, n_t, devices=[dev] * (n_c * n_t)), dev),
        cs.c5_capture(cs.WIDEBAND.spec, dev)[0].clone())


def host_windows(ex, x, n=10, windows=3):
    """[(wall ms/push, enqueue ms/push)] over `windows` runs of n pushes."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ex.push(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.append(((t2 - t0) / n * 1e3, (t1 - t0) / n * 1e3))
    return out


def device_profile(ex, x):
    """(busy ms/push, ops/push, {op name: ms/push} of the largest, {port
    kernel: ms/push}, host-to-card copy ms/push) from a torch.profiler
    trace of STEPS pushes."""
    for _ in range(3):
        ex.push(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            ex.push(x)
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = cs.busy_union((e.time_range.start, e.time_range.end)
                         for e in evs)  # in us
    by_name = collections.Counter()
    for e in evs:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    top = {k: v / STEPS for k, v in by_name.most_common(8)}
    port = collections.Counter()
    for name, ms in by_name.items():
        m = PORT_KERNEL.match(name)
        if m and m.group(1) in PORT_KERNELS:
            port[m.group(1)] += ms / STEPS
    h2d = sum(ms for name, ms in by_name.items()
              if name.startswith("Memcpy HtoD"))
    return busy / 1e3 / STEPS, len(evs) / STEPS, top, dict(port), h2d / STEPS


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_paths.json")
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    rows = {}
    for name, ex, x in cells(dev):
        ex.push(x)                                  # warm-up
        host = host_windows(ex, x)
        busy, ops, top, port, h2d = device_profile(ex, x)
        walls = [w for w, _ in host]
        row = {
            "wall_ms": [min(walls), max(walls)],
            "enqueue_ms": [min(e for _, e in host), max(e for _, e in host)],
            "busy_ms": busy, "ops": ops,
            "idle_share": [1 - busy / min(walls), 1 - busy / max(walls)],
            "top_ms": top, "port_ms": port, "h2d_ms": h2d,
        }
        if isinstance(ex, IngestCell):
            ex.close()
            for k, i in (("read_ms", 0), ("convert_ms", 1)):
                ms = [1e3 * t[i] for t in ex.source.times]
                row[k] = [sum(ms) / len(ms), min(ms), max(ms)]
            row["blocks_read"] = len(ex.source.times)
        rows[name] = row
        print(f"{name}: wall {row['wall_ms']} ms, enqueue "
              f"{row['enqueue_ms']} ms, busy {busy:.4f} ms, {ops:g} ops, "
              f"idle {row['idle_share']}; top "
              + ", ".join(f"{k[:48]} {v:.4f}" for k, v in top.items())
              + "; port " + ", ".join(f"{k} {v:.4f}" for k, v in port.items())
              + f"; h2d {h2d:.4f} ms"
              + (f"; read {row['read_ms']} ms, convert {row['convert_ms']} "
                 f"ms a block (mean, min, max of {row['blocks_read']})"
                 if "read_ms" in row else ""),
              flush=True)
        del ex, x
        torch.cuda.empty_cache()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"device": smi, "steps": STEPS,
                               "cells": rows}, indent=1))
    print(smi)


if __name__ == "__main__":
    main()
