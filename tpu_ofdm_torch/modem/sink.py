"""The receivers' sink, on the host: reads each step's frame slots back
from the device and unpacks the valid ones into frame dicts.  Every
receiver's public sink calls it with the keys of its dicts and where its
buffers start: rx_stream.collect_frames, wideband.collect_wideband_frames,
shard.rx's collect_sharded_frames and collect_sharded_stream_frames.
Spans "sink.wait", "sink.copy" and "sink.unpack" a step; counters
"rx.frames" and "rx.int_cfo" (frames with a nonzero integer CFO)."""

from __future__ import annotations

import numpy as np
import torch

from tpu_ofdm_torch.utils import metrics

# the RxBlockResult.frames fields a dict may carry, in the order they are
# read back; payload_len is read with every step, to cut the payload
FRAME_FIELDS = ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok",
                "evm", "int_cfo")
_TYPE = {"frame_num": int, "crc_ok": bool, "hdr_ok": bool, "evm": float,
         "int_cfo": int, "fine_cfo": float}


def sink_wait(index: torch.Tensor) -> int:
    """A step's index, read first where spans are on, as the span
    "sink.wait": its readback waits for everything queued on the stream
    before it, as a sink's first copy does, so the copies after it are
    timed apart from the wait."""
    with metrics.span("sink.wait") as wait:
        wait.push = step = int(index)
    return step


def collect(steps, keys: tuple[str, ...], zero) -> list[dict]:
    """One dict a valid slot, in step order and row-major over a step's
    leading axes, (slots,) or (channel rows, slots).

    steps: (result, index, origin) a step: its RxBlockResult; its () int
    step index on the device, or None; origin = (first channel, first
    time shard, time shards held), ints or an int tensor.  `valid` is read
    first: a step without a valid slot reads nothing more.
    keys: the dicts' keys in order, of FRAME_FIELDS, "fine_cfo",
    "channel", "abs_start" and "llr" (the LLRs of the wire bytes, payload
    and CRC32; left out where the receiver's output is hard).
    zero(step, t): the absolute sample index of position 0 of time shard
    t's buffer at that step index; abs_start = zero + the slot's start."""
    frames = []
    traced = metrics.enabled()
    for res, index, origin in steps:
        step = sink_wait(index) if traced and index is not None else None
        with metrics.span("sink.copy", push=step):
            valid = res.valid.cpu().numpy()
            if not valid.any():
                continue
            if step is None and index is not None:
                step = int(index)
            if isinstance(origin, torch.Tensor):
                origin = origin.cpu()
            c0, t0, n_held = (int(v) for v in origin)
            f = res.frames
            host = {name: getattr(f, name).cpu().numpy()
                    for name in FRAME_FIELDS
                    if name in keys or name == "payload_len"}
            host["starts"] = res.starts.cpu().numpy()
            if "fine_cfo" in keys:
                host["fine_cfo"] = res.fine_cfo.cpu().numpy()
            if "llr" in keys and f.llr.shape[-1]:
                host["llr"] = f.llr.cpu().numpy()
        with metrics.span("sink.unpack", push=step):
            at = np.nonzero(valid)
            metrics.count("rx.frames", len(at[0]))
            if traced and "int_cfo" in keys:
                metrics.count("rx.int_cfo",
                              int(np.count_nonzero(host["int_cfo"][at])))
            K = valid.shape[-1] // n_held
            zeros = [zero(step, t0 + t) for t in range(n_held)]
            plen = [int(n) for n in host["payload_len"][at]]
            cols = {"payload": [bytes(p[:n]) for p, n in
                                zip(host["payload"][at], plen)],
                    "payload_len": plen}
            for key in keys:
                if key == "channel":
                    cols[key] = [c0 + int(c) for c in at[0]]
                elif key == "abs_start":
                    cols[key] = [zeros[int(j) // K] + int(s) for j, s in
                                 zip(at[-1], host["starts"][at])]
                elif key == "llr" and key in host:
                    cols[key] = [v[:(n + 4) * 8] for v, n in
                                 zip(host["llr"][at], plen)]
                elif key in _TYPE:
                    cols[key] = [_TYPE[key](v) for v in host[key][at]]
            names = [key for key in keys if key in cols]
            frames += [dict(zip(names, row))
                       for row in zip(*(cols[key] for key in names))]
    return frames
