"""The receivers' sink, on the host: reads each step's frame slots back
from the device and unpacks the valid ones into frame dicts.  Every
receiver's public sink calls it with the keys of its dicts and where its
buffers start: rx_stream.collect_frames, wideband.collect_wideband_frames,
shard.rx's collect_sharded_frames and collect_sharded_stream_frames.
Spans "sink.wait", "sink.copy" and "sink.unpack" a step; counters
"rx.frames", "rx.int_cfo" (frames with a nonzero integer CFO),
"sink.packed" (steps read back in one copy), "sink.side" (of those, steps
read back on the readback stream after their own event) and "sink.fields"
(steps read back field by field)."""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from tpu_ofdm_torch.modem import rx
from tpu_ofdm_torch.utils import metrics

# the RxBlockResult.frames fields a dict may carry; payload_len is read
# with every step, to cut the payload
FRAME_FIELDS = ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok",
                "evm", "int_cfo")


def sink_wait(index: torch.Tensor) -> int:
    """A step's index, read first where spans are on, as the span
    "sink.wait": its readback waits for everything queued on the stream
    before it, as a sink's first copy does, so the copies after it are
    timed apart from the wait."""
    with metrics.span("sink.wait") as wait:
        wait.push = step = int(index)
    return step


def _fields(res, keys: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """The tensors of a step that its dicts read, by name: valid, the
    frame fields among `keys` and payload_len, starts, and fine_cfo and
    llr where `keys` name them (llr where the output is soft)."""
    f = res.frames
    out = {"valid": res.valid}
    out.update((name, getattr(f, name)) for name in FRAME_FIELDS
               if name in keys or name == "payload_len")
    out["starts"] = res.starts
    if "fine_cfo" in keys:
        out["fine_cfo"] = res.fine_cfo
    if "llr" in keys and f.llr.shape[-1]:
        out["llr"] = f.llr
    return out


@functools.cache
def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _record(fields: dict[str, torch.Tensor]):
    """(record, offsets): the one span of bytes the fields cover, as a
    flat uint8 tensor, where they are all views of one storage (a replayed
    step's output record, modem/rx.py _Layout), and each field's byte
    offset in it; else None."""
    ts = fields.values()
    if (len({t.untyped_storage().data_ptr() for t in ts}) != 1
            or not all(t.numel() for t in ts)):
        return None
    span = {name: (t.storage_offset() * t.element_size(), t.element_size()
                   * (1 + sum((n - 1) * s
                              for n, s in zip(t.shape, t.stride()))))
            for name, t in fields.items()}
    lo = min(at for at, _ in span.values())
    hi = max(at + n for at, n in span.values())
    valid = fields["valid"]
    record = torch.empty(0, dtype=torch.uint8, device=valid.device).set_(
        valid.untyped_storage(), lo, (hi - lo,))
    return record, {name: at - lo for name, (at, _) in span.items()}


def _views(fields: dict[str, torch.Tensor], buf: np.ndarray,
           at: dict[str, int]) -> dict[str, np.ndarray]:
    """The fields as numpy views of their record's bytes on the host."""
    return {name: np.ndarray(t.shape, _np_dtype(t.dtype), buf, at[name],
                             [s * t.element_size() for s in t.stride()])
            for name, t in fields.items()}


def _read_side(mark, record: torch.Tensor, index, traced: bool):
    """(host record, step index) of a replayed step, read back on the
    readback stream after the step's own event (`mark`, modem/rx.py
    step_mark): the host waits for that step, not for the pushes queued
    after it.  The span "sink.wait" times the copies' launch and the wait
    on them; counter "sink.side"."""
    calls, event = mark
    with metrics.span("sink.wait") as wait:
        rec, host_index, done = calls.read(event, record, index)
        done.synchronize()
        step = None if index is None else int(host_index)
        if traced:
            wait.push = step
    metrics.count("sink.side")
    return rec, step


def collect(steps, keys: tuple[str, ...], zero) -> list[dict]:
    """One dict a valid slot, in step order and row-major over a step's
    leading axes, (slots,) or (channel rows, slots).

    steps: (result, index, origin) a step: its RxBlockResult; its () int
    step index on the device, or None; origin = (first channel, first
    time shard, time shards held), ints or an int tensor.  A step whose
    fields are views of one storage is read back in one copy: a replayed
    step's (modem/rx.py step_mark) with its index, on the readback stream
    once the step's own event has passed, so the index has to be ready by
    the end of the step, as a receiver's carried step index is; any other
    step's on the current stream.  Any other step is read field by field,
    `valid` first: a step without a valid slot then reads nothing more.
    keys: the dicts' keys in order, of FRAME_FIELDS, "fine_cfo",
    "channel", "abs_start" and "llr" (the LLRs of the wire bytes, payload
    and CRC32; left out where the receiver's output is hard).
    zero(step, t): the absolute sample index of position 0 of time shard
    t's buffer at that step index; abs_start = zero + the slot's start."""
    frames = []
    traced = metrics.enabled()
    for res, index, origin in steps:
        fields = _fields(res, keys)
        packed = _record(fields)
        mark = None if packed is None else rx.step_mark(packed[0])
        if mark is not None:
            rec, step = _read_side(mark, packed[0], index, traced)
        else:
            step = sink_wait(index) if traced and index is not None else None
        with metrics.span("sink.copy", push=step):
            if packed is None:
                metrics.count("sink.fields")
                host = {"valid": res.valid.cpu().numpy()}
                if host["valid"].any():
                    host.update((name, t.cpu().numpy())
                                for name, t in fields.items()
                                if name != "valid")
            else:
                metrics.count("sink.packed")
                if mark is None:
                    rec = packed[0].cpu()
                host = _views(fields, rec.numpy(), packed[1])
            valid = host.pop("valid")
            if not valid.any():
                continue
            if step is None and index is not None:
                step = int(index)
            if isinstance(origin, torch.Tensor):
                origin = origin.cpu()
            c0, t0, n_held = (int(v) for v in origin)
        with metrics.span("sink.unpack", push=step):
            at = np.nonzero(valid)
            metrics.count("rx.frames", len(at[0]))
            host = {name: a[at] for name, a in host.items()}
            if traced and "int_cfo" in keys:
                metrics.count("rx.int_cfo",
                              int(np.count_nonzero(host["int_cfo"])))
            plen = host["payload_len"].tolist()
            wire = host["payload"]
            blob = wire.tobytes()
            cols = {"payload": [blob[o:o + n] for o, n in
                                zip(itertools.count(0, wire.shape[-1]),
                                    plen)],
                    "payload_len": plen}
            for key in keys:
                if key == "channel":
                    cols[key] = (c0 + at[0]).tolist()
                elif key == "abs_start":
                    K = valid.shape[-1] // n_held
                    zeros = np.array([zero(step, t0 + t)
                                      for t in range(n_held)], np.int64)
                    cols[key] = (zeros[at[-1] // K]
                                 + host["starts"]).tolist()
                elif key == "llr":
                    if key in host:
                        cols[key] = [v[:(n + 4) * 8] for v, n in
                                     zip(host[key], plen)]
                elif key not in cols:
                    cols[key] = host[key].tolist()
            out = [{} for _ in plen]
            for key in keys:
                for frame, v in zip(out, cols.get(key, ())):
                    frame[key] = v
            frames += out
    return frames
