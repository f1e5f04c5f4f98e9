"""The receivers' host sink (tpu_ofdm_torch/modem/sink.py) through its four
public callers, on hand-built step outputs on the CPU: collect_frames (hard,
soft, and without block_size), collect_wideband_frames,
collect_sharded_frames and collect_sharded_stream_frames (the local
communicator's whole chunk, out of order, and one dist rank's shard).
Valid slots are scattered over channels and time shards, and a step with
no valid slot reports nothing.  Each sink's frames are compared with a
literal list: the keys and their order, each value's type and value, and
the order of the frames.  With spans on, the sharded sinks record the
sink's spans and counter as the others do.  The same steps packed as a
replayed step's are (each result views of one byte buffer, through
modem/rx.py's _Layout) give the same dicts from one readback a step."""

import numpy as np
import pytest
import torch

from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem.rx import FrameResult, RxBlockResult
from tpu_ofdm_torch.modem.rx_stream import RxStreamOut, collect_frames
from tpu_ofdm_torch.modem.wideband import (WidebandRxOut,
                                           collect_wideband_frames)
from tpu_ofdm_torch.shard.rx import (ShardedStreamOut, collect_sharded_frames,
                                     collect_sharded_stream_frames)
from tpu_ofdm_torch.utils import metrics as tm

SPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
H = 3072                                  # history_len(SPEC)
P = 6                                     # payload bytes a slot
LLR = (P + 4) * 8                         # soft output: LLRs a slot
T = True
F = False


def _result(valid, seed, llr=0):
    """A step's RxBlockResult on the CPU, leading axes valid's shape; slot
    n (row-major) holds values made from n and seed, so a slot read at the
    wrong place shows."""
    valid = torch.as_tensor(valid)
    shape = tuple(valid.shape)
    n = torch.arange(valid.numel()).reshape(shape)

    def i32(t):
        return t.to(torch.int32)

    def f32(t):
        return t.to(torch.float32)

    frames = FrameResult(
        payload=((n[..., None] * P + torch.arange(P) + seed) % 256)
        .to(torch.uint8),
        payload_len=i32(1 + (n + seed) % (P - 1)),
        frame_num=i32(10 * seed + n),
        hdr_ok=n % 3 != 0,
        crc_ok=n % 2 == 0,
        evm=f32(n / 8 + seed),
        int_cfo=i32(n % 5 - 2),
        data_syms=torch.zeros(*shape, 0, dtype=torch.complex64),
        sym_mask=torch.zeros(*shape, 0, dtype=torch.bool),
        sync_q=f32(n),
        sync_ok=valid,
        llr=f32(100 * n[..., None] + torch.arange(llr) / 2),
    )
    return RxBlockResult(frames, i32(37 * n + seed), f32(-n / 16), valid)


def _index(i):
    return torch.tensor(i, dtype=torch.int32)


def _rx_outs(llr=0):
    return [RxStreamOut(_result([F, T, F, T], 1, llr), _index(0)),
            RxStreamOut(_result([F, F, F, F], 2, llr), _index(1)),
            RxStreamOut(_result([T, F, F, F], 3, llr), _index(2))]


def _wideband_outs():
    return [WidebandRxOut(_result([[F, T], [F, F], [T, T]], 1), _index(0)),
            WidebandRxOut(_result([[F, F], [F, F], [F, F]], 2), _index(1)),
            WidebandRxOut(_result([[F, F], [T, F], [F, F]], 3), _index(2))]


def _sharded_capture():
    # two channel rows of a result over two time shards of K = 2 slots
    return _result([[F, T, T, F], [T, F, F, T]], 4)


def _sharded_stream_outs():
    # the local communicator's chunks (3 channels, T = 2 shards, K = 2),
    # handed over out of order, the last with no valid slot
    def origin():
        return torch.tensor([0, 0, 2], dtype=torch.int32)
    return [ShardedStreamOut(_result([[F, F, T, F], [T, F, F, F],
                                      [F, T, F, T]], 5), _index(1), origin()),
            ShardedStreamOut(_result([[T, F, F, T], [F, F, F, F],
                                      [F, F, T, F]], 6), _index(0), origin()),
            ShardedStreamOut(_result([[F] * 4] * 3, 7), _index(2), origin())]


def _rank_outs():
    # one dist rank's shard: channels 2..3, time shard 1 of 2, K = 3
    origin = torch.tensor([2, 1, 1], dtype=torch.int32)
    return [ShardedStreamOut(_result([[F, T, T], [T, F, F]], 8), _index(3),
                             origin),
            ShardedStreamOut(_result([[F, F, F], [F, T, F]], 9), _index(2),
                             origin)]


def _llr(n, plen):
    return np.float32(100 * n) + np.arange((plen + 4) * 8,
                                           dtype=np.float32) / 2


WANT = {
    "collect_frames_hard": (
        lambda: collect_frames(_rx_outs(), block_size=4096, hist=H),
        [{"payload": b"\x07\x08\x09", "payload_len": 3, "frame_num": 11,
          "crc_ok": False, "hdr_ok": True, "evm": 1.125, "int_cfo": -1,
          "fine_cfo": -0.0625, "abs_start": -3034},
         {"payload": b"\x13\x14\x15\x16\x17", "payload_len": 5,
          "frame_num": 13, "crc_ok": False, "hdr_ok": False, "evm": 1.375,
          "int_cfo": 1, "fine_cfo": -0.1875, "abs_start": -2960},
         {"payload": b"\x03\x04\x05\x06", "payload_len": 4, "frame_num": 30,
          "crc_ok": True, "hdr_ok": False, "evm": 3.0, "int_cfo": -2,
          "fine_cfo": 0.0, "abs_start": 5123}]),
    "collect_frames_soft": (
        lambda: collect_frames(_rx_outs(LLR), block_size=4096, hist=H),
        [{"payload": b"\x07\x08\x09", "payload_len": 3, "frame_num": 11,
          "crc_ok": False, "hdr_ok": True, "evm": 1.125, "int_cfo": -1,
          "fine_cfo": -0.0625, "abs_start": -3034, "llr": _llr(1, 3)},
         {"payload": b"\x13\x14\x15\x16\x17", "payload_len": 5,
          "frame_num": 13, "crc_ok": False, "hdr_ok": False, "evm": 1.375,
          "int_cfo": 1, "fine_cfo": -0.1875, "abs_start": -2960,
          "llr": _llr(3, 5)},
         {"payload": b"\x03\x04\x05\x06", "payload_len": 4, "frame_num": 30,
          "crc_ok": True, "hdr_ok": False, "evm": 3.0, "int_cfo": -2,
          "fine_cfo": 0.0, "abs_start": 5123, "llr": _llr(0, 4)}]),
    "collect_frames_no_block_size": (
        lambda: collect_frames(_rx_outs()),
        [{"payload": b"\x07\x08\x09", "payload_len": 3, "frame_num": 11,
          "crc_ok": False, "hdr_ok": True, "evm": 1.125, "int_cfo": -1,
          "fine_cfo": -0.0625, "abs_start": 38},
         {"payload": b"\x13\x14\x15\x16\x17", "payload_len": 5,
          "frame_num": 13, "crc_ok": False, "hdr_ok": False, "evm": 1.375,
          "int_cfo": 1, "fine_cfo": -0.1875, "abs_start": 112},
         {"payload": b"\x03\x04\x05\x06", "payload_len": 4, "frame_num": 30,
          "crc_ok": True, "hdr_ok": False, "evm": 3.0, "int_cfo": -2,
          "fine_cfo": 0.0, "abs_start": 3}]),
    "collect_wideband_frames": (
        lambda: collect_wideband_frames(_wideband_outs(), 1024, SPEC),
        [{"channel": 0, "payload": b"\x07\x08\x09", "frame_num": 11,
          "crc_ok": False, "evm": 1.125, "abs_start": -3034},
         {"channel": 2, "payload": b"\x19", "frame_num": 14, "crc_ok": True,
          "evm": 1.5, "abs_start": -2923},
         {"channel": 2, "payload": b"\x1f\x20", "frame_num": 15,
          "crc_ok": False, "evm": 1.625, "abs_start": -2886},
         {"channel": 1, "payload": b"\x0f", "frame_num": 32, "crc_ok": True,
          "evm": 3.25, "abs_start": -947}]),
    "collect_sharded_frames": (
        lambda: collect_sharded_frames(_sharded_capture(), 4096, SPEC, 2,
                                       origin=(2, 1)),
        [{"channel": 2, "payload": b"\x0a", "payload_len": 1,
          "frame_num": 41, "crc_ok": False, "evm": 4.125, "abs_start": 1065},
         {"channel": 2, "payload": b"\x10\x11", "payload_len": 2,
          "frame_num": 42, "crc_ok": True, "evm": 4.25, "abs_start": 5198},
         {"channel": 3, "payload": b"\x1c\x1d\x1e\x1f", "payload_len": 4,
          "frame_num": 44, "crc_ok": True, "evm": 4.5, "abs_start": 1176},
         {"channel": 3, "payload": b"\x2e\x2f", "payload_len": 2,
          "frame_num": 47, "crc_ok": False, "evm": 4.875,
          "abs_start": 5383}]),
    "collect_sharded_stream_frames": (
        lambda: collect_sharded_stream_frames(_sharded_stream_outs(), 4096,
                                              SPEC, 2),
        [{"channel": 0, "payload": b"\x06\x07", "payload_len": 2,
          "frame_num": 60, "crc_ok": True, "evm": 6.0, "abs_start": -3066},
         {"channel": 0, "payload": b"\x18\x19\x1a\x1b\x1c", "payload_len": 5,
          "frame_num": 63, "crc_ok": False, "evm": 6.375, "abs_start": 1141},
         {"channel": 0, "payload": b"\x11\x12\x13", "payload_len": 3,
          "frame_num": 52, "crc_ok": True, "evm": 5.25, "abs_start": 9295},
         {"channel": 1, "payload": b"\x1d\x1e\x1f\x20\x21", "payload_len": 5,
          "frame_num": 54, "crc_ok": True, "evm": 5.5, "abs_start": 5273},
         {"channel": 2, "payload": b"\x42\x43", "payload_len": 2,
          "frame_num": 70, "crc_ok": True, "evm": 7.25, "abs_start": 1400},
         {"channel": 2, "payload": b"\x3b\x3c\x3d\x3e\x3f", "payload_len": 5,
          "frame_num": 59, "crc_ok": False, "evm": 6.125, "abs_start": 5458},
         {"channel": 2, "payload": b"\x47\x48", "payload_len": 2,
          "frame_num": 61, "crc_ok": False, "evm": 6.375,
          "abs_start": 9628}]),
    "collect_sharded_stream_frames_rank": (
        lambda: collect_sharded_stream_frames(_rank_outs(), 4096, SPEC, 2),
        [{"channel": 2, "payload": b"\x0e\x0f\x10\x11\x12", "payload_len": 5,
          "frame_num": 81, "crc_ok": False, "evm": 8.125,
          "abs_start": 25645},
         {"channel": 2, "payload": b"\x14", "payload_len": 1,
          "frame_num": 82, "crc_ok": True, "evm": 8.25, "abs_start": 25682},
         {"channel": 3, "payload": b"\x21\x22\x23\x24", "payload_len": 4,
          "frame_num": 94, "crc_ok": True, "evm": 9.5, "abs_start": 17565},
         {"channel": 3, "payload": b"\x1a\x1b", "payload_len": 2,
          "frame_num": 83, "crc_ok": False, "evm": 8.375,
          "abs_start": 25719}]),
}


def _same(got, want):
    """Frame dicts equal key by key, in order, with each value's type."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert type(g[key]) is type(w[key]), key
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("sink", list(WANT))
def test_each_sink_gives_the_same_frame_dicts(sink):
    run, want = WANT[sink]
    _same(run(), want)


@pytest.mark.parametrize("sink, waits, unpacks", [
    ("collect_sharded_frames", [], [None]),
    ("collect_sharded_stream_frames", [1, 0, 2], [1, 0])])
def test_the_sharded_sinks_record_the_sink_spans_and_frame_counter(
        sink, waits, unpacks):
    """With spans on: "sink.wait" on each chunk's index (the capture has
    none), "sink.copy" on every step, "sink.unpack" on each step with a
    valid slot, under its push number, and the counters "rx.frames" and
    "sink.fields" (each step read field by field: the gathered shards
    share no storage)."""
    run, want = WANT[sink]
    tm.enable(True)
    tm.drain()
    try:
        frames = run()
        got = tm.drain()
    finally:
        tm.enable(False)

    def pushes(name):
        return [s.push for s in got.spans if s.name == name]
    assert pushes("sink.wait") == waits
    assert pushes("sink.copy") == (waits or [None])
    assert pushes("sink.unpack") == unpacks
    assert got.counters == {"rx.frames": len(want),
                            "sink.fields": len(waits) or 1}
    _same(frames, want)


READBACKS = {                 # .cpu() calls of the whole list of steps
    "collect_frames_hard": 10 + 1 + 10,       # valid, 7 fields, starts,
    "collect_frames_soft": 11 + 1 + 11,       # fine_cfo (+ llr); an empty
    "collect_frames_no_block_size": 10 + 1 + 10,   # step reads valid only
    "collect_wideband_frames": 7 + 1 + 7,     # valid, 5 fields, starts
    "collect_sharded_frames": 7,
    "collect_sharded_stream_frames": 8 + 8 + 1,    # and each origin
    "collect_sharded_stream_frames_rank": 8 + 8,
}


@pytest.mark.parametrize("sink", list(READBACKS))
def test_each_sink_reads_a_field_back_once_a_step(sink, monkeypatch):
    run, _ = WANT[sink]
    calls = []
    cpu = torch.Tensor.cpu

    def counted(t, *args, **kwargs):
        calls.append(tuple(t.shape))
        return cpu(t, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    run()
    assert len(calls) == READBACKS[sink]


def _packed(res, flat=None):
    """res as a replayed step returns it: each field a view of one byte
    buffer (`flat`, reused where given, else a new one), laid out by
    _Layout."""
    leaves = trx._leaves(res)
    layout = trx._Layout(leaves)
    if flat is None:
        flat = torch.empty(layout.nbytes, dtype=torch.uint8)
    layout.pack(leaves, flat)
    return trx._from_leaves(layout.unpack(flat))


PACKED = {                    # sink, its steps
    "collect_frames_hard": (
        lambda outs: collect_frames(outs, block_size=4096, hist=H),
        _rx_outs),
    "collect_frames_soft": (
        lambda outs: collect_frames(outs, block_size=4096, hist=H),
        lambda: _rx_outs(LLR)),
    "collect_frames_no_block_size": (collect_frames, _rx_outs),
    "collect_wideband_frames": (
        lambda outs: collect_wideband_frames(outs, 1024, SPEC),
        _wideband_outs),
}


def _packed_outs(sink):
    return [o._replace(result=_packed(o.result)) for o in PACKED[sink][1]()]


@pytest.mark.parametrize("sink", list(PACKED))
def test_packed_steps_give_the_same_frame_dicts(sink):
    """Each step's result views of one buffer: the same dicts as field by
    field, and with spans on the counter "sink.packed" a step."""
    run, _ = PACKED[sink]
    outs = _packed_outs(sink)
    tm.enable(True)
    tm.drain()
    try:
        frames = run(outs)
        got = tm.drain()
    finally:
        tm.enable(False)
    _same(frames, WANT[sink][1])
    assert got.counters["sink.packed"] == len(outs)
    assert "sink.fields" not in got.counters
    assert "sink.side" not in got.counters       # no step event: not replayed


READBACKS_PACKED = {          # .cpu() calls: the record, once a step
    "collect_frames_hard": 3,
    "collect_frames_soft": 3,
    "collect_frames_no_block_size": 3,
    "collect_wideband_frames": 3,
}


@pytest.mark.parametrize("sink", list(READBACKS_PACKED))
def test_a_packed_step_is_read_back_in_one_copy(sink, monkeypatch):
    run, _ = PACKED[sink]
    outs = _packed_outs(sink)
    calls = []
    cpu = torch.Tensor.cpu

    def counted(t, *args, **kwargs):
        calls.append(tuple(t.shape))
        return cpu(t, *args, **kwargs)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    run(outs)
    assert len(calls) == READBACKS_PACKED[sink]
    assert all(len(shape) == 1 for shape in calls)       # bytes


@pytest.mark.parametrize("sink", list(PACKED))
def test_packed_frames_outlive_the_buffer_they_were_read_from(sink):
    """Steps packed one after another into one reused buffer, each
    collected before the next is packed, then the buffer overwritten:
    every step's frames, its LLR arrays included, stay as they were
    read."""
    run, steps = PACKED[sink]
    outs = steps()
    flat = torch.empty(trx._Layout(trx._leaves(outs[0].result)).nbytes,
                       dtype=torch.uint8)
    frames = []
    for o in outs:
        frames += run([o._replace(result=_packed(o.result, flat))])
    flat.fill_(255)
    _same(frames, WANT[sink][1])
