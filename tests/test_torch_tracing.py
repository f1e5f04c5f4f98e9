"""The port's spans and counters (tpu_ofdm_torch/utils/metrics.py `span`,
`count`, `drain`) and where the program places them, on the CPU: off, a
span is the one shared null context and reads no clock; on, nested spans
on two threads keep their parents and push numbers, the cap counts what it
drops, a push of the streaming receiver and its sink record their stages
under one push number with the slot and frame counters, the outputs are
the same bits with spans on and off, pfb counts its calls by layout,
FileStreamer's `last_times` are its spans' durations, and `trace` puts the
stages in the Chrome trace."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tests.test_torch_radio import RADIO_SC, TSPEC as RADIO_SPEC
from tests.test_torch_wideband import N_CHAN, S as WB_S, TSC as WB_SC
from tests.test_torch_wideband import TSPEC as WB_SPEC, _capture
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch import runtime as rt
from tpu_ofdm_torch.io import DeviceFeed
from tpu_ofdm_torch.kernels import pfb as tpfb
from tpu_ofdm_torch.modem import radio as tradio
from tpu_ofdm_torch.modem import rx_stream as trs
from tpu_ofdm_torch.modem import tx_stream as tts
from tpu_ofdm_torch.modem import wideband as twb
from tpu_ofdm_torch.stream import executor as tex
from tpu_ofdm_torch.utils import metrics as tm

SPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
S, K = 1 << 14, 8
SC = tconfig.StreamConfig(block_size=S, max_frames_per_block=K)
POSITIONS = [500, 4000, 9000, S + 300]     # three in block 0, one in 1


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and nothing kept."""
    tm.enable(False)
    tm.drain()
    yield
    tm.enable(False)
    tm.drain()


def _stream(n_blocks=3, seed=5):
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    x = 0.03 * (rng.randn(n_blocks * S) + 1j * rng.randn(n_blocks * S))
    for i, p in enumerate(POSITIONS):
        msg = rng.randint(0, 256, 40 + 30 * i).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=i)
        x[p:p + len(f)] += f
    return torch.as_tensor(x.astype(np.complex64)).reshape(n_blocks, S)


def _receive(blocks):
    ex = tex.StreamExecutor(trs.rx_stream_block(SPEC, SC), S, device="cpu")
    outs = [ex.push(b) for b in blocks]
    return outs, trs.collect_frames(outs, block_size=S,
                                    hist=trs.history_len(SPEC))


def _leaves_equal(a, b):
    la, lb = tex.tree_leaves(a), tex.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


def test_spans_off_are_one_null_context_and_read_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a clock read with spans off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert tm.span("a") is tm.span("b", push=3)
    with tm.span("rx.detect") as s:
        assert s is None
    tm.count("rx.slots", 5)
    outs, frames = _receive(_stream())
    assert len(frames) == len(POSITIONS)
    got = tm.drain()
    assert got.spans == [] and got.counters == {} and got.dropped == 0


def test_nested_spans_on_two_threads_keep_parents_and_pushes():
    tm.enable(True)
    barrier = threading.Barrier(2)

    def work(push):
        with tm.span("outer", push=push):
            barrier.wait(timeout=10)
            with tm.span("inner"):
                with tm.span("leaf"):
                    barrier.wait(timeout=10)
        with tm.span("loose"):
            tm.count("n", push)

    threads = [threading.Thread(target=work, args=(p,)) for p in (7, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    got = tm.drain()
    assert got.counters == {"n": 15} and got.dropped == 0
    by_id = {s.id: s for s in got.spans}
    assert len(by_id) == 8
    push_of = {s.thread: s.push for s in got.spans if s.name == "outer"}
    assert sorted(push_of.values()) == [7, 8]
    for s in got.spans:
        assert s.end_ns >= s.start_ns
        up = by_id.get(s.parent)
        want_parent = {"outer": None, "inner": "outer", "leaf": "inner",
                       "loose": None}[s.name]
        assert (up and up.name) == want_parent
        if up is not None:
            assert up.thread == s.thread
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        want_push = None if s.name == "loose" else push_of[s.thread]
        assert s.push == want_push
    assert tm.drain().spans == []


def test_the_cap_counts_drops_and_the_list_stays_at_it(monkeypatch):
    monkeypatch.setattr(tm, "SPAN_CAP", 5)
    tm.enable(True)
    for i in range(12):
        with tm.span("s", push=i):
            pass
    got = tm.drain()
    assert len(got.spans) == 5 and got.dropped == 7
    assert [s.push for s in got.spans] == [0, 1, 2, 3, 4]
    assert tm.drain().dropped == 0


def test_a_push_and_its_sink_record_their_stages_under_one_push_number():
    blocks = _stream()
    tm.enable(True)
    outs, frames = _receive(blocks)
    got = tm.drain()
    by_id = {s.id: s for s in got.spans}
    names = [s.name for s in got.spans]
    assert names.count("executor.push") == len(blocks)
    for name in ("rx.detect", "rx.demod"):
        for s in got.spans:
            if s.name == name:
                up = by_id[s.parent]
                assert up.name == "executor.push" and up.push == s.push
    for push in range(len(blocks)):
        mine = {s.name for s in got.spans if s.push == push}
        assert {"executor.push", "rx.detect", "rx.demod", "sink.wait",
                "sink.copy"} <= mine
    unpacked = sorted(s.push for s in got.spans if s.name == "sink.unpack")
    assert unpacked == [0, 1]              # push 2 reports no frame
    assert all(s.parent is None for s in got.spans
               if s.name.startswith("sink."))
    # no CFO: every frame's integer shift is 0; one L = 32 detection a push;
    # the CPU's eager steps are read back field by field
    assert got.counters == {"rx.slots": K * len(blocks),
                            "rx.frames": len(frames), "rx.int_cfo": 0,
                            "sc_detect.l32": len(blocks),
                            "sink.fields": len(blocks)}
    summ = tm.summary(got.spans)
    assert summ["executor.push"]["calls"] == len(blocks)
    assert summ["executor.push"]["self_ms"] <= summ["executor.push"]["ms"]
    assert summ["executor.push"]["self_ms"] == pytest.approx(
        summ["executor.push"]["ms"] - summ["rx.detect"]["ms"]
        - summ["rx.demod"]["ms"], abs=1e-6)


def test_replayed_pushes_and_their_sink_count_the_side_readback(
        monkeypatch):
    """Through the CUDA-graph stand-in (tests/test_torch_rx_graph.py): the
    key's first two pushes run eagerly and are read field by field, the
    later ones replay and are read back after their own event, "sink.wait"
    on each under its push number, and the same frames as the CPU's eager
    steps give."""
    from tests.test_torch_rx_graph import CpuGraphCalls
    from tpu_ofdm_torch.modem import rx as trx

    blocks = _stream(n_blocks=4)
    _, want = _receive(blocks)
    monkeypatch.setattr(trx, "STEP_GRAPHS",
                        trx.StepGraphs(calls=CpuGraphCalls()))
    tm.enable(True)
    _, frames = _receive(blocks)
    got = tm.drain()
    assert frames == want
    assert sorted(s.push for s in got.spans
                  if s.name == "sink.wait") == list(range(len(blocks)))
    assert got.counters == {"rx.slots": K * len(blocks),
                            "rx.frames": len(frames), "rx.int_cfo": 0,
                            "sc_detect.l32": len(blocks),
                            "rx.graph_eager": 2, "rx.graph_replay": 2,
                            "sink.fields": 2, "sink.packed": 2,
                            "sink.side": 2}


def test_receiver_outputs_are_the_same_bits_with_spans_on_and_off():
    blocks = _stream()
    outs_off, frames_off = _receive(blocks)
    tm.enable(True)
    outs_on, frames_on = _receive(blocks)
    tm.enable(False)
    assert len(frames_off) == len(POSITIONS)
    assert frames_on == frames_off
    for a, b in zip(outs_off, outs_on):
        _leaves_equal(a, b)


def _radio_outs():
    S_ = RADIO_SC.block_size
    ex = tex.StreamExecutor(tradio.ofdm_radio(RADIO_SPEC, RADIO_SC), S_,
                            device="cpu")
    msgs = [b"spans on and off %d" % i for i in range(3)]
    air = torch.zeros(S_, dtype=torch.complex64)
    outs = []
    for i in range(3):
        ti = tts.queue_tx_in(RADIO_SPEC, 4, msgs if i == 0 else [],
                             device="cpu")[0]
        out = ex.push((ti, air))
        outs.append(out)
        air = out.tx.samples
    return outs


def _wideband_outs():
    ex = tex.StreamExecutor(twb.wideband_rx_block(WB_SPEC, N_CHAN, WB_SC),
                            WB_SC.block_size, device="cpu")
    outs = ex.run(torch.as_tensor(_capture()), drain=True)
    return outs, twb.collect_wideband_frames(outs, WB_S, WB_SPEC)


def test_radio_and_wideband_outputs_are_the_same_bits_with_spans_on():
    radio_off, (wb_off, wbf_off) = _radio_outs(), _wideband_outs()
    tm.enable(True)
    radio_on, (wb_on, wbf_on) = _radio_outs(), _wideband_outs()
    got = tm.drain()
    for a, b in zip(radio_off + wb_off, radio_on + wb_on):
        _leaves_equal(a, b)
    assert wbf_on == wbf_off and len(wbf_off) == 3
    summ = tm.summary(got.spans)
    assert summ["radio.tx"]["calls"] == len(radio_on)
    assert summ["wideband.channelize"]["calls"] == len(wb_on)
    assert {"rx.detect", "rx.demod", "sink.wait", "sink.copy",
            "sink.unpack"} <= set(summ)
    assert got.counters["rx.slots"] == (len(radio_on) * RADIO_SC
                                        .max_frames_per_block
                                        + len(wb_on) * N_CHAN
                                        * WB_SC.max_frames_per_block)
    assert got.counters["rx.frames"] == len(wbf_on)


@pytest.mark.parametrize("layouts", [("row",), ("chan",),
                                     ("row", "chan", "chan")])
def test_pfb_counts_one_call_under_each_layout(layouts):
    """Counters "pfb.row" and "pfb.chan": one a channelize_fused call under
    its layout while spans are on (on the CPU the plain version serves
    it), none while they are off."""
    x = torch.zeros(64 * 8, dtype=torch.complex64)
    poly = torch.zeros((8, 64), dtype=torch.float32)
    for layout in layouts:
        tpfb.channelize_fused(x, poly, layout=layout)
    assert tm.drain().counters == {}
    tm.enable(True)
    for layout in layouts:
        tpfb.channelize_fused(x, poly, layout=layout)
    got = tm.drain()
    assert got.counters == {f"pfb.{form}": layouts.count(form)
                            for form in set(layouts)}


def test_file_streamer_into_the_feed_times_each_block_once(tmp_path):
    n, block = 4 * 2048, 2048
    rng = np.random.RandomState(3)
    re, im = (rng.randn(2, n) * 0.3).astype(np.float32)
    path = str(tmp_path / "c.i16c")
    with open(path, "wb") as f:
        f.write(rt.from_planar(re, im, "i16c", scale=1 / 1024))
    tm.enable(True)
    with rt.FileStreamer(path, "i16c", block_size=block,
                         scale=1 / 1024) as fs:
        got = list(DeviceFeed(fs.packed(), depth=2, device="cpu"))
        last = fs.last_times
    spans = tm.drain().spans
    assert len(got) == 4
    summ = tm.summary(spans)
    # one fill a block, and the fill whose read finds the end of the file
    assert summ["feed.fill"]["calls"] == summ["file.read"]["calls"] == 5
    assert summ["feed.wait"]["calls"] == 5        # the end marker's too
    fills = {s.id for s in spans if s.name == "feed.fill"}
    assert all(s.parent in fills for s in spans
               if s.name in ("file.read", "file.convert"))
    feed_thread = {s.thread for s in spans if s.name == "feed.fill"}
    assert feed_thread != {s.thread for s in spans if s.name == "feed.wait"}
    for i, name in enumerate(("file.read", "file.convert")):
        s = [s for s in spans if s.name == name][-1]
        assert last[i] == (s.end_ns - s.start_ns) / 1e9


def test_trace_puts_the_stages_in_the_chrome_trace(tmp_path):
    blocks = _stream(n_blocks=2)
    with tm.trace(str(tmp_path / "trace")):
        assert tm.enabled()
        _receive(blocks)
    assert not tm.enabled()
    events = json.loads((tmp_path / "trace" / tm.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    for stage in ("executor.push", "rx.detect", "rx.demod", "sink.copy"):
        assert tm.PROFILER_PREFIX + stage in names, stage
    assert len(tm.drain().spans) > 0
