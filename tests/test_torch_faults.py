"""Fault injection, stall detection and deterministic replay on the port
(tpu_ofdm_torch/utils/faults.py), with the bars of tests/test_faults.py: a
dropped or zeroed block loses only the frames that touch it, a duplicated
block corrupts nothing, and the same capture twice through fresh
executors gives bit-identical raw outputs.  The dropped block's frames
are also held against the JAX package's on the same blocks."""

import functools
import time

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig, StreamConfig
from tpu_ofdm.modem import rx_stream as jrs
from tpu_ofdm.stream.executor import StreamExecutor as JaxExecutor
from tpu_ofdm.utils import faults as jfaults
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.stream.executor import (StreamExecutor, pad_to_blocks,
                                            tree_leaves)
from tpu_ofdm_torch.utils.faults import Watchdog, _zero_like, inject_faults

BLOCK = 2048
SPEC = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
SC = tconfig.StreamConfig(block_size=BLOCK, max_frames_per_block=4)
FLEN = SPEC.max_frame_len


@functools.lru_cache(maxsize=None)
def _frame_stream(n_frames=4, gap=900):
    """tests/test_faults.py's stream, its frames from the golden model."""
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    payloads = [f"fault test frame {i}".encode() for i in range(n_frames)]
    parts = []
    for i, p in enumerate(payloads):
        parts += [np.zeros(gap), G.tx_frame(gp, p, i)]
    parts.append(np.zeros(BLOCK))
    return payloads, np.concatenate(parts).astype(np.complex64)


def _blocks(stream):
    b, _ = pad_to_blocks(torch.as_tensor(stream), BLOCK)
    return [b[i] for i in range(b.shape[0])]


def _rx(blocks_iter):
    ex = StreamExecutor(rx_stream_block(SPEC, SC), BLOCK, device="cpu")
    outs = [ex.push(b) for b in blocks_iter]
    for _ in range(-(-ex.block.latency // BLOCK)):   # drain the latency
        outs.append(ex.push(torch.zeros(BLOCK, dtype=torch.complex64)))
    return collect_frames(outs, block_size=BLOCK, hist=history_len(SPEC))


def _touching(clean, payloads, victim):
    lo, hi = victim * BLOCK, (victim + 1) * BLOCK
    return {p for f, p in zip(clean, payloads)
            if f["abs_start"] < hi and f["abs_start"] + FLEN > lo}


def test_dropped_block_loses_only_touching_frames():
    payloads, stream = _frame_stream()
    blocks = _blocks(stream)
    clean = _rx(blocks)
    assert [f["payload"] for f in clean] == payloads
    victim = clean[1]["abs_start"] // BLOCK
    touching = _touching(clean, payloads, victim)
    assert payloads[1] in touching and payloads[0] not in touching
    got = _rx(inject_faults(blocks, drop=[victim]))
    assert {f["payload"] for f in got if f["crc_ok"]} \
        == set(payloads) - touching

    # the JAX receiver on the same perturbed blocks reports the same frames
    cfg = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
    jsc = StreamConfig(block_size=BLOCK, max_frames_per_block=4)
    jex = JaxExecutor(jrs.rx_stream_block(cfg.spec, jsc), BLOCK)
    np_blocks = [b.numpy() for b in blocks]
    outs = [jex.push(b) for b in jfaults.inject_faults(np_blocks,
                                                       drop=[victim])]
    outs += [jex.push(np.zeros(BLOCK, np.complex64))
             for _ in range(-(-jex.block.latency // BLOCK))]
    want = jrs.collect_frames(outs, block_size=BLOCK,
                              hist=jrs.history_len(cfg.spec))

    def key(f):
        return (f["payload"], f["frame_num"], f["abs_start"], f["crc_ok"])

    assert sorted(map(key, got)) == sorted(map(key, want))


def test_zeroed_block_equivalent_to_squelch():
    payloads, stream = _frame_stream()
    blocks = _blocks(stream)
    clean = _rx(blocks)
    victim = clean[2]["abs_start"] // BLOCK
    touching = _touching(clean, payloads, victim)
    assert payloads[2] in touching
    got = _rx(inject_faults(blocks, zero=[victim]))
    assert {f["payload"] for f in got if f["crc_ok"]} \
        == set(payloads) - touching


def test_duplicated_block_adds_no_corruption():
    """A replayed transfer must not corrupt neighboring frames; the frame
    contained in the duplicated block may legitimately appear twice."""
    payloads, stream = _frame_stream(gap=1800)
    blocks = _blocks(stream)
    clean = _rx(blocks)
    victim = clean[1]["abs_start"] // BLOCK
    got = _rx(inject_faults(blocks, duplicate=[victim]))
    ok = [f["payload"] for f in got if f["crc_ok"]]
    for p in payloads:
        assert p in ok


def test_zero_like_keeps_leaf_kinds():
    """Tensor leaves become torch zeros on their device and dtype, numpy
    leaves numpy zeros; tuples (a FileStreamer's planes) keep their form."""
    t = torch.ones(4, dtype=torch.complex64)
    a = np.ones(3, np.float32)
    zt, (za, zb) = _zero_like((t, (a, a)))
    assert isinstance(zt, torch.Tensor) and zt.dtype == torch.complex64
    assert not zt.any()
    assert isinstance(za, np.ndarray) and za.dtype == np.float32
    assert not za.any() and not zb.any()
    assert t.all() and a.all()                   # inputs untouched


def test_deterministic_replay():
    """Same capture twice through fresh executors => bit-identical raw
    outputs, every leaf of every step."""
    _, stream = _frame_stream()

    def run_once():
        ex = StreamExecutor(rx_stream_block(SPEC, SC), BLOCK, device="cpu")
        return ex.run(stream, drain=True)

    a, b = run_once(), run_once()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        la, lb = tree_leaves(x), tree_leaves(y)
        assert len(la) == len(lb)
        for u, v in zip(la, lb):
            assert u.dtype == v.dtype and torch.equal(u, v)


def test_watchdog_detects_stall_and_recovery():
    counter = {"n": 0}
    stalls = []
    wd = Watchdog(lambda: counter["n"], timeout=0.15,
                  on_stall=lambda: stalls.append(time.monotonic()), poll=0.02)
    with wd:
        for _ in range(5):           # healthy progress
            counter["n"] += 1
            time.sleep(0.05)
        assert not wd.stalled
        time.sleep(0.4)              # stall
        assert wd.stalled and wd.stall_count == 1
        counter["n"] += 1            # recover
        time.sleep(0.1)
        assert not wd.stalled
        time.sleep(0.4)              # stall again -> fires again
    assert wd.stall_count == 2
    assert len(stalls) == 2


def test_watchdog_no_false_positive():
    counter = {"n": 0}
    wd = Watchdog(lambda: counter["n"], timeout=0.5, poll=0.02)
    with wd:
        for _ in range(10):
            counter["n"] += 1
            time.sleep(0.03)
    assert wd.stall_count == 0 and not wd.stalled


@pytest.mark.parametrize("kind", ["drop", "duplicate", "zero"])
def test_inject_faults_orders_blocks_as_jax(kind):
    blocks = [np.full(4, i, np.complex64) for i in range(6)]
    got = list(inject_faults(blocks, **{kind: [1, 4]}))
    want = list(jfaults.inject_faults(blocks, **{kind: [1, 4]}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
