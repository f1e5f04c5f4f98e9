"""The port's wideband receiver (channelizer -> batched rx_block over the
channels) against the JAX package's (channelizer -> rx_block vmapped over
the channels) on tests/test_wideband.py's capture, through both
executors.  Channels, payloads, frame numbers, crc_ok and abs_start must be
identical, EVM within rtol 1e-3, with either equalizer.  Also: the port
resumes mid-stream from a JAX carry; the batched detect, gather and rx_block equal their per-row
forms exactly; the gather equals the JAX wideband path's vmapped
dynamic_slice exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from tests.test_wideband import _synthesize_wideband
from tpu_ofdm.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.modem import wideband as jwb
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.kernels import gather as tg
from tpu_ofdm_torch.kernels import sc_detect as tk
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem import wideband as twb
from tpu_ofdm_torch.stream import executor as tex

CFG = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
SPEC = CFG.spec
TSPEC = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
N_CHAN = 8
S = 1024
SC = StreamConfig(block_size=N_CHAN * S, max_frames_per_block=4)
TSC = tconfig.StreamConfig(block_size=N_CHAN * S, max_frames_per_block=4)
TARGETS = {1: (b"channel one message", 500),
           5: (b"channel five message", 1200),
           6: (b"a late frame on six", 4100)}


@functools.lru_cache(maxsize=None)
def _capture():
    return _synthesize_wideband(CFG, N_CHAN, TARGETS, per_chan_len=6000)


@functools.lru_cache(maxsize=None)
def _jax_frames():
    ex = jex.StreamExecutor(jwb.wideband_rx_block(SPEC, N_CHAN, SC),
                            SC.block_size)
    return jwb.collect_wideband_frames(ex.run(_capture(), drain=True), S,
                                       SPEC)


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for k in ("channel", "payload", "frame_num", "crc_ok", "abs_start"):
            assert a[k] == b[k], (k, a, b)
        np.testing.assert_allclose(a["evm"], b["evm"], rtol=1e-3)


def test_wideband_rx_matches_jax():
    ex = tex.StreamExecutor(twb.wideband_rx_block(TSPEC, N_CHAN, TSC),
                            SC.block_size, device="cpu")
    outs = ex.run(torch.as_tensor(_capture()), drain=True)
    port = twb.collect_wideband_frames(outs, S, TSPEC)
    _assert_same(port, _jax_frames())
    assert {(f["channel"], f["payload"]) for f in port} == {
        (k, msg) for k, (msg, _) in TARGETS.items()}
    for f in port:
        assert f["crc_ok"]
        assert abs(f["abs_start"] - TARGETS[f["channel"]][1]) < 40
    assert outs[0].result.valid.shape == (N_CHAN, SC.max_frames_per_block)


def test_wideband_simpledfe_matches_jax():
    """equalizer="simpledfe" goes through to every channel's rx_block, in
    the port as in the JAX package: the same frames."""
    jx = jex.StreamExecutor(
        jwb.wideband_rx_block(SPEC, N_CHAN, SC, equalizer="simpledfe"),
        SC.block_size)
    ref = jwb.collect_wideband_frames(jx.run(_capture(), drain=True), S,
                                      SPEC)
    ex = tex.StreamExecutor(
        twb.wideband_rx_block(TSPEC, N_CHAN, TSC, equalizer="simpledfe"),
        TSC.block_size, device="cpu")
    port = twb.collect_wideband_frames(
        ex.run(torch.as_tensor(_capture()), drain=True), S, TSPEC)
    _assert_same(port, ref)
    assert len(port) == len(TARGETS) and all(f["crc_ok"] for f in port)


def test_resume_from_jax_carry():
    """Three JAX steps, then the port continues from the JAX carry."""
    blocks, _ = jex.pad_to_blocks(_capture(), SC.block_size)
    jx = jex.StreamExecutor(jwb.wideband_rx_block(SPEC, N_CHAN, SC),
                            SC.block_size)
    for i in range(3):
        jx.push(blocks[i])
    ex = tex.StreamExecutor(twb.wideband_rx_block(TSPEC, N_CHAN, TSC),
                            SC.block_size, device="cpu")
    ex.state = twb.carry_from_jax(jx.state, ex.device)
    outs = [ex.push(torch.as_tensor(b)) for b in blocks[3:]]
    zeros = torch.zeros(SC.block_size, dtype=torch.complex64)
    outs += [ex.push(zeros) for _ in range(-(-ex.block.latency
                                              // SC.block_size))]
    H = twb.history_len(TSPEC)
    ref = [f for f in _jax_frames() if f["abs_start"] >= 3 * S - H]
    assert [f["channel"] for f in ref] == [6]
    _assert_same(twb.collect_wideband_frames(outs, S, TSPEC), ref)
    tail, hist, step = twb.carry_to_jax(ex.state)
    j_tail, j_hist, j_step = jwb.wideband_rx_block(SPEC, N_CHAN, SC).init()
    assert tail.shape == j_tail.shape and tail.dtype == np.complex64
    assert hist.shape == j_hist.shape and hist.dtype == np.complex64
    assert step.dtype == np.int32 and int(step) == len(outs) + 3


def _rows(seed, B=4, h=1024, n=9000):
    """B rows of noise with golden frames at row-dependent offsets, split
    into (B, h) heads and (B, n) blocks."""
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    v = (rng.randn(B, h + n) + 1j * rng.randn(B, h + n)) * 0.03
    for b in range(B):
        for i, p in enumerate((300 + 500 * b, 4000 + 900 * b)):
            f = G.tx_frame(gp, bytes(range(10 + 7 * b + i)), frame_num=b)
            v[b, p:p + len(f)] += f
    v = v.astype(np.complex64)
    return torch.as_tensor(v[:, :h].copy()), torch.as_tensor(v[:, h:].copy())


def test_batched_rx_block_equals_per_row():
    head, x = _rows(1)
    got = trx.rx_block(TSPEC, x, 4, own_lo=0, own_hi=x.shape[-1], head=head)
    assert int(got.valid.sum()) == 8
    for b in range(x.shape[0]):
        one = trx.rx_block(TSPEC, x[b], 4, own_lo=0, own_hi=x.shape[-1],
                           head=head[b])
        for a, w in zip(jax.tree.leaves(tuple(got)),
                        jax.tree.leaves(tuple(one))):
            torch.testing.assert_close(a[b], w, rtol=0, atol=0)


def test_batched_detect_rows_equal_per_row():
    head, x = _rows(2)
    got = tk.sc_detect_rows(x, 32, 16, head=head)
    assert got[0].shape == (4, -(-(1024 + 9000) // 128))
    for b in range(x.shape[0]):
        for a, w in zip(got, tk.sc_detect_rows(x[b], 32, 16, head=head[b])):
            torch.testing.assert_close(a[b], w, rtol=0, atol=0)


def test_batched_gather_matches_vmapped_dynamic_slice():
    """The JAX wideband path gathers with a vmapped dynamic_slice on
    [history | channel block]; the port gathers in place: exact."""
    head, x = _rows(3)
    F = SPEC.max_frame_len
    nv = head.shape[-1] + x.shape[-1]
    rng = np.random.RandomState(4)
    starts = rng.randint(0, nv - F + 1, (4, 6)).astype(np.int32)
    starts[:, 0] = [0, 1023, 1024 - F // 2, nv - F]
    ext = np.concatenate([head.numpy(), x.numpy()], axis=-1)
    want = jax.vmap(jax.vmap(lambda row, s: jax.lax.dynamic_slice(
        row, (s,), (F,)), in_axes=(None, 0)))(jnp.asarray(ext),
                                              jnp.asarray(starts))
    got = tg.gather_windows(x, torch.as_tensor(starts), F, head=head)
    assert got.shape == (4, 6, F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(4):
        torch.testing.assert_close(
            got[b], tg.gather_windows(x[b], torch.as_tensor(starts[b]), F,
                                      head=head[b]), rtol=0, atol=0)


def test_other_equalizers_raise():
    """Unknown equalizer or output names raise; "simpledfe" and "soft" run
    (tests/test_torch_radio.py holds them against the JAX package)."""
    head, x = _rows(4)
    with pytest.raises(ValueError):
        trx.rx_block(TSPEC, x, 4, head=head, equalizer="")
    with pytest.raises(ValueError):
        trx.rx_block(TSPEC, x, 4, head=head, equalizer="zf")
    with pytest.raises(ValueError):
        trx.rx_block(TSPEC, x, 4, head=head, output="bits")
    res = trx.rx_block(TSPEC, x, 4, head=head, equalizer="simpledfe",
                       output="soft")
    assert res.frames.llr.shape[:2] == res.valid.shape


def test_batch_mismatch_rejected():
    head, x = _rows(5)
    with pytest.raises(ValueError):
        tk.sc_detect_rows(x, 32, 16, head=head[:3])
    with pytest.raises(ValueError):
        tg.gather_windows(x, torch.zeros((3, 2), dtype=torch.int32), 16,
                          head=head)
