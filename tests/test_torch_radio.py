"""The port's streaming TX, the RX options (simpledfe, soft output) and the
full-duplex radio against the JAX package's.

Streaming TX: accepted masks and pending counts identical push by push,
samples to atol 1e-5 (the IFFT, see tests/test_torch_tx.py).  RX options:
integers, bits and bytes identical on valid slots; equalized symbols to
atol 1e-4 (the DFE feeds each symbol's float32 rounding into the next
symbol's estimate); LLRs to rtol 1e-3 of their largest magnitude (they are
scaled by 1/EVM^2).
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.modem import radio as jradio
from tpu_ofdm.modem import rx as jrx
from tpu_ofdm.modem import rx_stream as jrs
from tpu_ofdm.modem import tx_stream as jts
from tpu_ofdm.ops.sync import derotate as jderotate
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.modem import radio as tradio
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem import rx_stream as trs
from tpu_ofdm_torch.modem import tx_stream as tts
from tpu_ofdm_torch.ops.channel import channel_block
from tpu_ofdm_torch.stream import executor as tex

SPEC = OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
TSPEC = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec


def _push_both(jx, ex, msgs, k, frame_num0):
    """Queue the same PDUs on the JAX and the port TX, push once each and
    check the outputs agree; returns the port's output."""
    jin, _ = jts.queue_tx_in(SPEC, k, msgs, frame_num0)
    tin, _ = tts.queue_tx_in(TSPEC, k, msgs, frame_num0, device="cpu")
    want = jx.push(jin)
    got = ex.push(tin)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    assert int(got.n_pending) == int(np.asarray(want.n_pending))
    np.testing.assert_allclose(got.samples.numpy(), np.asarray(want.samples),
                               atol=1e-5)
    return got


def _executors(sc):
    return (jex.StreamExecutor(jts.tx_stream_block(SPEC, sc), sc.block_size),
            tex.StreamExecutor(tts.tx_stream_block(TSPEC, sc), sc.block_size,
                               device="cpu"))


def test_tx_stream_matches_jax_over_pushes():
    sc = StreamConfig(block_size=1 << 12, max_frames_per_block=4)
    jx, ex = _executors(sc)
    msgs = [b"pdu number %d over the streaming tx" % i for i in range(6)]
    batches = [msgs[:4], msgs[4:], [], []]
    for i, batch in enumerate(batches):
        out = _push_both(jx, ex, batch, 4, 4 * i)
        assert out.samples.shape == (sc.block_size,)
    assert int(ex.state[1]) == 0


def test_tx_stream_back_pressure_matches_jax():
    """tests/test_tx_stream.py's back-pressure run on both packages in
    lockstep: tiny blocks, refused slots queued again, every PDU sent once;
    the port's stream then decodes to every PDU."""
    sc = StreamConfig(block_size=256, max_frames_per_block=8)
    jx, ex = _executors(sc)
    msgs = [bytes([65 + i]) * 40 for i in range(12)]
    pending, sent, chunks = list(msgs), 0, []
    for _ in range(80):
        out = _push_both(jx, ex, pending[:8], 8, sent)
        acc = out.accepted.numpy()
        n_in = min(8, len(pending))
        n_ok = int(acc[:n_in].sum())
        assert acc[:n_ok].all() and not acc[n_ok:].any()
        sent += n_ok
        pending = pending[n_ok:]
        chunks.append(out.samples)
        if not pending and int(out.n_pending) == 0:
            break
    assert sent == len(msgs)
    rex = tex.StreamExecutor(trs.rx_stream_block(TSPEC, StreamConfig(
        block_size=1 << 12, max_frames_per_block=8)), 1 << 12, device="cpu")
    frames = trs.collect_frames(rex.run(torch.cat(chunks), drain=True))
    assert sorted((f["frame_num"], f["payload"]) for f in frames) == list(
        enumerate(msgs))
    assert all(f["crc_ok"] for f in frames)


def test_tx_stream_accepted_prefix_mid_batch():
    """Full batches pushed into a draining buffer: a push accepts a head of
    its slots and refuses the tail, exactly as the JAX package's does."""
    sc = StreamConfig(block_size=256, max_frames_per_block=8)
    jx, ex = _executors(sc)
    msgs = [bytes([48 + i]) * 50 for i in range(8)]
    saw_partial = False
    for _ in range(6):
        acc = _push_both(jx, ex, msgs, 8, 0).accepted.numpy()
        n_ok = int(acc.sum())
        np.testing.assert_array_equal(acc, np.arange(8) < n_ok)
        saw_partial |= 0 < n_ok < 8
    assert saw_partial


def test_tx_stream_resumes_from_a_jax_carry():
    sc = StreamConfig(block_size=512, max_frames_per_block=4)
    jx, ex = _executors(sc)
    msgs = [bytes([i]) * 45 for i in range(4)]
    for i in range(2):
        jx.push(jts.queue_tx_in(SPEC, 4, msgs, 4 * i)[0])
    ex.state = tts.carry_from_jax(jx.state, ex.device)
    assert int(ex.state[1]) > 0                     # frames still pending
    for i in range(2, 5):
        _push_both(jx, ex, msgs if i == 2 else [], 4, 4 * i)
    buf, cur = tts.carry_to_jax(ex.state)
    assert buf.dtype == np.complex64 and buf.shape == (
        tts.pending_len(TSPEC, sc),)
    assert cur.dtype == np.int32 and int(cur) == int(np.asarray(jx.state[1]))


RADIO_SC = StreamConfig(block_size=1 << 12, max_frames_per_block=4)


def _loopback(radio, n_steps, msgs, seed=3):
    """Push `msgs` into the radio, then empty inputs; each TX block goes
    through a 25 dB, CFO 0.05 channel into the RX half one push later."""
    S = RADIO_SC.block_size
    ex = tex.StreamExecutor(radio, S, device="cpu")
    ch = tex.StreamExecutor(channel_block(seed=seed, snr_db=25, cfo=0.05), S,
                            device="cpu")
    air = torch.zeros(S, dtype=torch.complex64)
    outs = []
    for i in range(n_steps):
        ti = tts.queue_tx_in(TSPEC, 4, msgs if i == 0 else [],
                             device="cpu")[0]
        out = ex.push((ti, air))
        outs.append(out.rx)
        air = ch.push(out.tx.samples)
    return trs.collect_frames(outs)


def test_radio_full_duplex_hard_and_soft():
    msgs = [b"full duplex hello %d" % i for i in range(3)]
    n_steps = 3 + -(-trs.history_len(TSPEC) // RADIO_SC.block_size) + 1
    for eq, out in (("pilot_phase", "hard"), ("simpledfe", "soft")):
        frames = _loopback(tradio.ofdm_radio(TSPEC, RADIO_SC, equalizer=eq,
                                             output=out), n_steps, msgs)
        assert [f["payload"] for f in frames] == msgs
        assert all(f["crc_ok"] for f in frames)
        for f in frames:
            if out == "hard":
                assert "llr" not in f
                continue
            wire = np.frombuffer(f["payload"], np.uint8)
            bits = np.unpackbits(wire)
            assert f["llr"].shape == ((len(wire) + 4) * 8,)
            np.testing.assert_array_equal(f["llr"][: len(bits)] < 0,
                                          bits.astype(bool))


def test_radio_resumes_from_a_jax_carry():
    """One JAX radio step takes three PDUs and emits the first block; the
    rest wait in its TX carry.  The port then continues from that carry,
    looping its TX output back into its RX, and receives every PDU, as the
    JAX radio continuing on its own does."""
    sc = StreamConfig(block_size=1024, max_frames_per_block=4)
    msgs = [b"carried over %d" % i for i in range(3)]   # 464 samples each
    jx = jex.StreamExecutor(jradio.ofdm_radio(SPEC, sc), 1024, donate=False)
    ti, _ = jts.queue_tx_in(SPEC, 4, msgs)
    first = jx.push((tuple(ti), np.zeros(1024, np.complex64)))
    ex = tex.StreamExecutor(tradio.ofdm_radio(TSPEC, sc), 1024, device="cpu")
    ex.state = tradio.carry_from_jax(jax.tree.map(np.asarray, jx.state),
                                     ex.device)
    assert int(ex.state[0][1]) > 0            # frames still pending
    jair = np.asarray(first.tx.samples)
    tair = torch.tensor(jair)
    jouts, touts = [], []
    for _ in range(5):
        jo = jx.push((tuple(jts.empty_tx_in(SPEC, 4)), jair))
        to = ex.push((tts.empty_tx_in(TSPEC, 4, "cpu"), tair))
        jouts.append(jo.rx)
        touts.append(to.rx)
        jair, tair = np.asarray(jo.tx.samples), to.tx.samples
    jf, tf = jrs.collect_frames(jouts), trs.collect_frames(touts)
    assert [f["payload"] for f in tf] == [f["payload"] for f in jf] == msgs
    assert all(f["crc_ok"] for f in tf)
    assert [f["abs_start"] for f in tf] == [f["abs_start"] for f in jf]
    (buf, cur), (hist, step) = tradio.carry_to_jax(ex.state)
    np.testing.assert_allclose(buf, np.asarray(jx.state[0][0]), atol=1e-5)
    np.testing.assert_allclose(hist, np.asarray(jx.state[1][0]), atol=1e-5)
    assert int(cur) == int(np.asarray(jx.state[0][1]))
    assert int(step) == int(np.asarray(jx.state[1][1])) == 6


@functools.lru_cache(maxsize=None)
def _windows():
    """Derotated frame windows at the JAX detections on a golden-TX buffer
    with CFO and noise (tests/test_torch_rx.py's layout)."""
    rng = np.random.RandomState(4)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    n = 40000
    x = np.zeros(n, np.complex128)
    for i, p in enumerate([700, 6100, 13300, 20777, 31000]):
        msg = rng.randint(0, 256, 20 + 45 * i).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=100 + i)
        x[p:p + len(f)] += f * np.exp(0.3j * i)
    x *= np.exp(2j * np.pi * 0.27 * np.arange(n) / 64)
    x += 0.05 * (rng.randn(n) + 1j * rng.randn(n))
    x = x.astype(np.complex64)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda a: jrx.rx_block(spec, a, 8))(jnp.asarray(x)))
    F = spec.max_frame_len
    starts = np.clip(ref.starts, 0, n - F)
    wins = np.stack([x[s:s + F] for s in starts])
    der = np.array(jax.vmap(lambda w, c: jderotate(w, c, 64))(
        jnp.asarray(wins), jnp.asarray(ref.fine_cfo)))
    return spec, der, ref.valid


def test_simpledfe_and_soft_output_match_jax_demod_frame():
    spec, der, v = _windows()
    tspec = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    assert v.sum() == 5
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda w: jrx.demod_frame(spec, w, equalizer="simpledfe",
                                  output="soft")))(jnp.asarray(der)))
    got = trx.demod_frame(tspec, torch.tensor(der), equalizer="simpledfe",
                          output="soft")
    for name in ("payload", "payload_len", "frame_num", "hdr_ok", "crc_ok",
                 "int_cfo", "sym_mask", "sync_ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[v],
                                      getattr(want, name)[v], err_msg=name)
    assert got.crc_ok.numpy()[v].all()
    np.testing.assert_allclose(got.data_syms.numpy()[v], want.data_syms[v],
                               atol=1e-4)
    np.testing.assert_allclose(got.evm.numpy()[v], want.evm[v], rtol=1e-3)
    llr, jllr = got.llr.numpy()[v], want.llr[v]
    assert llr.shape == jllr.shape == (5, spec.max_payload_ofdm_syms
                                       * spec.n_data * 2)
    np.testing.assert_allclose(llr, jllr, rtol=1e-3,
                               atol=1e-3 * np.abs(jllr).max())
    hard = trx.demod_frame(tspec, torch.tensor(der))
    assert hard.llr.shape == (8, 0)
    np.testing.assert_array_equal(hard.payload.numpy()[v],
                                  got.payload.numpy()[v])


def test_rx_stream_soft_simpledfe_matches_jax():
    """The soft/simpledfe streaming receiver on a short stream: the same
    frames as the JAX package's, with LLRs of the wire bytes."""
    spec, der, v = _windows()
    tspec = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    sc = StreamConfig(block_size=1 << 13, max_frames_per_block=8)
    stream = np.concatenate([w[: spec.max_frame_len] for w in der[v]]
                            + [np.zeros(3000, np.complex64)])
    kw = dict(equalizer="simpledfe", output="soft")
    ref = jrs.collect_frames(jex.StreamExecutor(
        jrs.rx_stream_block(spec, sc, **kw), sc.block_size).run(
        stream, drain=True))
    got = trs.collect_frames(tex.StreamExecutor(
        trs.rx_stream_block(tspec, sc, **kw), sc.block_size,
        device="cpu").run(
        torch.as_tensor(stream), drain=True))
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert (a["payload"], a["frame_num"], a["crc_ok"]) == (
            b["payload"], b["frame_num"], b["crc_ok"])
        np.testing.assert_allclose(a["llr"], b["llr"], rtol=1e-3,
                                   atol=1e-3 * np.abs(b["llr"]).max())
