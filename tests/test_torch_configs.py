"""BASELINE configs 1-3 (bench/curves.py:49-68: BPSK at fft 64; QPSK at
fft 256 / cp 64 with CFO 1.3 subcarriers; 16-QAM at fft 64 over multipath
with soft output) through the port against the JAX package, on the same
numpy inputs: golden frames, then the config's taps and CFO applied in
float64 numpy, then noise.

- rx_block on one buffer, at each config;
- the streaming receiver across block seams, at configs 2 and 3;
- the full-duplex radio through channel_block without noise (so both
  packages see the same samples), at configs 2 and 3.

The JAX side takes bench.curves.baseline_configs(); the port's configs are
built from tpu_ofdm_torch.config with the same fields.  Integers, bits and
bytes identical on valid slots; starts within 2 samples, fine CFO to atol
1e-3, EVM to rtol 1e-3 (tests/test_torch_rx.py's tolerances); LLRs to atol
1e-4 times their largest magnitude, signs identical.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from bench.curves import baseline_configs
from tpu_ofdm.config import StreamConfig
from tpu_ofdm.modem import radio as jradio
from tpu_ofdm.modem import rx as jrx
from tpu_ofdm.modem import rx_stream as jrs
from tpu_ofdm.modem import tx_stream as jts
from tpu_ofdm.ops.channel import channel_block as jchannel_block
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.modem import radio as tradio
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem import rx_stream as trs
from tpu_ofdm_torch.modem import tx_stream as tts
from tpu_ofdm_torch.ops.channel import channel_block
from tpu_ofdm_torch.stream import executor as tex

CONFIGS = {cc.name: cc for cc in baseline_configs()}
NAMES = list(CONFIGS)
K = 8
S = 1 << 14            # stream block: every buffer stays under 2^16 samples


def _port_spec(cc):
    """The port's spec of a JAX CurveConfig, from the same config fields."""
    return tconfig.OfdmConfig(**{f.name: getattr(cc.cfg, f.name)
                                 for f in dataclasses.fields(cc.cfg)}).spec


def _impaired(cc, x, seed, noise):
    """x (float64 complex) through the config's taps and CFO in numpy (the
    golden channel's order), then complex noise of `noise` rms per axis."""
    rng = np.random.RandomState(seed)
    if cc.taps is not None:
        x = np.convolve(x, np.asarray(cc.taps, np.complex128))[: len(x)]
    x = x * np.exp(2j * np.pi * cc.cfo * np.arange(len(x)) / cc.cfg.fft_len)
    x = x + noise * (rng.randn(len(x)) + 1j * rng.randn(len(x)))
    return x.astype(np.complex64)


def _frames_at(cc, n, positions, seed):
    """Golden frames of assorted lengths (up to the config's largest
    payload) at `positions` in n zeros; returns (buffer, payloads)."""
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=cc.cfg.fft_len, cp_len=cc.cfg.cp_len,
                            modulation=cc.cfg.modulation)
    cap = cc.cfg.max_payload_bytes - 4
    x = np.zeros(n, np.complex128)
    payloads = []
    for i, p in enumerate(positions):
        size = cap if i == 0 else 1 + (37 * i) % cap
        msg = rng.randint(0, 256, size).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=10 + i)
        x[p:p + len(f)] += f
        payloads.append(msg)
    return x, payloads


def _slack(cc):
    return 0 if cc.taps is None else len(cc.taps) - 1


def _assert_llrs(a, b):
    """Port LLRs a against JAX LLRs b: atol 1e-4 of their largest
    magnitude, signs identical."""
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert scale > 0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(a > 0, b > 0)


# -- rx_block on one buffer ---------------------------------------------------

N_BLOCK = 60000
BLOCK_POSITIONS = [700, 12000, 24500, 37001, 49000]


@functools.lru_cache(maxsize=None)
def _block(name):
    cc = CONFIGS[name]
    x, payloads = _frames_at(cc, N_BLOCK, BLOCK_POSITIONS, seed=1)
    return _impaired(cc, x, seed=2, noise=0.03), payloads


@pytest.mark.parametrize("name", NAMES)
def test_rx_block_matches_jax(name):
    cc = CONFIGS[name]
    spec, tspec = cc.cfg.spec, _port_spec(cc)
    x, payloads = _block(name)
    ref = jax.tree.map(np.asarray, jax.jit(lambda a: jrx.rx_block(
        spec, a, K, output=cc.output))(jnp.asarray(x)))
    port = trx.rx_block(tspec, torch.as_tensor(x), K, output=cc.output)
    v = ref.valid
    assert v.sum() == len(BLOCK_POSITIONS)
    np.testing.assert_array_equal(port.valid.numpy(), v)
    pf, rf = port.frames, ref.frames
    for field in ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok",
                  "int_cfo"):
        np.testing.assert_array_equal(getattr(pf, field).numpy()[v],
                                      getattr(rf, field)[v], err_msg=field)
    assert np.abs(port.starts.numpy()[v] - ref.starts[v]).max() <= 2
    np.testing.assert_allclose(port.fine_cfo.numpy()[v], ref.fine_cfo[v],
                               atol=1e-3)
    np.testing.assert_allclose(pf.evm.numpy()[v], rf.evm[v], rtol=1e-3)
    if cc.output == "soft":
        _assert_llrs(pf.llr.numpy()[v], rf.llr[v])
    else:
        assert pf.llr.shape[-1] == 0
    # and against what went in
    assert pf.crc_ok.numpy()[v].all()
    got = [bytes(p[:n]) for p, n in zip(pf.payload.numpy()[v],
                                        pf.payload_len.numpy()[v])]
    assert got == payloads
    for s, p in zip(port.starts.numpy()[v], BLOCK_POSITIONS):
        assert p <= s <= p + cc.cfg.cp_len + _slack(cc)
    if cc.cfo:
        total = pf.int_cfo.numpy()[v] + port.fine_cfo.numpy()[v]
        np.testing.assert_allclose(total, cc.cfo, atol=0.02)


# -- the streaming receiver across seams -------------------------------------

# frame starts straddling the seams at S, 2S and 4S, and one mid-block
STREAM_POSITIONS = [S - 700, 2 * S - 1, 2 * S + 6000, 4 * S - 1500]
STREAM_NAMES = NAMES[1:]          # configs 2 and 3


def _collected_same(port, ref, soft, noiseless=False):
    """collect_frames lists of the two packages.  `noiseless`: the EVM is
    float32 rounding (~1e-6), so it is held at atol 1e-5 (the LLRs' noise
    variance, EVM^2, is then clamped to 1e-6 in both packages)."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for k in ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok",
                  "int_cfo"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["abs_start"] - b["abs_start"]) <= 2, (a, b)
        np.testing.assert_allclose(a["fine_cfo"], b["fine_cfo"], atol=1e-3)
        np.testing.assert_allclose(a["evm"], b["evm"], rtol=1e-3,
                                   atol=1e-5 if noiseless else 0)
        if soft:
            _assert_llrs(a["llr"], b["llr"])


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_rx_stream_matches_jax_across_seams(name):
    cc = CONFIGS[name]
    spec, tspec = cc.cfg.spec, _port_spec(cc)
    x, payloads = _frames_at(cc, 5 * S - 3000, STREAM_POSITIONS, seed=3)
    x = _impaired(cc, x, seed=4, noise=0.03)
    sc = StreamConfig(block_size=S, max_frames_per_block=K)
    tsc = tconfig.StreamConfig(block_size=S, max_frames_per_block=K)
    H = jrs.history_len(spec)
    assert trs.history_len(tspec) == H
    ref = jrs.collect_frames(jex.StreamExecutor(jrs.rx_stream_block(
        spec, sc, output=cc.output), S).run(x, drain=True),
        block_size=S, hist=H)
    port = trs.collect_frames(tex.StreamExecutor(trs.rx_stream_block(
        tspec, tsc, output=cc.output), S, device="cpu").run(
        torch.as_tensor(x), drain=True), block_size=S, hist=H)
    _collected_same(port, ref, cc.output == "soft")
    assert [f["payload"] for f in port] == payloads
    assert all(f["crc_ok"] for f in port)
    for f, p in zip(port, STREAM_POSITIONS):
        assert p <= f["abs_start"] <= p + cc.cfg.cp_len + _slack(cc)


# -- the radio through the channel fixture, without noise --------------------

RADIO_S = 1 << 13
RADIO_K = 4


def _radio_frames(name):
    """Both packages' radios, each TX block through the package's own
    channel_block (the config's CFO or taps, no noise) into its RX half one
    push later; returns (port frames, JAX frames, PDUs, per-push max
    difference of the two channels' outputs)."""
    cc = CONFIGS[name]
    spec, tspec = cc.cfg.spec, _port_spec(cc)
    cap = cc.cfg.max_payload_bytes - 4
    msgs = [bytes([(7 * i + j) % 256 for j in range(cap - 9 * i)])
            for i in range(3)]
    sc = StreamConfig(block_size=RADIO_S, max_frames_per_block=RADIO_K)
    kw = dict(cfo=cc.cfo, fft_len=cc.cfg.fft_len, taps=cc.taps)
    jx = jex.StreamExecutor(jradio.ofdm_radio(spec, sc, output=cc.output),
                            RADIO_S)
    jch = jex.StreamExecutor(jchannel_block(seed=5, **kw), RADIO_S)
    ex = tex.StreamExecutor(tradio.ofdm_radio(tspec, sc, output=cc.output),
                            RADIO_S, device="cpu")
    ch = tex.StreamExecutor(channel_block(seed=5, **kw), RADIO_S,
                            device="cpu")
    n_steps = 3 + -(-trs.history_len(tspec) // RADIO_S) + 1
    jair = np.zeros(RADIO_S, np.complex64)
    tair = torch.zeros(RADIO_S, dtype=torch.complex64)
    jouts, touts, diffs = [], [], []
    for i in range(n_steps):
        batch = msgs if i == 0 else []
        jo = jx.push((tuple(jts.queue_tx_in(spec, RADIO_K, batch)[0]), jair))
        to = ex.push((tts.queue_tx_in(tspec, RADIO_K, batch,
                                      device="cpu")[0], tair))
        jouts.append(jo.rx)
        touts.append(to.rx)
        jair = np.asarray(jch.push(np.asarray(jo.tx.samples)))
        tair = ch.push(to.tx.samples)
        diffs.append(float(np.abs(tair.numpy() - jair).max()))
    return (trs.collect_frames(touts), jrs.collect_frames(jouts), msgs,
            diffs)


@pytest.mark.parametrize("name", STREAM_NAMES)
def test_radio_through_channel_matches_jax(name):
    cc = CONFIGS[name]
    port, ref, msgs, diffs = _radio_frames(name)
    # both channels rotate in float32 (and filter) the same samples
    assert max(diffs) <= 1e-4
    _collected_same(port, ref, cc.output == "soft", noiseless=True)
    assert [f["payload"] for f in port] == msgs
    assert all(f["crc_ok"] for f in port)
    assert [f["abs_start"] for f in port] == [f["abs_start"] for f in ref]
