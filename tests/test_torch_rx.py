"""The port's batched demod_frame and rx_block against the JAX package's
rx_block on a golden-TX buffer with CFO and noise.

Integers, bits and bytes must be identical on valid slots; starts agree to
+-2 samples (the chop tolerance tests/test_stream.py grants: window sums
from a float32 vs a float64 cumsum can flip near-tied plateau samples),
fine CFO to atol 1e-3, EVM to rtol 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.modem import rx as jrx
from tpu_ofdm.ops.sync import derotate as jderotate
from tpu_ofdm_torch.modem import rx as trx

SPEC = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
TSPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
K = 8
POSITIONS = [700, 6100, 13300, 20777, 31000]


def _buffer(seed=0, cfo=1.13, n=40000):
    """Golden frames of assorted lengths at POSITIONS, then an integer +
    fractional CFO and complex noise."""
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    x = np.zeros(n, np.complex128)
    payloads = []
    for i, p in enumerate(POSITIONS):
        msg = rng.randint(0, 256, 20 + 45 * i).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=100 + i)
        x[p:p + len(f)] += f
        payloads.append(msg)
    x *= np.exp(2j * np.pi * cfo * np.arange(n) / 64)
    x += 0.05 * (rng.randn(n) + 1j * rng.randn(n))
    return x.astype(np.complex64), payloads


def _jax_rx(x, **kw):
    res = jax.jit(lambda a: jrx.rx_block(SPEC, a, K, **kw))(jnp.asarray(x))
    return jax.tree.map(np.asarray, res)


def _port_rx(x, head=None, **kw):
    res = trx.rx_block(TSPEC, torch.as_tensor(x), K,
                       head=None if head is None else torch.as_tensor(head),
                       **kw)
    return res


def _assert_same_frames(port, ref):
    v = ref.valid
    np.testing.assert_array_equal(port.valid.numpy(), v)
    pf, rf = port.frames, ref.frames
    for name in ("payload", "payload_len", "frame_num", "hdr_ok", "crc_ok",
                 "int_cfo", "sym_mask", "sync_ok"):
        np.testing.assert_array_equal(getattr(pf, name).numpy()[v],
                                      getattr(rf, name)[v], err_msg=name)
    assert np.abs(port.starts.numpy()[v] - ref.starts[v]).max() <= 2
    np.testing.assert_allclose(port.fine_cfo.numpy()[v], ref.fine_cfo[v],
                               atol=1e-3)
    np.testing.assert_allclose(pf.evm.numpy()[v], rf.evm[v], rtol=1e-3)
    np.testing.assert_allclose(pf.sync_q.numpy()[v], rf.sync_q[v], rtol=1e-3)


def test_rx_block_matches_jax():
    x, payloads = _buffer()
    ref = _jax_rx(x)
    port = _port_rx(x)
    _assert_same_frames(port, ref)
    v = ref.valid
    assert v.sum() == len(POSITIONS)
    f = port.frames
    assert f.crc_ok.numpy()[v].all()
    # the fine estimate spans +-1 subcarrier, so 1.13 = 2 - 0.87
    total = f.int_cfo.numpy()[v] + port.fine_cfo.numpy()[v]
    np.testing.assert_allclose(total, 1.13, atol=0.02)
    got = [bytes(p[:n]) for p, n in zip(f.payload.numpy()[v],
                                        f.payload_len.numpy()[v])]
    assert got == payloads
    for s, p in zip(port.starts.numpy()[v], POSITIONS):
        assert p <= s <= p + SPEC.cp_len


def test_rx_block_ownership_window_matches_jax():
    x, _ = _buffer(seed=1, cfo=-0.31)
    kw = dict(own_lo=5000, own_hi=21000)
    ref = _jax_rx(x, **kw)
    port = _port_rx(x, **kw)
    _assert_same_frames(port, ref)
    assert ref.valid.sum() == 3


@pytest.mark.parametrize("h", [3072, 6500])
def test_rx_block_head_split_equals_concat(h):
    """rx_block over [head | x] in place is rx_block on the concatenation,
    with a frame straddling the seam (h = 6500 cuts the frame at 6100)."""
    x, _ = _buffer(seed=2)
    split = _port_rx(x[h:], head=x[:h])
    whole = _port_rx(x)
    for a, b in zip(jax.tree.leaves(tuple(split)), jax.tree.leaves(tuple(whole))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(split.valid.sum()) == len(POSITIONS)


def test_demod_frame_batched_matches_vmapped_jax():
    """The batched demod_frame over K windows equals JAX's demod_frame
    vmapped over the same (derotated) windows."""
    x, _ = _buffer(seed=3, cfo=0.27)
    ref = _jax_rx(x)
    F = SPEC.max_frame_len
    starts = np.clip(ref.starts, 0, len(x) - F)
    wins = np.stack([x[s:s + F] for s in starts])
    der = np.array(jax.vmap(lambda w, c: jderotate(w, c, 64))(
        jnp.asarray(wins), jnp.asarray(ref.fine_cfo)))
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda w: jrx.demod_frame(SPEC, w)))(jnp.asarray(der)))
    got = trx.demod_frame(TSPEC, torch.as_tensor(der))
    v = ref.valid
    assert v.sum() == len(POSITIONS)
    for name in ("payload", "payload_len", "frame_num", "hdr_ok", "crc_ok",
                 "int_cfo", "sym_mask", "sync_ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[v],
                                      getattr(want, name)[v], err_msg=name)
    np.testing.assert_allclose(got.data_syms.numpy()[v], want.data_syms[v],
                               atol=1e-5)
    np.testing.assert_allclose(got.evm.numpy()[v], want.evm[v], rtol=1e-3)
