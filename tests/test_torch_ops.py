"""The port's RX ops against their JAX counterparts on the same numpy
inputs.  Bits, bytes and integers must be identical; complex values agree
to atol 1e-5 (float32 arithmetic in a different order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from tpu_ofdm import config as jconfig
from tpu_ofdm.ops import carrier_alloc as jca
from tpu_ofdm.ops import chanest as jce
from tpu_ofdm.ops import constellation as jcon
from tpu_ofdm.ops import crc as jcrc
from tpu_ofdm.ops import equalizer as jeq
from tpu_ofdm.ops import header as jhdr
from tpu_ofdm.ops import sync as jsync
from tpu_ofdm.ops import transform as jtr
from tpu_ofdm.utils import bits as jbits
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.ops import carrier_alloc as tca
from tpu_ofdm_torch.ops import chanest as tce
from tpu_ofdm_torch.ops import constellation as tcon
from tpu_ofdm_torch.ops import crc as tcrc
from tpu_ofdm_torch.ops import equalizer as teq
from tpu_ofdm_torch.ops import header as thdr
from tpu_ofdm_torch.ops import sync as tsync
from tpu_ofdm_torch.ops import transform as ttr
from tpu_ofdm_torch.utils import bits as tbits

SPEC = jconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
TSPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
MODS = ["bpsk", "qpsk", "qam16", "qam64"]


def _cplx(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _np(t):
    return np.array(t)   # a writable copy: torch warns on read-only arrays


# BASELINE.json configs 1-5, as bench/curves.py, bench/wideband.py and
# bench/scaling.py configure them, and fft 64 / 256 at the defaults
SPEC_CASES = {
    "config1": dict(fft_len=64, cp_len=16, modulation="bpsk",
                    max_payload_bytes=64),
    "config2": dict(fft_len=256, cp_len=64, modulation="qpsk",
                    max_payload_bytes=256),
    "config3": dict(fft_len=64, cp_len=16, modulation="qam16",
                    max_payload_bytes=64),
    "config4": dict(fft_len=64, cp_len=16, modulation="qpsk",
                    max_payload_bytes=64),
    "config5": dict(fft_len=64, cp_len=16, modulation="qpsk",
                    max_payload_bytes=64),
    "fft64": dict(fft_len=64),
    "fft64_rolloff": dict(fft_len=64, modulation="qam64", rolloff_len=4),
    "fft256": dict(fft_len=256, cp_len=32),
}


def _assert_spec_equal(t, j):
    assert set(vars(t)) == set(vars(j))
    for name, want in vars(j).items():
        got = getattr(t, name)
        if name == "cfg":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            assert np.array_equal(got, want), name
        else:
            assert got == want, name
    for wire_bytes in (1, 17, 252):
        assert t.frame_len(wire_bytes) == j.frame_len(wire_bytes)


@pytest.mark.parametrize("kw", SPEC_CASES.values(), ids=SPEC_CASES.keys())
def test_port_spec_equals_jax_spec(kw):
    """The port's own config builds the same spec as the JAX package's."""
    t = tconfig.OfdmConfig(**kw).spec
    j = jconfig.OfdmConfig(**kw).spec
    assert t is tconfig.OfdmConfig(**kw).spec          # cached per config
    _assert_spec_equal(t, j)
    assert tconfig.HEADER_BITS == jconfig.HEADER_BITS == 32
    for name in ("HEADER_LEN_BITS", "HEADER_NUM_BITS", "HEADER_CRC_BITS",
                 "BITS_PER_SYMBOL"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    assert (dataclasses.asdict(tconfig.StreamConfig())
            == dataclasses.asdict(jconfig.StreamConfig()))
    r = tconfig.replace(tconfig.OfdmConfig(**kw), sync_threshold=0.5)
    assert r.sync_threshold == 0.5 and isinstance(r, tconfig.OfdmConfig)


def test_table_builders_match():
    for cap in (1, 7, 256):
        for a, b in zip(tcrc._crc32_basis_np(cap), jcrc._crc32_basis_np(cap)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcrc._crc32_table_np(),
                                  jcrc._crc32_table_np())
    np.testing.assert_array_equal(tcrc._crc8_powers_np(24),
                                  jcrc._crc8_powers_np(24))
    for m in MODS:
        np.testing.assert_array_equal(tcon.points_np(m), jcon.points_np(m))
    for shift in (1, 4):
        np.testing.assert_array_equal(tce._rolled_refs_np(TSPEC, shift),
                                      jce._rolled_refs_np(SPEC, shift))


def test_bits_exact():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, (5, 96)).astype(np.uint8)
    np.testing.assert_array_equal(
        tbits.bits_to_bytes(torch.as_tensor(bits)).numpy(),
        _np(jbits.bits_to_bytes(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        tbits.bits_to_uint(torch.as_tensor(bits), 12).numpy(),
        _np(jbits.bits_to_uint(jnp.asarray(bits), 12)))
    vals = rng.randint(0, 64, (3, 50)).astype(np.uint32)
    np.testing.assert_array_equal(
        tbits.ungroup_bits(torch.as_tensor(vals.astype(np.int64)), 6).numpy(),
        _np(jbits.ungroup_bits(jnp.asarray(vals), 6)))


def test_crc32_batched_exact():
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, (6, 40)).astype(np.uint8)
    lens = np.array([0, 1, 5, 17, 39, 40], np.int32)
    got = tcrc.crc32(torch.as_tensor(data), torch.as_tensor(lens)).numpy()
    want = [int(jcrc.crc32(jnp.asarray(d), int(n))) for d, n in zip(data, lens)]
    np.testing.assert_array_equal(got, want)
    assert got[4] == G.crc32(bytes(data[4, :39]))
    full = tcrc.crc32(torch.as_tensor(data)).numpy()
    assert list(full) == [G.crc32(bytes(d)) for d in data]


def test_check_crc32_batched_exact():
    rng = np.random.RandomState(2)
    cap = 64
    bufs, lens = [], []
    for i, n in enumerate([0, 3, 10, 30, 60]):
        wire = np.frombuffer(G.append_crc32(bytes(rng.randint(0, 256, n)
                                                  .astype(np.uint8))),
                             np.uint8).copy()
        if i % 2:
            wire[rng.randint(len(wire))] ^= 0x10      # corrupt odd rows
        buf = np.zeros(cap, np.uint8)
        buf[: len(wire)] = wire
        bufs.append(buf)
        lens.append(len(wire))
    bufs.append(np.zeros(cap, np.uint8))             # wire_len < 4
    lens.append(2)
    bufs, lens = np.stack(bufs), np.array(lens, np.int32)
    got = tcrc.check_crc32(torch.as_tensor(bufs), torch.as_tensor(lens))
    want = jax.vmap(jcrc.check_crc32)(jnp.asarray(bufs), jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [True, False, True, False, True, False])


def test_crc8_and_header_exact():
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2, (10, 24)).astype(np.uint8)
    np.testing.assert_array_equal(
        tcrc.crc8_bits(torch.as_tensor(bits)).numpy(),
        _np(jcrc.crc8_bits(jnp.asarray(bits))))
    hdrs = [G.make_header_bits(n, f) for n, f in [(4, 0), (260, 7), (4095, 4095)]]
    hdrs += list(rng.randint(0, 2, (5, 32)))
    hdrs = np.stack(hdrs).astype(np.uint8)
    got = thdr.parse_header_bits(torch.as_tensor(hdrs))
    want = jax.vmap(jhdr.parse_header_bits)(jnp.asarray(hdrs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert got[2][:3].all()


@pytest.mark.parametrize("mod", MODS)
def test_constellation_demap_and_evm(mod):
    rng = np.random.RandomState(4)
    sym = _cplx(rng, 4, 200) * 0.7
    mask = np.arange(200)[None, :] < np.array([[0], [1], [77], [200]])
    ts = torch.as_tensor(sym)
    np.testing.assert_array_equal(
        tcon.hard_decisions(ts, mod).numpy(),
        _np(jcon.hard_decisions(jnp.asarray(sym), mod)))
    np.testing.assert_array_equal(
        tcon.demap_hard(ts, mod).numpy(),
        _np(jcon.demap_hard(jnp.asarray(sym), mod)))
    got = tcon.evm(ts, mod, mask=torch.as_tensor(mask)).numpy()
    want = jax.vmap(lambda s, m: jcon.evm(s, mod, mask=m))(
        jnp.asarray(sym), jnp.asarray(mask))
    np.testing.assert_allclose(got, _np(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcon.evm(ts[1], mod).numpy(), _np(jcon.evm(jnp.asarray(sym[1]), mod)),
        rtol=1e-5)


def test_fft_serialize_equalize():
    rng = np.random.RandomState(5)
    td = _cplx(rng, 3, 5, 64)
    g_t = ttr.ofdm_fft(torch.as_tensor(td))
    g_j = jtr.ofdm_fft(jnp.asarray(td))
    np.testing.assert_allclose(g_t.numpy(), _np(g_j), atol=1e-5)
    grids = _np(g_j)
    np.testing.assert_array_equal(
        tca.serialize(TSPEC, torch.as_tensor(grids)).numpy(),
        _np(jca.serialize(SPEC, jnp.asarray(grids))))
    H = _cplx(rng, 3, 64)
    H[0, 5] = 0                                   # exercises the |H| guard
    got = teq.equalize_pilot_phase(TSPEC, torch.as_tensor(grids),
                                   torch.as_tensor(H))
    want = jeq.equalize_pilot_phase(SPEC, jnp.asarray(grids), jnp.asarray(H))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_chanest():
    rng = np.random.RandomState(6)
    shifts = np.array([-4, -1, 0, 2, 4], np.int32)
    sw1 = np.stack([np.roll(SPEC.sync_word1_freq, s) for s in shifts])
    rx1 = (sw1 + 0.1 * _cplx(rng, 5, 64)).astype(np.complex64)
    ic_t = tce.coarse_int_cfo(TSPEC, torch.as_tensor(rx1)).numpy()
    ic_j = _np(jce.coarse_int_cfo(SPEC, jnp.asarray(rx1)))
    np.testing.assert_array_equal(ic_t, ic_j)
    np.testing.assert_array_equal(ic_t, shifts)

    grid = _cplx(rng, 5, 3, 64)
    got = tce.roll_bins(torch.as_tensor(grid), torch.as_tensor(shifts))
    want = jax.vmap(jce.roll_bins)(jnp.asarray(grid), jnp.asarray(shifts))
    np.testing.assert_array_equal(got.numpy(), _np(want))

    sync2 = _cplx(rng, 5, 64)
    np.testing.assert_allclose(
        tce.ls_estimate(TSPEC, torch.as_tensor(sync2)).numpy(),
        _np(jce.ls_estimate(SPEC, jnp.asarray(sync2))), atol=1e-5)


def test_derotate_and_sliding_max():
    rng = np.random.RandomState(7)
    r = _cplx(rng, 4, 2000)
    cfo = np.array([-0.49, 0.0, 0.13, 0.5], np.float32)
    got = tsync.derotate(torch.as_tensor(r), torch.as_tensor(cfo), 64)
    want = jax.vmap(lambda a, c: jsync.derotate(a, c, 64))(
        jnp.asarray(r), jnp.asarray(cfo))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)

    x = rng.randn(3, 300).astype(np.float32)
    for w, pad_left in [(1, 0), (5, 2), (7, 3), (13, 6)]:
        np.testing.assert_array_equal(
            tsync.sliding_max_same(torch.as_tensor(x), w, pad_left).numpy(),
            _np(jsync.sliding_max_same(jnp.asarray(x), w, pad_left)))
    for fft_len, cp in [(64, 16), (256, 64), (1024, 256)]:
        assert (tsync.min_frame_gap(
                    tconfig.OfdmConfig(fft_len=fft_len, cp_len=cp).spec)
                == jsync.min_frame_gap(
                    jconfig.OfdmConfig(fft_len=fft_len, cp_len=cp).spec))
