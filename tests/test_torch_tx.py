"""The port's TX ops and transmitter against the JAX package's and the
golden model's, on the same seeded inputs.

Bits, header bits, CRC bytes, symbols and grids must be identical.  Time
samples come from torch.fft here and from a float32 matmul DFT in the JAX
package, so they agree to atol 1e-5 * scale (the IFFT of unit-power
carriers); payloads decoded from either TX must be identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.modem import tx as jtx
from tpu_ofdm.ops import carrier_alloc as jca
from tpu_ofdm.ops import constellation as jcon
from tpu_ofdm.ops import crc as jcrc
from tpu_ofdm.ops import header as jhdr
from tpu_ofdm.ops import transform as jtr
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem import tx as ttx
from tpu_ofdm_torch.ops import carrier_alloc as tca
from tpu_ofdm_torch.ops import constellation as tcon
from tpu_ofdm_torch.ops import crc as tcrc
from tpu_ofdm_torch.ops import header as thdr
from tpu_ofdm_torch.ops import transform as ttr
from tpu_ofdm_torch.utils import bits as tbits

MODS = ["bpsk", "qpsk", "qam16", "qam64"]


@pytest.mark.parametrize("mod", MODS)
def test_map_bits_matches_jax(mod):
    k = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}[mod]
    bits = np.random.RandomState(k).randint(0, 2, (3, 60 * k)).astype(np.uint8)
    got = tcon.map_bits(torch.as_tensor(bits), mod).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcon.map_bits(bits, mod)))
    np.testing.assert_array_equal(tcon.bit_masks_np(mod),
                                  jcon.bit_masks_np(mod))


def test_bit_packing_matches_jax():
    from tpu_ofdm.utils import bits as jbits

    data = np.random.RandomState(0).randint(0, 256, (2, 17)).astype(np.uint8)
    np.testing.assert_array_equal(
        tbits.bytes_to_bits(torch.as_tensor(data)).numpy(),
        np.asarray(jbits.bytes_to_bits(jnp.asarray(data))))
    vals = np.array([[0, 5, 4095], [17, 1, 2048]], np.uint32)
    np.testing.assert_array_equal(
        tbits.uint_to_bits(torch.as_tensor(vals.astype(np.int64)), 12).numpy(),
        np.asarray(jbits.uint_to_bits(jnp.asarray(vals), 12)))
    bits = np.random.RandomState(1).randint(0, 2, (3, 24)).astype(np.uint8)
    np.testing.assert_array_equal(
        tbits.group_bits(torch.as_tensor(bits), 4).numpy(),
        np.asarray(jbits.group_bits(jnp.asarray(bits), 4)))


def test_header_and_crc_bytes_match_jax():
    lens = np.array([4, 5, 35, 256, 4095], np.int32)
    nums = np.array([0, 1, 4095, 4096, 70000], np.int32)
    got = thdr.make_header_bits(torch.as_tensor(lens), torch.as_tensor(nums))
    want = jhdr.make_header_bits(jnp.asarray(lens), jnp.asarray(nums))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plen, fnum, ok = thdr.parse_header_bits(got)
    assert ok.all() and (plen.numpy() == lens).all()
    assert (fnum.numpy() == nums % 4096).all()
    crc = np.array([0, 0xDEADBEEF, 0xFFFFFFFF, 0x01020304], np.uint32)
    np.testing.assert_array_equal(
        tcrc.append_crc32_bytes(torch.as_tensor(crc.astype(np.int64))).numpy(),
        np.asarray(jcrc.append_crc32_bytes(jnp.asarray(crc))))


@pytest.mark.parametrize("fft_len", [64, 256])
def test_allocate_and_sync_grids_match_jax(fft_len):
    spec = OfdmConfig(fft_len=fft_len, cp_len=fft_len // 4).spec
    tspec = tconfig.OfdmConfig(fft_len=fft_len, cp_len=fft_len // 4).spec
    rng = np.random.RandomState(2)
    syms = (rng.randn(2, 3 * spec.n_data)
            + 1j * rng.randn(2, 3 * spec.n_data)).astype(np.complex64)
    got = tca.allocate(tspec, torch.as_tensor(syms)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jca.allocate(spec, jnp.asarray(syms))))
    np.testing.assert_array_equal(
        tca.serialize(tspec, torch.as_tensor(got)).numpy(), syms)
    np.testing.assert_array_equal(tca.sync_grids(tspec, (4,), "cpu").numpy(),
                                  np.asarray(jca.sync_grids(spec, (4,))))


@pytest.mark.parametrize("rolloff", [0, 4, 16])
def test_ifft_and_cyclic_prefix_match_jax(rolloff):
    spec = OfdmConfig(rolloff_len=rolloff).spec
    tspec = tconfig.OfdmConfig(rolloff_len=rolloff).spec
    rng = np.random.RandomState(3)
    grid = (rng.randn(2, 5, 64) + 1j * rng.randn(2, 5, 64)).astype(np.complex64)
    td = ttr.ofdm_ifft(torch.as_tensor(grid))
    np.testing.assert_allclose(td.numpy(),
                               np.asarray(jtr.ofdm_ifft(jnp.asarray(grid))),
                               atol=1e-5)
    got = ttr.add_cyclic_prefix(tspec, td)
    want = np.asarray(jtr.add_cyclic_prefix(spec, jnp.asarray(td.numpy())))
    assert got.shape == (2, 5 * spec.sym_len)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    back = ttr.remove_cyclic_prefix(tspec, got, 5)
    if rolloff == 0:
        np.testing.assert_allclose(ttr.ofdm_fft(back).numpy(), grid,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jtr.remove_cyclic_prefix(spec, jnp.asarray(got.numpy()),
                                            5)))


def _payloads(spec, seed):
    cap = spec.max_payload_bytes - 4
    rng = np.random.RandomState(seed)
    lens = np.array([0, 1, 31, cap], np.int32)
    pays = rng.randint(0, 256, (4, cap)).astype(np.uint8)
    return pays, lens, np.array([0, 7, 4095, 4100], np.int32)


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "qam16"])
def test_tx_frames_match_jax_and_golden(mod):
    spec = OfdmConfig(modulation=mod, max_payload_bytes=64).spec
    tspec = tconfig.OfdmConfig(modulation=mod, max_payload_bytes=64).spec
    pays, lens, nums = _payloads(spec, seed=len(mod))
    got = ttx.tx_frames(tspec, torch.as_tensor(pays), torch.as_tensor(lens),
                        torch.as_tensor(nums))
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p, l, f: jtx.tx_frames(spec, p, l, f))(pays, lens, nums))
    np.testing.assert_array_equal(got.n_samples.numpy(), want.n_samples)
    np.testing.assert_array_equal(got.wire_len.numpy(), lens + 4)
    scale = spec.cfg.scale
    np.testing.assert_allclose(got.samples.numpy(), want.samples,
                               atol=1e-5 * scale)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation=mod)
    for i in range(4):
        g = G.tx_frame(gp, pays[i, :lens[i]].tobytes(), int(nums[i]))
        n = int(got.n_samples[i])
        assert len(g) == n
        np.testing.assert_allclose(got.samples[i, :n].numpy(), g,
                                   atol=1e-5 * scale)
        assert not got.samples[i, n:].abs().any()
    # the same payloads come back from either TX's samples
    dec = [trx.demod_frame(tspec, torch.tensor(s))
           for s in (got.samples.numpy(), want.samples)]
    for d in dec:
        assert d.crc_ok.all() and d.hdr_ok.all()
        np.testing.assert_array_equal(d.payload_len.numpy(), lens)
        np.testing.assert_array_equal(d.frame_num.numpy(), nums % 4096)
    np.testing.assert_array_equal(dec[0].payload.numpy(),
                                  dec[1].payload.numpy())
    for i in range(4):
        assert bytes(dec[0].payload[i, :lens[i]].numpy()) == bytes(
            pays[i, :lens[i]])


def test_tx_frame_and_pack_stream_match_jax():
    spec = OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
    tspec = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
    pays, lens, nums = _payloads(spec, seed=5)
    one = ttx.tx_frame(tspec, torch.as_tensor(pays[2]), int(lens[2]), 9)
    jone = jtx.tx_frame(spec, jnp.asarray(pays[2]), int(lens[2]), 9)
    assert int(one.n_samples) == int(jone.n_samples)
    assert int(one.wire_len) == int(jone.wire_len)
    np.testing.assert_allclose(one.samples.numpy(), np.asarray(jone.samples),
                               atol=1e-5)
    frames = ttx.tx_frames(tspec, torch.as_tensor(pays), torch.as_tensor(lens),
                           torch.as_tensor(nums))
    jframes = jtx.TxFrame(*(jnp.asarray(f.numpy()) for f in frames))
    for gap in (0, 37):
        np.testing.assert_array_equal(
            ttx.pack_stream(frames, gap).numpy(),
            np.asarray(jtx.pack_stream(jframes, gap)))
