"""The port's spectrum tools against the JAX package on the same numpy
inputs: window tables (bit-exact), the spectrum probe and waterfall Blocks
over three pushes (linear power at atol 1e-4 * max, the psd kernel's bar;
frame counts exact), the host-side ASCII rendering (identical strings), and
the wideband scanner's power-scan chain (channel power at atol
1e-4 * max)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_ofdm.spectrum import channelizer as jch
from tpu_ofdm.spectrum import probe as jprobe
from tpu_ofdm.spectrum import waterfall as jwf
from tpu_ofdm.spectrum import window as jwin
from tpu_ofdm.stream import block as jblock
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch import spectrum as tspec
from tpu_ofdm_torch.spectrum import window as twin
from tpu_ofdm_torch.stream import block as tblock
from tpu_ofdm_torch.stream import executor as tex


def _sig(n, seed=0, tones=((0.1, 1.0), (0.27, 0.3))):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = sum(a * np.exp(2j * np.pi * f * t) for f, a in tones)
    x = x + (rng.randn(n) + 1j * rng.randn(n)) * 0.01
    return x.astype(np.complex64)


def _assert_db_close(got, want):
    g = 10.0 ** (np.asarray(got, np.float64) / 10)
    w = 10.0 ** (np.asarray(want, np.float64) / 10)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * w.max())


def _push_both(jblk, tblk, x, S, steps=3):
    jx = jex.StreamExecutor(jblk, S, donate=False)
    ex = tex.StreamExecutor(tblk, S, device="cpu")
    outs = []
    for i in range(steps):
        chunk = x[i * S:(i + 1) * S]
        outs.append((jax.tree.map(np.asarray, jx.push(chunk)),
                     ex.push(torch.as_tensor(chunk))))
    return outs


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 1024])
def test_window_tables_bit_exact(n):
    assert sorted(twin._WINDOWS) == sorted(jwin._WINDOWS)
    for name in jwin._WINDOWS:
        np.testing.assert_array_equal(twin.get(name, n), jwin.get(name, n))
    np.testing.assert_array_equal(twin.kaiser(n, 6.5), jwin.kaiser(n, 6.5))
    with pytest.raises(ValueError):
        twin.get("triangle", n)


@pytest.mark.parametrize("window", ["hann", "blackman_harris"])
def test_probe_block_matches_jax(window):
    S = 2048
    x = _sig(3 * S, seed=3)
    outs = _push_both(jprobe.spectrum_probe_block(256, window),
                      tspec.spectrum_probe_block(256, window), x, S)
    for want, got in outs:
        assert int(got.n_frames) == int(want.n_frames)
        for field in ("avg_db", "max_db", "min_db"):
            _assert_db_close(getattr(got, field), getattr(want, field))
    assert int(got.n_frames) == 3 * S // 256
    assert np.argmax(got.avg_db.numpy()) == round(0.1 * 256)
    assert np.all(got.max_db.numpy() >= got.avg_db.numpy() - 1e-4)
    assert np.all(got.avg_db.numpy() >= got.min_db.numpy() - 1e-4)


@pytest.mark.parametrize("decim,depth", [(1, 32), (3, 8), (1, 200)])
def test_waterfall_block_matches_jax(decim, depth):
    S = 8192
    x = _sig(3 * S, seed=4)
    outs = _push_both(jwf.waterfall_block(128, depth=depth, decim=decim),
                      tspec.waterfall_block(128, depth=depth, decim=decim),
                      x, S)
    for want, got in outs:
        assert got.shape == want.shape == (depth, 128)
        np.testing.assert_array_equal(got.numpy() == -200.0, want == -200.0)
        _assert_db_close(got, want)
    if depth <= 3 * S // 128 // decim:
        assert np.all(np.isfinite(got.numpy()))
        assert np.argmax(got.numpy().mean(0)) == 64 + round(0.1 * 128)


def test_render_ascii_identical():
    rng = np.random.RandomState(5)
    rows = (rng.randn(12, 128) * 20 - 60).astype(np.float32)
    rows[3, 7] = -np.inf
    for kw in ({}, {"width": 64}, {"db_min": -90, "db_max": -30},
               {"width": 40, "db_min": -100}):
        assert tspec.render_ascii(rows, **kw) == jwf.render_ascii(rows, **kw)
    assert (tspec.render_ascii(torch.as_tensor(rows[0]))
            == jwf.render_ascii(rows[0]))
    assert (tspec.render_spectrum_line(rows[1], width=50)
            == jwf.render_spectrum_line(rows[1], width=50))


def test_power_scan_chain_matches_jax():
    """apps/wideband_scanner.py's power mode: channelizer -> |.|^2 -> mean
    over time, composed with chain/stateless as the app composes it."""
    n_chan = 32
    S = n_chan * 64
    t = np.arange(3 * S)
    x = (_sig(3 * S, seed=6, tones=())
         + np.exp(2j * np.pi * 5 / n_chan * t)
         + 0.5 * np.exp(2j * np.pi * 20 / n_chan * t)).astype(np.complex64)
    jscan = jblock.chain(jch.channelizer_block(n_chan),
                         jblock.complex_to_mag_squared(),
                         jblock.stateless(lambda v: jnp.mean(v, axis=-2)))
    tscan = tblock.chain(tspec.channelizer_block(n_chan),
                         tblock.complex_to_mag_squared(),
                         tblock.stateless(lambda v: v.mean(-2)))
    for want, got in _push_both(jscan, tscan, x, S):
        assert got.shape == (n_chan,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * want.max())
    assert sorted(np.argsort(got.numpy())[-2:]) == [5, 20]
