"""The port's PSD chain (plain version of the CUDA psd kernel, the IIR scan
and the streaming logpwrfft Block) against the JAX package: its XLA
psd_frames chain and its fused Pallas kernel in TPU interpret mode, as
tests/test_kernels_psd.py runs it.  Bars: linear power at atol 1e-4 * max,
the bar of tests/test_kernels_psd.py, also for dB outputs (converted back
to power: near-empty bins differ by a few 1e-3 dB between two float32
DFTs); the IIR scan at rtol 1e-5 (float32 rounding of two scan orders);
the golden model at atol 0.1 dB, as tests/test_spectrum.py holds the JAX
package.  The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.golden import golden_ofdm as G
from tpu_ofdm.kernels import psd as jkpsd
from tpu_ofdm.spectrum import psd as jpsd
from tpu_ofdm.spectrum import window as jwin
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.kernels import psd as tkpsd
from tpu_ofdm_torch.spectrum import psd as tpsd
from tpu_ofdm_torch.stream import executor as tex


def _sig(n, seed=0, tones=((0.1, 1.0), (0.27, 0.3))):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = sum(a * np.exp(2j * np.pi * f * t) for f, a in tones)
    x = x + (rng.randn(n) + 1j * rng.randn(n)) * 0.01
    return x.astype(np.complex64)


def _assert_power_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * want.max())


def _assert_db_close(got, want):
    _assert_power_close(10.0 ** (np.asarray(got, np.float64) / 10),
                        10.0 ** (np.asarray(want, np.float64) / 10))


@pytest.mark.parametrize("fft_len", [128, 256, 384, 512, 1024])
def test_psd_frames_matches_jax_xla_and_pallas(fft_len):
    x = _sig(fft_len * 24 + 37, seed=fft_len)      # ragged tail dropped
    xla = jpsd.psd_frames(jnp.asarray(x), fft_len)
    with pltpu.force_tpu_interpret_mode():
        pallas = jkpsd.psd_fused(jnp.asarray(x), fft_len)
    got = tpsd.psd_frames(torch.as_tensor(x), fft_len)
    assert got.dtype == torch.float32 and got.shape == (24, fft_len)
    _assert_power_close(got, xla)
    _assert_power_close(got, pallas)


@pytest.mark.parametrize("window", sorted(jwin._WINDOWS))
def test_psd_frames_each_window(window):
    """Every window name, on the kernel's length (128) and on one the
    kernel does not cover (64, the plain chain)."""
    x = _sig(128 * 12, seed=3)
    for fft_len in (128, 64):
        want = jpsd.psd_frames(jnp.asarray(x), fft_len, window)
        got = tpsd.psd_frames(torch.as_tensor(x), fft_len, window)
        _assert_power_close(got, want)


def test_psd_frames_batched_plain_chain():
    x = np.stack([_sig(256 * 6, seed=s) for s in (1, 2)])
    want = jpsd.psd_frames(jnp.asarray(x), 256)
    got = tpsd.psd_frames(torch.as_tensor(x), 256)
    assert got.shape == (2, 6, 256)
    _assert_power_close(got, want)


@pytest.mark.parametrize("alpha", [0.1, 0.3, 1.0])
@pytest.mark.parametrize("warm", [False, True])
def test_iir_average_matches_jax(alpha, warm):
    rng = np.random.RandomState(7)
    p = np.abs(rng.randn(4096, 32)).astype(np.float32)
    y0 = np.abs(rng.randn(32)).astype(np.float32) if warm else None
    jy, jl = jpsd.iir_average(jnp.asarray(p), alpha,
                              None if y0 is None else jnp.asarray(y0))
    ty, tl = tpsd.iir_average(torch.as_tensor(p), alpha,
                              None if y0 is None else torch.as_tensor(y0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)


def test_log_pwr_fft_matches_golden():
    x = _sig(8192, seed=1)
    got = tpsd.log_pwr_fft(torch.as_tensor(x), 128, avg_alpha=0.2)
    want = G.log_pwr_fft(x.astype(np.complex128), 128, avg_alpha=0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=0.1)


@pytest.mark.parametrize("fft_len", [256, 1024])
def test_log_pwr_fft_block_three_steps_matches_jax(fft_len):
    """Three pushes through both executors: the IIR state and its warm
    start carry across steps."""
    S = fft_len * 16
    x = _sig(3 * S, seed=2, tones=((32 / 256, 1.0),))
    jx = jex.StreamExecutor(jpsd.log_pwr_fft_block(fft_len, avg_alpha=0.3),
                            S, donate=False)
    ex = tex.StreamExecutor(tpsd.log_pwr_fft_block(fft_len, avg_alpha=0.3),
                            S, device="cpu")
    for i in range(3):
        want = np.asarray(jx.push(x[i * S:(i + 1) * S]))
        got = ex.push(torch.as_tensor(x[i * S:(i + 1) * S]))
        _assert_db_close(got, want)
    warm, y_last = ex.state
    assert float(warm) == 1.0
    _assert_power_close(y_last, jx.state[1])
    assert np.argmax(got.numpy().mean(0)) == 32 * fft_len // 256


def test_tone_bin():
    """A pure tone at bin 37 puts (virtually) all power in bin 37."""
    fft_len = 256
    t = np.arange(fft_len * 16)
    x = np.exp(2j * np.pi * 37 * t / fft_len).astype(np.complex64)
    got = tpsd.psd_frames(torch.as_tensor(x), fft_len).numpy()
    np.testing.assert_array_equal(got.argmax(-1), 37)
    far = np.delete(got, [36, 37, 38], axis=-1)
    assert (got[:, 37] > 1e5 * far.max(axis=-1)).all()


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.as_tensor(_sig(1024 * 4, seed=5))
    before = tkpsd.psd_fused.launches
    got = tkpsd.psd_fused(x, 1024, "blackman_harris")
    torch.testing.assert_close(
        got, tkpsd.psd_fused_plain(x, 1024, "blackman_harris"), rtol=0,
        atol=0)
    assert tkpsd.psd_fused.launches == before
    for n in (64, 192, 2048):
        assert tkpsd.supported(n) == jkpsd.supported(n) is False
    with pytest.raises(ValueError):
        tkpsd.psd_fused(x, 64)
    with pytest.raises(TypeError):
        tkpsd.psd_fused(x.to(torch.complex128), 1024)


def test_folded_window_is_the_reference_fold():
    w, *_ = jkpsd._cached(512, "hamming")
    got = tkpsd.folded_window(512, "hamming", torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(w)[0])
    assert jax.devices()[0].platform == "cpu"
