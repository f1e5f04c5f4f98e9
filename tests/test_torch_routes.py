"""The C1 routes of the port on the card, decided by shape alone before any
launch: `psd_route` and `channelize_route` answer "torch" -- the JAX
package's XLA chain in torch ops -- exactly where the JAX package's own
gates (`tpu_ofdm.kernels.psd.supported` on a 1-D input,
`tpu_ofdm.kernels.pfb.supported` on a 1-D stream) take that chain and the
port's kernels do not cover the shape; every shape the JAX package runs in
a Pallas kernel launches the port's kernel.  The torch chains themselves
run here on the CPU (psd's by forcing its route; the channelizer's is the
CPU's own), against the JAX package's XLA chain (linear power at 1e-4 *
max, the psd kernel's bar; channel samples at 1e-4 * max), without
reaching a kernel wrapper or its plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ofdm.kernels import pfb as jkpfb
from tpu_ofdm.kernels import psd as jkpsd
from tpu_ofdm.spectrum import channelizer as jch
from tpu_ofdm.spectrum import psd as jpsd
from tpu_ofdm_torch.kernels import pfb as tkpfb
from tpu_ofdm_torch.kernels import psd as tkpsd
from tpu_ofdm_torch.spectrum import channelizer as tch
from tpu_ofdm_torch.spectrum import psd as tpsd


def _c64(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("fft_len", [8, 16, 32, 48, 64, 100, 128, 192, 256,
                                     384, 1024, 1152, 2048, 4096])
def test_psd_route_is_torch_only_where_jax_takes_xla(fft_len, ndim):
    route = tpsd.psd_route("cuda", fft_len)
    jax_pallas = ndim == 1 and jkpsd.supported(fft_len)
    if jax_pallas:
        assert route == "kernel"
    # the port's kernel also takes batched rows and N 16, 32, 64
    assert route == ("kernel" if fft_len in tkpsd.COVERED else "torch")
    assert tpsd.psd_route("cpu", fft_len) == "plain"


@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("n_chan", [4, 8, 16, 48, 64, 96, 128, 256, 384,
                                    512, 640, 1024])
def test_channelize_route_is_torch_exactly_where_jax_takes_xla(n_chan,
                                                               ndim):
    jax_pallas = ndim == 1 and jkpfb.supported(n_chan)
    assert tch.channelize_route("cuda", ndim, n_chan) == (
        "kernel" if jax_pallas else "torch")
    assert tch.channelize_route("cpu", ndim, n_chan) == "torch"


def _no_kernel(monkeypatch, *fns):
    def refuse(*a, **k):
        raise AssertionError("the torch route reached a kernel wrapper")
    for mod, name in fns:
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("shape,fft_len", [((5 * 2048 + 3,), 2048),
                                           ((3, 40 * 48 + 7), 48),
                                           ((1 << 12,), 1024)])
def test_psd_torch_route_matches_jax_xla_chain(monkeypatch, shape, fft_len):
    monkeypatch.setattr(tpsd, "psd_route", lambda dt, n: "torch")
    _no_kernel(monkeypatch, (tkpsd, "psd_fused"), (tkpsd, "psd_fused_plain"))
    x = _c64(shape, fft_len)
    for window in ("hann", "blackman_harris"):
        got = tpsd.psd_frames(torch.as_tensor(x), fft_len, window).numpy()
        want = np.asarray(jpsd.psd_frames(jnp.asarray(x), fft_len, window))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.max())
    got = tpsd.log_pwr_fft(torch.as_tensor(x), fft_len, 0.25).numpy()
    want = np.asarray(jpsd.log_pwr_fft(jnp.asarray(x), fft_len, 0.25))
    np.testing.assert_allclose(10 ** (got / 10), 10 ** (want / 10), rtol=0,
                               atol=1e-4 * 10 ** (want.max() / 10))


@pytest.mark.parametrize("n_chan", [64, 48])
def test_channelizer_torch_route_matches_jax_xla_chain(monkeypatch, n_chan):
    """A batched stream (and, at 48 channels, a count pfb does not cover)
    through channelize and two carried channelize_stream steps."""
    _no_kernel(monkeypatch, (tkpfb, "channelize_fused"),
               (tkpfb, "channelize_fused_plain"))
    taps = tch.lowpass_taps(n_chan)
    x = _c64((2, 64 * n_chan), n_chan)
    got = tch.channelize(torch.as_tensor(x), n_chan, taps).numpy()
    want = np.asarray(jch.channelize(jnp.asarray(x), n_chan, taps))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    C = tch.stream_tail_len(n_chan, taps)
    poly = torch.as_tensor(tch.polyphase_decompose(taps, n_chan))
    jpoly = jnp.asarray(jch.polyphase_decompose(taps, n_chan))
    tail, jtail = torch.zeros((2, C), dtype=torch.complex64), \
        jnp.zeros((2, C), jnp.complex64)
    half = 32 * n_chan
    for part in (x[:, :half], x[:, half:]):
        out, tail = tch.channelize_stream(torch.as_tensor(part), tail,
                                          n_chan, poly)
        jout, jtail = jch.channelize_stream(jnp.asarray(part), jtail, n_chan,
                                            taps, jpoly)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(jout)).max())
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
