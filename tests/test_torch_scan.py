"""The port's cumsum, moving_sums and moving_sum against the JAX package's,
on the same seeded inputs, with the JAX side run both through its Pallas
kernel (interpret mode, forced on as tests/test_kernels_scan.py does) and
through its XLA route.

Tolerances: against the JAX package, rtol 2e-4 / atol 2e-3, the bar of
tests/test_kernels_scan.py (the JAX prefix is float32 throughout); against
a float64 numpy prefix, the port's plain version is held to 1e-6 *
sum_{i<=t} |x_i| (one float32 rounding of a float64 sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpu_ofdm.kernels import scan as jscan
from tpu_ofdm.ops import sync as jsync
from tpu_ofdm_torch.kernels import scan as tscan
from tpu_ofdm_torch.ops import sync as tsync

SHAPES = [(1, 4096), (3, 8192), (2, 2, 4096), (5, 1000)]


@pytest.fixture(params=["pallas", "xla"])
def jax_route(request, monkeypatch):
    """Run the JAX side through its Pallas kernel (interpret mode) or its
    XLA fallback."""
    if request.param == "xla":
        yield request.param
        return
    monkeypatch.setattr(jscan, "use_pallas", lambda: True)
    monkeypatch.setattr(jscan, "_MIN_PALLAS_N", 1)
    with pltpu.force_tpu_interpret_mode():
        yield request.param


@pytest.mark.parametrize("shape", SHAPES)
def test_cumsum_matches_jax(jax_route, shape):
    x = np.random.RandomState(len(shape) + shape[-1]).randn(*shape).astype(
        np.float32) + 0.25
    got = tscan.cumsum(torch.as_tensor(x)).numpy()
    want = np.asarray(jscan.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)
    exact = np.cumsum(x.astype(np.float64), axis=-1)
    bar = 1e-6 * np.cumsum(np.abs(x.astype(np.float64)), axis=-1)
    assert np.all(np.abs(got - exact) <= bar)
    assert got.dtype == np.float32 and got.shape == shape


def test_cumsum_non_last_axis_takes_the_plain_version():
    x = np.random.RandomState(1).randn(64, 32).astype(np.float32)
    got = tscan.cumsum(torch.as_tensor(x), axis=0).numpy()
    want = np.asarray(jscan.cumsum(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_moving_sums_matches_jax(jax_route):
    rng = np.random.RandomState(2)
    n, w = 5000, 33
    a, b = rng.randn(2, n).astype(np.float32)
    got = tscan.moving_sums([torch.as_tensor(a), torch.as_tensor(b)], w)
    want = jscan.moving_sums([jnp.asarray(a), jnp.asarray(b)], w)
    for g, v, x in zip(got, want, (a, b)):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(
            g.numpy(), np.convolve(x.astype(np.float64), np.ones(w), "valid"),
            rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("kind", ["float32", "complex64", "float64"])
def test_moving_sum_matches_jax(jax_route, kind):
    rng = np.random.RandomState(6)
    shape, w = (3, 2000), 17
    x = rng.randn(*shape)
    if kind == "complex64":
        x = (x + 1j * rng.randn(*shape)).astype(np.complex64)
    else:
        x = x.astype(kind)
    got = tsync.moving_sum(torch.as_tensor(x), w)
    want = np.asarray(jsync.moving_sum(jnp.asarray(x), w))
    assert got.dtype == (torch.complex64 if kind == "complex64"
                         else torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-3)


def test_cumsum_checks_its_input():
    with pytest.raises(TypeError):
        tscan.cumsum(torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        tscan.cumsum(torch.zeros(8, 8).t())          # not contiguous
    with pytest.raises(ValueError):                 # neither CPU nor CUDA
        tscan.cumsum(torch.zeros(8, device="meta"))
    launches = tscan.cumsum.launches
    tscan.cumsum(torch.zeros(3, 8))
    assert tscan.cumsum.launches == launches        # the CPU launches nothing
