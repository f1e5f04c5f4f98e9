"""The port's sliding Schmidl-Cox metric (kernels/sc_metric.py) and the
diagnostic sync API (ops.sync: coarse_sliding_max_same, schmidl_cox)
against the JAX package's, on the same seeded inputs.

The JAX kernel runs in interpret mode, forced on as
tests/test_kernels_scan.py does.  Tolerances: against the JAX kernel,
tests/test_kernels_scan.py's (P, R rtol/atol 2e-3; M 5e-3); against a
float64 numpy reference, the port's float64 plain version to rtol 1e-5;
against the JAX XLA route and the golden model, tests/test_ops.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.kernels import scan as jscan
from tpu_ofdm.kernels.sc_metric import sc_sliding_metric as j_sc_metric
from tpu_ofdm.ops import sync as jsync
from tpu_ofdm_torch.kernels import sc_metric as tmetric
from tpu_ofdm_torch.ops import sync as tsync

SPEC = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
TSPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec


@pytest.fixture
def force_kernels(monkeypatch):
    monkeypatch.setattr(jscan, "use_pallas", lambda: True)
    monkeypatch.setattr(jscan, "_MIN_PALLAS_N", 1)
    with pltpu.force_tpu_interpret_mode():
        yield


def _reference(r, L):
    """float64 numpy P, R and uncapped M, valid mode."""
    prod = np.conj(r[..., :-L]) * r[..., L:]
    energy = np.abs(r[..., L:]) ** 2
    c = np.cumsum(np.concatenate([np.zeros((*r.shape[:-1], 1)),
                                  prod], -1), -1)
    e = np.cumsum(np.concatenate([np.zeros((*r.shape[:-1], 1)),
                                  energy], -1), -1)
    P = c[..., L:] - c[..., :-L]
    R = e[..., L:] - e[..., :-L]
    return P, R, np.abs(P) ** 2 / np.maximum(R, 1e-12) ** 2


@pytest.mark.parametrize("L", [32, 128, 192])
def test_sc_sliding_metric_matches_jax_kernel(force_kernels, L):
    rng = np.random.RandomState(3)
    n = 4096 + 137
    r = (rng.randn(2, n) + 1j * rng.randn(2, n)).astype(np.complex64)
    P, R, M = tmetric.sc_sliding_metric(torch.as_tensor(r), L)
    assert P.shape == R.shape == M.shape == (2, n - 2 * L + 1)
    assert (P.dtype, R.dtype, M.dtype) == (torch.complex64, torch.float32,
                                           torch.float32)
    jP, jR, jM = jax.jit(lambda x: j_sc_metric(x, L))(jnp.asarray(r))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=5e-3,
                               atol=5e-3)
    Pr, Rr, Mr = _reference(r.astype(np.complex128), L)
    np.testing.assert_allclose(P.numpy(), Pr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R.numpy(), Rr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(M.numpy(), Mr, rtol=1e-5, atol=1e-6)


def test_sc_sliding_metric_checks_its_input():
    r = torch.zeros(100, dtype=torch.complex64)
    with pytest.raises(ValueError):
        tmetric.sc_sliding_metric(r, 51)            # n < 2L
    with pytest.raises(TypeError):
        tmetric.sc_sliding_metric(r.real.contiguous(), 8)
    with pytest.raises(ValueError):
        tmetric.sc_sliding_metric(torch.zeros(100, dtype=torch.complex64,
                                              device="meta"), 8)


@pytest.mark.parametrize("shape, w", [((10000,), 161), ((3, 5000), 161),
                                      ((2, 777), 33)])
def test_coarse_sliding_max_same_matches_jax(shape, w):
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    got = tsync.coarse_sliding_max_same(torch.as_tensor(x), w)
    want = np.asarray(jsync.coarse_sliding_max_same(jnp.asarray(x), w))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = tsync.sliding_max_same(torch.as_tensor(x), w, pad_left=w // 2)
    assert bool((got >= exact).all())


def _capture(n, seed=7):
    """Golden frames over noise with a CFO, (n,) complex64."""
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    x = 0.05 * (rng.randn(n) + 1j * rng.randn(n))
    for p in range(500, n - 2500, 6000):
        f = G.tx_frame(gp, rng.randint(0, 256, 80).astype(np.uint8).tobytes())
        x[p:p + len(f)] += f
    x *= np.exp(2j * np.pi * 0.3 * np.arange(n) / 64)
    return x.astype(np.complex64)


def test_schmidl_cox_matches_jax_xla_route():
    r = np.stack([_capture(9000, seed) for seed in (7, 8)])
    got = tsync.schmidl_cox(TSPEC, torch.as_tensor(r))
    want = jax.jit(lambda x: jsync.schmidl_cox(SPEC, x))(jnp.asarray(r))
    np.testing.assert_allclose(got.corr.numpy(), np.asarray(want.corr),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=1e-3, atol=2e-3)
    one = tsync.schmidl_cox(TSPEC, torch.as_tensor(r[1]))
    for a, b in zip(one, got):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)


def test_schmidl_cox_matches_jax_kernel_route(force_kernels):
    """n >= 2^15, where the JAX package takes its sc_metric kernel; its M
    is uncapped, so the port's M is held against min(M, 2)."""
    r = _capture(1 << 15)
    got = tsync.schmidl_cox(TSPEC, torch.as_tensor(r))
    want = jax.jit(lambda x: jsync.schmidl_cox(SPEC, x))(jnp.asarray(r))
    np.testing.assert_allclose(got.corr.numpy(), np.asarray(want.corr),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.metric.numpy(),
                               np.minimum(np.asarray(want.metric), 2.0),
                               rtol=5e-3, atol=5e-3)


def test_schmidl_cox_matches_golden():
    """tests/test_ops.py's frame and tolerances."""
    gp = G.GoldenOfdmParams()
    tx = G.tx_frame(gp, b"payload!" * 4)
    r = np.concatenate([np.zeros(50), tx, np.zeros(50)]).astype(np.complex64)
    m = tsync.schmidl_cox(TSPEC, torch.as_tensor(r))
    gm, gP = G.schmidl_cox_metric(gp, r)
    n = len(gm)
    np.testing.assert_allclose(m.corr.numpy()[:n], gP.astype(np.complex64),
                               atol=1e-2, rtol=1e-3)
    keep = m.metric.numpy()[:n] > 0
    np.testing.assert_allclose(m.metric.numpy()[:n][keep], gm[keep],
                               atol=2e-3, rtol=1e-3)


def test_metric_above_two_at_an_edge_is_capped(force_kernels, monkeypatch):
    """A signal of period L whose amplitude drops from 1 to 0.5: the
    window pair straddling the drop has |P| = L/2 * e and R = L/4 * e, so
    the uncapped M is 4.  The JAX kernel route keeps 4 there (it leaves M
    uncapped), the JAX XLA route caps it at 2, and the port gives 2 on
    every route while its sc_sliding_metric, like the TPU kernel, gives 4
    (ROADMAP sec. C)."""
    L = SPEC.fft_len // 2
    n, drop = 1 << 15, 20000
    rng = np.random.RandomState(9)
    period = np.exp(2j * np.pi * rng.rand(L))
    r = np.resize(period, n) * np.where(np.arange(n) < drop, 1.0, 0.5)
    r = r.astype(np.complex64)
    d = drop - L                      # first half at 1, second half at 0.5
    raw = tmetric.sc_sliding_metric(torch.as_tensor(r), L)[2].numpy()
    assert abs(raw[d] - 4.0) < 1e-4
    port = tsync.schmidl_cox(TSPEC, torch.as_tensor(r)).metric.numpy()
    assert port.max() <= 2.0 and abs(port[d] - 2.0) < 1e-6
    kernel_route = np.asarray(jsync.schmidl_cox(SPEC, jnp.asarray(r)).metric)
    assert abs(kernel_route[d] - 4.0) < 1e-2
    monkeypatch.setattr(jscan, "use_pallas", lambda: False)
    xla_route = np.asarray(jsync.schmidl_cox(SPEC, jnp.asarray(r)).metric)
    assert abs(xla_route[d] - 2.0) < 1e-6
    np.testing.assert_allclose(port, xla_route, atol=2e-3)
