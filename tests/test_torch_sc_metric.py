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


# -- csrc/sc_metric.cu's index and summation scheme, modelled in torch -----
# The kernel sums each window of L terms f(d') = conj(r[d'+L-1]) r[d'+2L-1]
# from 32-output segments anchored at output 0: the segment prefix C at d,
# the totals of the segments in between, and X, the sum of the terms after
# d - L in the segment where the window starts (C(d) - C(d - L) inside one
# segment).  Each warp owns a strip of 128-output rows, computes it from a
# warm-up before it and, in the gated form, the K rows on either side, and
# gates M by the max of R over rows g - K .. g + K.  The model must give
# the plain version's P, R and M at chip_smoke.py's bars, and the JAX
# kernel's at tests/test_kernels_scan.py's.

SEG, ROW, STRIP = 32, 128, 32      # csrc/sc_metric.cu kSeg, kRow, kStrip


def _load(v, p):
    ok = (p >= 0) & (p < v.shape[-1])
    return torch.where(ok, v[p.clamp(0, v.shape[-1] - 1)], 0)


def _window_model(f, L):
    """Window sums of L over the terms f at outputs d0 + j, d0 % 32 == 0."""
    seg = f.reshape(-1, SEG)
    C = torch.cumsum(seg, -1)
    rev = torch.flip(torch.cumsum(torch.flip(seg, [-1]), -1), [-1])
    X = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], -1)
    T = C[:, -1]
    C, X = C.reshape(-1), X.reshape(-1)
    j = torch.arange(f.shape[0])
    s = (j - L).clamp(min=0)
    dist = j // SEG - s // SEG
    acc = X[s]
    for b in range(1, -(-L // SEG) + 1):
        acc = acc + torch.where(b < dist, T[(j // SEG - b).clamp(min=0)], 0.0)
    return torch.where(dist == 0, C - C[s], acc + C)


def _kernel_model(r, L, gate_w=None):
    """(P, R, M) of complex64 r (B, n), raw or gated, strip by strip."""
    B, n = r.shape
    m = n - 2 * L + 1
    nrows = -(-m // ROW)
    S = nrows if nrows <= 2 * STRIP else STRIP
    K = 0 if gate_w is None else tmetric.halo_rows(gate_w)
    P = torch.zeros((B, m), dtype=torch.complex64)
    R = torch.zeros((B, m))
    M = torch.zeros((B, m))
    for b in range(B):
        for g0 in range(0, nrows, S):
            g1 = min(nrows, g0 + S)
            c0, c1 = max(0, g0 - K), min(nrows, g1 + K)
            d0 = SEG * ((ROW * c0 - L) // SEG)       # warm-up from here
            d = torch.arange(d0, ROW * c1)
            u = _load(r[b], d + L - 1)
            v = _load(r[b], d + 2 * L - 1)
            terms = (u.real * v.real + u.imag * v.imag,
                     u.real * v.imag - u.imag * v.real,
                     v.real * v.real + v.imag * v.imag)
            Pre, Pim, Rw = (_window_model(t, L)[ROW * c0 - d0:]
                            for t in terms)
            Mw = (Pre * Pre + Pim * Pim) / Rw.clamp(min=1e-12) ** 2
            if gate_w is not None:
                dd = ROW * c0 + torch.arange(Rw.shape[0])
                rmax = torch.where(dd < m, Rw, float("-inf")).reshape(
                    -1, ROW).amax(-1)
                g = dd // ROW - c0
                lo, hi = (g - K).clamp(min=0), (g + K).clamp(max=c1 - c0 - 1)
                local = torch.stack([rmax[a:z + 1].max()
                                     for a, z in zip(lo.tolist(),
                                                     hi.tolist())])
                Mw = torch.where(Rw > 0, Mw.clamp(max=2.0), 0.0)
                Mw = torch.where(Rw > 0.05 * local, Mw, 0.0)
            a, z = ROW * g0, min(ROW * g1, m)
            o = slice(a - ROW * c0, z - ROW * c0)
            P[b, a:z] = torch.complex(Pre[o], Pim[o])
            R[b, a:z], M[b, a:z] = Rw[o], Mw[o]
    return P, R, M


def _edge_frames(B, n, seed=5):
    """(B, n) complex64: golden frames over noise, with a CFO, ending just
    before and starting just after the kernel's strip edges (outputs 4096
    k) and its gate halos (+-256 outputs), shifted per row."""
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    out = []
    for b in range(B):
        x = 0.05 * (rng.randn(n) + 1j * rng.randn(n))
        for k in range(1, n // 4096 + 1):
            for p in (4096 * k - 2100 + 37 * b, 4096 * k + 10 + 37 * b):
                f = G.tx_frame(gp, rng.randint(0, 256, 40).astype(
                    np.uint8).tobytes())
                if 0 <= p and p + len(f) <= n:
                    x[p:p + len(f)] += f
        x *= np.exp(2j * np.pi * 0.3 * np.arange(n) / 64)
        out.append(x)
    return np.stack(out).astype(np.complex64)


def _pair_energy(r, L):
    e = np.abs(r.astype(np.complex128)) ** 2
    c = np.concatenate([np.zeros((*r.shape[:-1], 1)), np.cumsum(e, -1)], -1)
    return c[..., 2 * L:] - c[..., : -2 * L]


@pytest.mark.parametrize("L", [32, 128, 192])
def test_kernel_model_matches_plain_and_jax_kernel(force_kernels, L):
    """3 rows with a ragged last row of strips (m not a multiple of 128),
    strips of 32 rows, frames across the strip edges: the raw model at
    chip_smoke.py's bars against the float64 plain version (|dP|, |dR| <=
    1e-5 E with E the window pair's energy, |dM| <= 1e-4 (E/R)(E/R + 2M))
    and at the JAX kernel's tolerances against it; the gated model against
    the plain version's gate (every decision away from the threshold the
    same, M equal to 1e-4 elsewhere)."""
    r = _edge_frames(3, 9000 + 2 * L + 3)
    rt = torch.as_tensor(r)
    P, R, M = _kernel_model(rt, L)
    Pw, Rw, Mw = tmetric.sc_sliding_metric_plain(rt, L)
    E = _pair_energy(r, L)
    q = E / Rw.double().numpy()
    assert (np.abs((P - Pw).numpy()) <= 1e-5 * E).all()
    assert (np.abs((R - Rw).numpy()) <= 1e-5 * E).all()
    assert (np.abs((M - Mw).numpy()) <= 1e-4 * q * (q + 2 * Mw.numpy())).all()
    jP, jR, jM = jax.jit(lambda x: j_sc_metric(x, L))(jnp.asarray(r))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=5e-3,
                               atol=5e-3)
    w = 2 * (2 * L + L // 2) + 1
    Pg, Rg, Mg = _kernel_model(rt, L, w)
    torch.testing.assert_close(Pg, P, rtol=0, atol=0)
    torch.testing.assert_close(Rg, R, rtol=0, atol=0)
    _, _, Mp = tmetric.sc_sync_metric_plain(rt, L, w)
    local = tmetric.coarse_sliding_max_same(Rw, w)
    near = (Rw - 0.05 * local).abs() <= 1e-4 * local
    flip = (Mg > 0) != (Mp > 0)
    assert not bool((flip & ~near).any())
    assert int((Mg > 0).sum()) > 0 and int((Mp == 0).sum()) > 0
    torch.testing.assert_close(Mg[~flip], Mp[~flip], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["xla", "kernel"])
def test_gated_plain_matches_jax_schmidl_cox_at_strip_edges(
        force_kernels, monkeypatch, route):
    """The port's schmidl_cox (on the CPU the gated plain version) against
    the JAX package's on both its routes, frames at the kernel's strip and
    halo edges (2 rows of 2^15, where the JAX package takes its kernel;
    its M is uncapped there, so the port's is held against min(M, 2))."""
    r = _edge_frames(2, 1 << 15, seed=6)
    got = tsync.schmidl_cox(TSPEC, torch.as_tensor(r))
    if route == "xla":
        monkeypatch.setattr(jscan, "use_pallas", lambda: False)
    want = jsync.schmidl_cox(SPEC, jnp.asarray(r))
    tol = {"xla": (1e-3, 2e-3), "kernel": (2e-3, 5e-3)}[route]
    np.testing.assert_allclose(got.corr.numpy(), np.asarray(want.corr),
                               rtol=tol[0], atol=tol[0])
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=tol[0], atol=tol[0])
    np.testing.assert_allclose(got.metric.numpy(),
                               np.minimum(np.asarray(want.metric), 2.0),
                               rtol=tol[0], atol=tol[1])


def test_sync_metric_wrapper_routes():
    """On the CPU sc_sync_metric is its plain version and counts no
    launch; other devices and bad inputs raise."""
    r = torch.as_tensor(_edge_frames(1, 6000)[0])
    before = tmetric.sc_sync_metric.launches
    got = tmetric.sc_sync_metric(r, 32, 161)
    for a, b in zip(got, tmetric.sc_sync_metric_plain(r, 32, 161)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tmetric.sc_sync_metric.launches == before
    assert tmetric.halo_rows(161) == 2 and tmetric.halo_rows(641) == 4
    with pytest.raises(ValueError):
        tmetric.sc_sync_metric(r[:60], 32, 161)
    with pytest.raises(ValueError):
        tmetric.sc_sync_metric(torch.zeros(100, dtype=torch.complex64,
                                           device="meta"), 8, 161)
