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


def test_cumsum_along_a_leading_axis_matches_jax():
    """Any axis: on the card the kernel runs along it (moved last and
    back), on the CPU the plain version does."""
    x = np.random.RandomState(1).randn(64, 32).astype(np.float32)
    got = tscan.cumsum(torch.as_tensor(x), axis=0).numpy()
    want = np.asarray(jscan.cumsum(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got.shape == x.shape
    with pytest.raises(IndexError):
        tscan.cumsum(torch.as_tensor(x), axis=2)


# A torch model of csrc/scan.cu's single pass: each tile's float64 sums
# (PER_THREAD consecutive samples a thread, then a scan of the thread
# totals), its published aggregate, and its look-back over its row's
# predecessors in passes of 32 * LOOK, by distance, taking each as an
# aggregate or, once that tile is done, as its inclusive prefix, and
# stopping at the nearest inclusive one.  On the card tiles finish in an
# order set by timing; the model takes it from a schedule.

PER_THREAD, LOOK = 32, 4   # csrc/scan.cu kPerThread, kLook


def _lookback_model(x, order):
    B, n = x.shape
    tiles = -(-n // tscan.TILE)
    xs = torch.as_tensor(x, dtype=torch.float64)
    pad = torch.zeros(B, tiles * tscan.TILE, dtype=torch.float64)
    pad[:, :n] = xs
    own = pad.reshape(B * tiles, -1, PER_THREAD).sum(-1)   # thread totals
    agg = own.sum(-1)
    inc = torch.full((B * tiles,), float("nan"), dtype=torch.float64)
    first = torch.arange(B * tiles) // tiles * tiles
    inc[first == torch.arange(B * tiles)] = agg[first == torch.arange(
        B * tiles)]                      # a row's first tile: at once
    excl = torch.zeros(B * tiles, dtype=torch.float64)
    ids = torch.arange(B * tiles)
    if order == "forward":
        done_order = ids
    elif order == "reverse":
        done_order = ids.flip(0)
    else:
        done_order = ids[torch.randperm(len(ids), generator=torch.Generator()
                                        .manual_seed(int(order)))]
    passes = 0
    for t in done_order.tolist():
        if t == first[t]:
            continue
        end, e = t, 0.0
        while True:
            p = end - 1 - torch.arange(32 * LOOK)    # by distance
            before = p < first[t]
            vals = torch.where(before, 0.0, torch.where(
                inc[p.clamp(min=0)].isnan(), agg[p.clamp(min=0)],
                inc[p.clamp(min=0)]))
            is_inc = before | ~inc[p.clamp(min=0)].isnan()
            passes += 1
            if is_inc.any():
                stop = int(is_inc.nonzero()[0])
                e += vals[: stop + 1].sum().item()
                break
            e += vals.sum().item()
            end -= 32 * LOOK
        excl[t] = e
        inc[t] = e + agg[t]
    thread_excl = own.cumsum(-1) - own                   # within the tile
    run = (excl[:, None, None] + thread_excl[..., None]
           + pad.reshape(B * tiles, -1, PER_THREAD).cumsum(-1))
    out = run.reshape(B, -1)[:, :n].to(torch.float32)
    return out.numpy(), passes


@pytest.mark.parametrize("shape,order", [
    ((3, 8192), "forward"),            # rows of one tile
    ((2, 2 * 8192), "reverse"),        # rows of two tiles
    ((2, 8192 + 1), "7"),              # two tiles, the last of one sample
    ((1, 40 * 8192 + 77), "11"),       # many tiles, a ragged last one
    ((3, 6 * 8192 - 5), "reverse"),
    ((1, 131 * 8192 + 3), "reverse"),  # walks past 128 predecessors
])
def test_lookback_model_matches_plain_and_jax(jax_route, shape, order):
    """The kernel's look-back schedule, modelled in torch in float64, stays
    within one float32 ulp of cumsum_plain (the bar of chip_smoke.py's
    scan check) in any finishing order, and within the JAX package's bar
    of jscan.cumsum on both of its routes."""
    assert tscan.TILE == 8192
    x = np.random.RandomState(shape[-1] % 1000).randn(*shape).astype(
        np.float32) + 0.25
    got, passes = _lookback_model(x, order)
    want = tscan.cumsum_plain(torch.as_tensor(x)).double().numpy()
    bar = (2.0 ** -23 * np.abs(want)
           + 1e-10 * np.cumsum(np.abs(x.astype(np.float64)), axis=-1))
    assert np.all(np.abs(got - want) <= bar)
    if shape[-1] > 129 * 8192 and order == "reverse":
        assert passes > shape[0] * (-(-shape[-1] // 8192) - 1)
    np.testing.assert_allclose(got, np.asarray(jscan.cumsum(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-3)


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
