"""The port's slot-window gather (plain version of the CUDA gather kernel)
against the JAX package's Pallas gathers in TPU interpret mode: exact
equality, including windows on both sides of and across the head/x seam.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

from tpu_ofdm.kernels import gather as jg
from tpu_ofdm_torch.kernels import gather as tg


def _planes(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)


def test_gather_matches_pallas_one_source():
    n, K, F = 1 << 17, 37, 1360
    re, im = _planes(n, 0)
    starts = np.sort(np.random.RandomState(1).randint(0, n - F, K)
                     ).astype(np.int32)
    starts[:2] = [0, n - F]
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda a, b, s: jg.gather_windows(a, b, s, F))(
            re, im, starts)
    x = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    got = tg.gather_windows(x, torch.as_tensor(starts), F)
    assert got.dtype == torch.complex64 and got.shape == (K, F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_matches_pallas_two_sources_across_seam():
    """The JAX two-source gather reads [head-region | x] with the head
    starting at virtual 0; the port reads [head | x] in place."""
    x_off, F, nx = 1 << 16, 1360, 1 << 17
    sup = jg.sup_rows_for(F) * 128
    vre, vim = _planes(x_off + nx, 2)
    starts = np.array([0, 5000, x_off - F - 7, x_off - 100, x_off - 1,
                       x_off, x_off + 3, x_off + nx - F], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda hr, hi, xr, xi, s: jg.gather_windows_two(
            hr, hi, xr, xi, s, F, x_off=x_off))(
            vre[:x_off + sup].copy(), vim[:x_off + sup].copy(),
            vre[x_off:].copy(), vim[x_off:].copy(), starts)
    v = torch.complex(torch.as_tensor(vre), torch.as_tensor(vim))
    got = tg.gather_windows(v[x_off:].contiguous(), torch.as_tensor(starts),
                            F, head=v[:x_off].contiguous())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_out_of_range_reads_zero():
    x = torch.arange(1, 11, dtype=torch.float32).to(torch.complex64)
    head = -torch.arange(1, 4, dtype=torch.float32).to(torch.complex64)
    before = tg.gather_windows.launches
    got = tg.gather_windows(x, torch.tensor([-2, 11, 0], dtype=torch.int32),
                            4, head=head)
    want = torch.tensor([[0, 0, -1, -2], [9, 10, 0, 0], [-1, -2, -3, 1]],
                        dtype=torch.complex64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tg.gather_windows.launches == before


@pytest.mark.parametrize("bad", ["starts_dtype", "starts_2d", "x_dtype",
                                 "head_device"])
def test_gather_rejects_bad_inputs(bad):
    x = torch.zeros(64, dtype=torch.complex64)
    starts = torch.zeros(3, dtype=torch.int32)
    head = None
    if bad == "starts_dtype":
        starts = starts.to(torch.int64)
    elif bad == "starts_2d":
        starts = starts.reshape(3, 1)
    elif bad == "x_dtype":
        x = torch.zeros(64, dtype=torch.float32)
    else:
        head = torch.zeros(8, dtype=torch.complex64, device="meta")
    with pytest.raises((TypeError, ValueError)):
        tg.gather_windows(x, starts, 4, head=head)
