"""The port's detect rows (plain version of the CUDA sc_detect kernel)
against the JAX package: its jnp rows, and its Pallas kernel run in TPU
interpret mode, as tests/test_kernels_sc_detect.py runs it.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm.kernels.sc_detect import sc_detect_rows as jax_sc_detect_rows
from tpu_ofdm.ops import sync as jsync
from tpu_ofdm_torch.kernels import sc_detect as tk
from tpu_ofdm_torch.ops import sync as tsync

N = 3 * 256 * 128 + 1000   # several Pallas tiles, a ragged last row


def _noise(seed, n, scale):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64) * scale


def _with_frames(spec, seed, starts):
    x = _noise(seed, N, 0.02)
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40))).astype(np.complex64)
    for p in starts:
        x[p:p + len(frame)] += frame
    return x


def _port_rows(spec, x, head=None):
    rows = tk.sc_detect_rows_plain(
        torch.as_tensor(x), spec.fft_len // 2, spec.cp_len,
        head=None if head is None else torch.as_tensor(head))
    return [r.numpy() for r in rows]


def _jnp_rows(spec, x):
    return [np.asarray(r) for r in jsync._detect_rows_jnp(spec, jnp.asarray(x))]


def _pallas_rows(spec, x):
    with pltpu.force_tpu_interpret_mode():
        got = jax.jit(lambda a: jax_sc_detect_rows(
            a, spec.fft_len // 2, spec.cp_len))(jnp.asarray(x))
    return [np.asarray(g) for g in got]


def _assert_rows_close(got, ref, live_frac=0.99, same_frac=0.95):
    """The tolerances of tests/test_kernels_sc_detect.py: the jnp rows take
    window sums from one float32 cumsum, the port's plain version from a
    float64 one, the Pallas kernel from bf16 hi/lo matmuls."""
    live = np.isfinite(ref[0])
    assert live.sum() > live_frac * live.size
    np.testing.assert_array_equal(np.isfinite(got[0]), live)
    np.testing.assert_allclose(got[0][live], ref[0][live], rtol=2e-3, atol=2e-3)
    same = got[1] == ref[1]
    assert same[live].mean() > same_frac
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i][same], ref[i][same],
                                   rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[5], ref[5], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("fft_len,cp", [(64, 16), (256, 64)])
def test_plain_rows_match_jnp_and_pallas(fft_len, cp):
    spec = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk").spec
    x = _noise(5, N, 0.5)
    got = _port_rows(spec, x)
    assert got[1].dtype == np.int32
    _assert_rows_close(got, _jnp_rows(spec, x))
    # the Pallas kernel fills t < 2L+W-2 with the ramp alone, not -inf;
    # compare where the jnp reference is live
    pallas = _pallas_rows(spec, x)
    live = np.isfinite(got[0])
    pallas[0] = np.where(live, pallas[0], -np.inf)
    _assert_rows_close(got, pallas)


@pytest.mark.parametrize("h", [1, 3072, 40000])
def test_head_split_equals_concat(h):
    """[head | x] read in place gives the rows of the concatenated buffer
    -- including a head shorter than one window and seams inside a row."""
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    v = _with_frames(spec, 8, [10, h - 900, h + 5000])
    split = _port_rows(spec, v[h:], head=v[:h])
    whole = _port_rows(spec, v)
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a, b)


def _select(mod, spec, rows, n_sm):
    as_ = torch.as_tensor if mod is tsync else jnp.asarray
    sel = mod._select_from_rows(
        spec, *(as_(np.array(r)) for r in rows), n_sm=n_sm, max_frames=8,
        threshold=spec.cfg.sync_threshold)
    return [np.asarray(s) for s in sel]


@pytest.mark.parametrize("fft_len,cp", [(64, 16), (256, 64)])
def test_selection_identical_on_golden_frames(fft_len, cp):
    spec = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk").spec
    starts = [4000, 50000, 90000]
    x = _with_frames(spec, 6, starts)
    n_sm = N - spec.fft_len - spec.cp_len + 1
    port_rows, jnp_rows = _port_rows(spec, x), _jnp_rows(spec, x)
    # the selection logic alone: port and JAX on the same rows, exactly
    sel_pj = _select(tsync, spec, jnp_rows, n_sm)
    sel_jj = _select(jsync, spec, jnp_rows, n_sm)
    v = sel_jj[2]
    assert v.sum() == len(starts)
    np.testing.assert_array_equal(sel_pj[2], v)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(sel_pj[i][v], sel_jj[i][v])
    # the whole detection: port rows vs jnp rows, and vs detect_frames
    sel_pp = _select(tsync, spec, port_rows, n_sm)
    np.testing.assert_array_equal(sel_pp[2], v)
    np.testing.assert_array_equal(sel_pp[0][v], sel_jj[0][v])
    np.testing.assert_allclose(sel_pp[1][v], sel_jj[1][v], rtol=1e-3, atol=1e-4)
    det = tsync.detect_frames(spec, torch.as_tensor(x), 8)
    np.testing.assert_array_equal(det.start.numpy(), sel_pp[0])
    np.testing.assert_array_equal(det.valid.numpy(), v)
    for s, want in zip(det.start.numpy()[v], starts):
        assert want <= s <= want + spec.cp_len


def test_wrapper_takes_plain_version_on_cpu():
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    x = torch.as_tensor(_noise(9, 5000, 0.5))
    head = torch.as_tensor(_noise(10, 300, 0.5))
    before = tk.sc_detect_rows.launches
    got = tk.sc_detect_rows(x, 32, 16, head=head)
    want = tk.sc_detect_rows_plain(x, 32, 16, head=head)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tk.sc_detect_rows.launches == before
    assert got[0].shape == (-(-5300 // 128),)


@pytest.mark.parametrize("bad", ["dtype", "ndim", "stride", "head_dtype"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(4096, dtype=torch.complex64)
    head = None
    if bad == "dtype":
        x = x.to(torch.complex128)
    elif bad == "ndim":
        x = x.reshape(2, 2048)
    elif bad == "stride":
        x = torch.zeros(8192, dtype=torch.complex64)[::2]
    else:
        head = torch.zeros(100, dtype=torch.float32)
    with pytest.raises((TypeError, ValueError)):
        tk.sc_detect_rows(x, 32, 16, head=head)
