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
from tpu_ofdm import config as jconfig
from tpu_ofdm.kernels.sc_detect import sc_detect_rows as jax_sc_detect_rows
from tpu_ofdm.ops import sync as jsync
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.kernels import sc_detect as tk
from tpu_ofdm_torch.ops import sync as tsync

N = 3 * 256 * 128 + 1000   # several Pallas tiles, a ragged last row


def _specs(fft_len, cp):
    """The same config's spec from the port's config and the JAX
    package's."""
    kw = dict(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    return tconfig.OfdmConfig(**kw).spec, jconfig.OfdmConfig(**kw).spec


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
    window sums from one float32 cumsum, the port's plain version from
    float64 sums of each window, the Pallas kernel from bf16 hi/lo
    matmuls."""
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
    tspec, spec = _specs(fft_len, cp)
    x = _noise(5, N, 0.5)
    got = _port_rows(tspec, x)
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
    spec, _ = _specs(64, 16)
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
    tspec, spec = _specs(fft_len, cp)
    starts = [4000, 50000, 90000]
    x = _with_frames(spec, 6, starts)
    n_sm = N - spec.fft_len - spec.cp_len + 1
    port_rows, jnp_rows = _port_rows(tspec, x), _jnp_rows(spec, x)
    # the selection logic alone: port and JAX on the same rows, exactly
    sel_pj = _select(tsync, tspec, jnp_rows, n_sm)
    sel_jj = _select(jsync, spec, jnp_rows, n_sm)
    v = sel_jj[2]
    assert v.sum() == len(starts)
    np.testing.assert_array_equal(sel_pj[2], v)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(sel_pj[i][v], sel_jj[i][v])
    # the whole detection: port rows vs jnp rows, and vs detect_frames
    sel_pp = _select(tsync, tspec, port_rows, n_sm)
    np.testing.assert_array_equal(sel_pp[2], v)
    np.testing.assert_array_equal(sel_pp[0][v], sel_jj[0][v])
    np.testing.assert_allclose(sel_pp[1][v], sel_jj[1][v], rtol=1e-3, atol=1e-4)
    det = tsync.detect_frames(tspec, torch.as_tensor(x), 8)
    np.testing.assert_array_equal(det.start.numpy(), sel_pp[0])
    np.testing.assert_array_equal(det.valid.numpy(), v)
    for s, want in zip(det.start.numpy()[v], starts):
        assert want <= s <= want + spec.cp_len


def test_wrapper_takes_plain_version_on_cpu():
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
        x = x.reshape(2, 2, 1024)
    elif bad == "stride":
        x = torch.zeros(8192, dtype=torch.complex64)[::2]
    else:
        head = torch.zeros(100, dtype=torch.float32)
    with pytest.raises((TypeError, ValueError)):
        tk.sc_detect_rows(x, 32, 16, head=head)


# -- a model of the CUDA kernel's summation order (csrc/sc_detect.cu) -------
#
# The kernel cannot run here, so its index arithmetic is modelled in torch:
# the same strips (16 rows a warp, after a warm-up from chunk k0: one row
# in sc_detect_l32_kernel), the same 32-position segments aligned at
# position 0, a window as its segment's prefix plus the totals of the
# segments it spans plus the suffix T_a - C_a(i) of the segment where it
# starts (sc_detect_kernel) or plus that suffix summed directly
# (sc_detect_l32_kernel), the values of the chunks before k0 read as zero,
# R1 and the picks read back, and the W-boxcar of M by the same segment
# sums.  It must give the plain version's rows at chip_smoke.py's bars
# (compare_rows).

CHUNK = 32           # csrc/sc_detect.cu kChunk: one position a lane
ROWS_PER_WARP = 16   # csrc/sc_detect.cu kRowsPerWarp


def _chunks(v):
    return -(-v // CHUNK)


def _chunk_window(C, dist, i):
    """The kernel's Ring::window over a ring laid out as (chunks, 32): the
    sum of the window ending at each (chunk, lane) whose start lies
    dist[lane] chunks back at index i[lane]."""
    idx = torch.arange(C.shape[0])[:, None]
    a = (idx - dist).clamp(min=0)
    T = C[:, CHUNK - 1]
    acc = torch.where(dist > 0, T[a] - C[a, i], -C[a, i])
    for b in range(1, int(dist.max())):
        acc = acc + torch.where(b < dist, T[(idx - b).clamp(min=0)], 0.0)
    return acc + C


def _suffix_window(f):
    """sc_detect_l32_kernel's window of 32 ending at each (chunk, lane): the
    previous chunk's terms after the same lane, summed as a suffix, plus
    this chunk's prefix."""
    S = torch.flip(torch.cumsum(torch.flip(f, [-1]), -1), [-1])
    E = torch.cat([S[:, 1:], torch.zeros_like(S[:, :1])], -1)
    return torch.cat([torch.zeros_like(E[:1]), E[:-1]]) + torch.cumsum(f, -1)


def _kernel_model_rows(x, L, cp, head=None, suffix=True):
    """`suffix`: the L = 32 kernel's window as it is; False models the
    T_a - C_a(i) form it had before, which the any-L kernel keeps."""
    v = x if head is None else torch.cat([head, x])
    nv = v.shape[0]
    W, c = cp + 1, cp - cp // 2
    D = max(_chunks(L) + 1, _chunks(W) + 1, 4 + _chunks(c))
    lane = torch.arange(CHUNK)
    dL = (L - lane + CHUNK - 1) // CHUNK
    iL = lane - L + CHUNK * dL
    dW = (W - lane + CHUNK - 1) // CHUNK
    iW = lane - W + CHUNK * dW
    rows = -(-nv // tk.ROW)
    out = [[] for _ in range(6)]

    def load(p):
        ok = (p >= 0) & (p < nv)
        return torch.where(ok, v[p.clamp(0, nv - 1)], 0)

    for row0 in range(0, rows, ROWS_PER_WARP):
        row1 = min(rows, row0 + ROWS_PER_WARP)
        if L == CHUNK and cp == 16:        # sc_detect_l32_kernel
            k0 = (row0 - 1) * tk.ROW // CHUNK
        else:
            k0 = (row0 * tk.ROW - 2 * L - W - (CHUNK - 1)) // CHUNK
        kf, k1 = row0 * tk.ROW // CHUNK, row1 * tk.ROW // CHUNK
        # D zero chunks stand for the ring before k0
        k = torch.arange(k0 - D, k1)[:, None]
        t = CHUNK * k + lane
        live = k >= k0
        a = torch.view_as_real(load(t))
        b = torch.view_as_real(load(t - L))
        terms = (b[..., 0] * a[..., 0] + b[..., 1] * a[..., 1],
                 b[..., 0] * a[..., 1] - b[..., 1] * a[..., 0],
                 a[..., 0] ** 2 + a[..., 1] ** 2)
        l32 = L == CHUNK and cp == 16 and suffix
        Pre, Pim, R2 = (
            torch.where(live, _suffix_window(torch.where(live, f, 0.0)) if l32
                        else _chunk_window(torch.where(
                            live, torch.cumsum(f, -1), 0.0), dL, iL), 0.0)
            for f in terms)
        idx = torch.arange(k.shape[0])[:, None]
        R1 = R2[(idx - dL).clamp(min=0), iL]
        den = R1 * R2
        p2 = Pre ** 2 + Pim ** 2
        M = torch.where(den > 0, (p2 / den.clamp(min=1e-12)).clamp(max=2.0),
                        0.0)
        CM = torch.where(live, torch.cumsum(torch.where(live, M, 0.0), -1),
                         0.0)
        sm = _chunk_window(CM, dW, iW) * (1.0 / W) + tk.tiebreak(t)
        sm = torch.where((t >= 2 * L + W - 2) & (t < nv), sm, float("-inf"))
        r2t = torch.where((t >= 2 * L - 1) & (t < nv), R2, 0.0)
        mine = slice(kf - (k0 - D), None)
        smr = sm[mine].reshape(-1, tk.ROW)
        arg = smr.argmax(-1)
        ts = t[mine].reshape(-1, tk.ROW).gather(-1, arg[:, None])[:, 0]
        tc = ts - c
        ok = (tc >= 2 * L - 1) & (tc < nv)
        ic = (tc // CHUNK - (k0 - D)).clamp(0, k.shape[0] - 1)

        def pick(z):
            return torch.where(ok, z[ic, tc % CHUNK], 0.0)

        for o, r in zip(out, (smr.amax(-1), ts.to(torch.int32), pick(Pre),
                              pick(Pim), pick(R2),
                              r2t[mine].reshape(-1, tk.ROW).amax(-1))):
            o.append(r)
    return tuple(torch.cat(o) for o in out)


@pytest.mark.parametrize("h", [0, 3072])
@pytest.mark.parametrize("fft_len,cp", [(64, 16), (256, 64)])
def test_kernel_summation_model_matches_plain(fft_len, cp, h):
    """The CUDA kernel's strips and chunk edges, modelled in torch, give
    the plain version's rows: argmax identical on >= 99% of rows, the
    other rows at rtol 1e-4 / atol 1e-5 where it agrees (chip_smoke.py's
    compare_rows), and identical selections."""
    tspec, spec = _specs(fft_len, cp)
    n = 40000
    starts = [1000, 9000, 20000, 33000]
    v = torch.as_tensor(_with_frames(spec, 11, starts)[: h + n])
    head = v[:h] if h else None
    L = fft_len // 2
    got = _kernel_model_rows(v[h:], L, cp, head)
    ref = tk.sc_detect_rows_plain(v[h:], L, cp, head=head)
    same = got[1] == ref[1]
    assert same.float().mean() >= 0.99
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))
    live = torch.isfinite(ref[0]) & same
    for i in (0, 2, 3, 4, 5):
        m = live if i < 5 else torch.ones_like(live)
        torch.testing.assert_close(got[i][m], ref[i][m], rtol=1e-4,
                                   atol=1e-5)
    n_sm = h + n - fft_len - cp + 1
    (st, cfo, valid, _), (st_r, cfo_r, valid_r, _) = (
        _select(tsync, tspec, [r.numpy() for r in rows], n_sm)
        for rows in (got, ref))
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_array_equal(st[valid], st_r[valid])
    np.testing.assert_allclose(cfo[valid], cfo_r[valid], rtol=1e-3,
                               atol=1e-4)
    assert valid.sum() == len(starts)


def test_kernel_summation_model_holds_a_channel_beside_a_frame():
    """Config 5's dynamic range (fft 64): a frame times 512 channels through
    the 512-channel synthesis filterbank over 0.01-rms noise, channelized
    again, comes out ~1e5 over the channel noise, and its neighbour channel
    holds a window just past a strong segment.  The L = 32 kernel's
    summation (a window's start summed as a suffix) gives the plain rows
    of channels 20-22 at compare_rows' bars carried to that scale (P and R,
    products of two samples, at atol 1e-5 * unit^2; M's boxcar at 1e-5);
    the T_a - C_a(i) form it replaced misses them on the neighbour."""
    from tpu_ofdm_torch.spectrum.channelizer import (channelize, lowpass_taps,
                                                     synthesize_bursts)
    n_chan, per = 512, 6144
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(48)), 21).astype(np.complex64)
    taps = lowpass_taps(n_chan, taps_per_arm=8)
    wide = synthesize_bursts(n_chan * per, n_chan, [(21, 300, frame * n_chan)],
                             taps=taps)
    rng = np.random.RandomState(0)
    wide += ((rng.randn(wide.size) + 1j * rng.randn(wide.size)) * 0.01).astype(
        np.complex64)
    x = channelize(torch.as_tensor(wide), n_chan, taps).t()[20:23]
    unit = x.abs().max().item() / np.abs(frame).max()
    assert unit > 1e4
    ref = tk.sc_detect_rows_plain(x, 32, 16)

    def worst(suffix):
        """The largest ratio of |model - plain| to its bar."""
        got = [torch.stack(r) for r in zip(*(
            _kernel_model_rows(row, 32, 16, suffix=suffix) for row in x))]
        live = torch.isfinite(ref[0]) & (got[1] == ref[1])
        return max(((got[i] - ref[i]).abs()
                    / ((1e-5 if i == 0 else 1e-5 * unit ** 2)
                       + 1e-4 * ref[i].abs()))[live].max().item()
                   for i in (0, 2, 3, 4))

    assert worst(True) <= 1.0
    assert worst(False) > 10.0
