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
# segments it spans plus the suffix of the segment where it starts, summed
# directly (the T_a - C_a(i) form the kernels had before is kept as a
# foil), the values of the chunks before k0 read as zero, R1 and the picks
# read back, and the W-boxcar of M by the same segment sums.  It must give
# the plain version's rows at chip_smoke.py's bars (compare_rows).

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


def _chunk_suffix_window(f, dist, i):
    """sc_detect_kernel's Ring::window with its suffix rings: the same
    window as _chunk_window over the terms f (chunks, 32), its start chunk
    summed as that chunk's suffix past i rather than T_a - C_a(i)."""
    C = torch.cumsum(f, -1)
    S = torch.flip(torch.cumsum(torch.flip(f, [-1]), -1), [-1])
    E = torch.cat([S[:, 1:], torch.zeros_like(S[:, :1])], -1)
    idx = torch.arange(C.shape[0])[:, None]
    a = (idx - dist).clamp(min=0)
    T = C[:, CHUNK - 1]
    acc = torch.where(dist > 0, E[a, i], -C[a, i])
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
    """`suffix`: both kernels' windows as they are, a start summed as a
    suffix; False models the T_a - C_a(i) form they had before."""
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
        l32 = L == CHUNK and cp == 16

        def window(f, d, i):
            f = torch.where(live, f, 0.0)
            if suffix and l32:
                return _suffix_window(f)
            if suffix:
                return _chunk_suffix_window(f, d, i)
            return _chunk_window(torch.cumsum(f, -1), d, i)

        Pre, Pim, R2 = (torch.where(live, window(f, dL, iL), 0.0)
                        for f in terms)
        idx = torch.arange(k.shape[0])[:, None]
        R1 = R2[(idx - dL).clamp(min=0), iL]
        den = R1 * R2
        p2 = Pre ** 2 + Pim ** 2
        M = torch.where(den > 0, (p2 / den.clamp(min=1e-12)).clamp(max=2.0),
                        0.0)
        # the W-boxcar of M: sc_detect_l32_kernel keeps T_a - C_a
        box = (_chunk_window(torch.cumsum(torch.where(live, M, 0.0), -1),
                             dW, iW) if l32 or not suffix
               else _chunk_suffix_window(torch.where(live, M, 0.0), dW, iW))
        sm = box * (1.0 / W) + tk.tiebreak(t)
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


def test_kernel_summation_model_holds_a_quiet_stretch_past_a_frame():
    """The any-L kernel (fft 256, cp 64): golden frames ~1e5 over 0.01-rms
    noise, each followed by a quiet stretch past its trailing edge, where
    windows start inside the frame's last strong chunk.  The 16 frames end
    at 16 offsets within a 32-position chunk (2 apart).  The suffix sums
    give the plain rows at compare_rows' bars carried to that scale (P and
    R at atol 1e-5 * unit^2; M's boxcar at 1e-5); the T_a - C_a(i) form
    misses them by more than 10x."""
    unit = 1000.0
    gp = G.GoldenOfdmParams(fft_len=256, cp_len=64, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(48)), 3).astype(np.complex64)
    x = _noise(12, 40000, 0.01)
    for j in range(16):
        p = 1000 + 2402 * j
        x[p:p + len(frame)] += frame * np.float32(unit)
    x = torch.as_tensor(x)
    ref = tk.sc_detect_rows_plain(x, 128, 64)

    def worst(suffix):
        """The largest ratio of |model - plain| to its bar."""
        got = _kernel_model_rows(x, 128, 64, suffix=suffix)
        live = torch.isfinite(ref[0]) & (got[1] == ref[1])
        return max(((got[i] - ref[i]).abs()
                    / ((1e-5 if i == 0 else 1e-5 * unit ** 2)
                       + 1e-4 * ref[i].abs()))[live].max().item()
                   for i in (0, 2, 3, 4))

    assert worst(True) <= 1.0
    assert worst(False) > 10.0


# -- a model of sc_detect_seg_kernel (fft 128 to 1024) -----------------------
#
# The segment kernel's index scheme in torch: strips of max(32, 10 x warm)
# rows after `warm` = ceil((2L + W - 2) / 128) rows of warm-up, segments of
# S = 64 positions below L = 128 and of a row (128) from there on, a window
# ending at t as E(t - L) (the terms of t - L's segment after it) plus the
# totals of the whole segments between plus t's segment prefix C(t), R1 and
# E(t - L) read back, zeros before the strip's first row (v[u - L] too at
# L <= 128, where the kernel keeps the previous row in registers; past it
# the sample ring holds the rows before), the W-boxcar of M as Cm(t) + the
# M totals of the rows between - Cm(t - W) over row prefixes, and the picks
# at t* - c.  `suffix` False forms E(t - L) as T - C(t - L), the foil.

SEG_STRIP_MIN = 32   # csrc/sc_detect.cu kSegStripMin
SEG_WARM_SHARE = 10  # csrc/sc_detect.cu kSegWarmShare


def _seg_model_rows(x, L, cp, head=None, suffix=True):
    v = x if head is None else torch.cat([head, x])
    nv = v.shape[0]
    W, c = cp + 1, cp - cp // 2
    S = 64 if L < tk.ROW else tk.ROW
    warm = -(-(2 * L + W - 2) // tk.ROW)
    strip = max(SEG_STRIP_MIN, SEG_WARM_SHARE * warm)
    rows = -(-nv // tk.ROW)
    out = [[] for _ in range(6)]

    def load(p):
        ok = (p >= 0) & (p < nv)
        return torch.where(ok, v[p.clamp(0, nv - 1)], 0)

    for row0 in range(0, rows, strip):
        row1 = min(rows, row0 + strip)
        base = tk.ROW * (row0 - warm)          # the strip's first position
        t = torch.arange(base, tk.ROW * row1)
        i = t - base                           # strip-local index
        il = i - L                             # of t - L; < 0: before it
        a = torch.view_as_real(load(t))
        b = torch.view_as_real(torch.where(
            (il >= 0) | (L > tk.ROW), load(t - L), 0))
        terms = (b[:, 0] * a[:, 0] + b[:, 1] * a[:, 1],
                 b[:, 0] * a[:, 1] - b[:, 1] * a[:, 0],
                 a[:, 0] ** 2 + a[:, 1] ** 2)
        seg, seg_l = i // S, torch.div(il, S, rounding_mode="floor")

        def back(z, j):
            """z at strip-local index j, 0 before the strip."""
            return torch.where(j >= 0, z[j.clamp(min=0)], 0.0)

        def window(f):
            f = f.reshape(-1, S)
            C = torch.cumsum(f, -1)
            T = C[:, -1]
            if suffix:
                E = torch.flip(torch.cumsum(torch.flip(f, [-1]), -1), [-1])
                start = torch.cat([E[:, 1:], torch.zeros_like(E[:, :1])],
                                  -1).reshape(-1)
            else:
                start = (T[:, None] - C).reshape(-1)
            mid = torch.zeros_like(start)
            for k in range(1, L // S + 1):     # whole segments between
                j = seg - k
                mid = mid + torch.where((j > seg_l) & (j >= 0),
                                        T[j.clamp(min=0)], 0.0)
            return (back(start, il) + mid) + C.reshape(-1)

        Pre, Pim, R2 = (window(f) for f in terms)
        R1 = back(R2, il)
        den = R1 * R2
        p2 = Pre ** 2 + Pim ** 2
        M = torch.where(den > 0, (p2 / den.clamp(min=1e-12)).clamp(max=2.0),
                        0.0)
        Cm = torch.cumsum(M.reshape(-1, tk.ROW), -1)
        Tm = Cm[:, -1]
        iq = i - W
        kq = i // tk.ROW - torch.div(iq, tk.ROW, rounding_mode="floor")
        g = torch.zeros_like(M)
        for k in range(1, -(-2 * L // tk.ROW) + 1):
            j = i // tk.ROW - k
            g = g + torch.where((k <= kq) & (j >= 0), Tm[j.clamp(min=0)], 0.0)
        box = (g - back(Cm.reshape(-1), iq)) + Cm.reshape(-1)
        sm = box * (1.0 / W) + tk.tiebreak(t)
        sm = torch.where((t >= 2 * L + W - 2) & (t < nv), sm, float("-inf"))
        r2t = torch.where((t >= 2 * L - 1) & (t < nv), R2, 0.0)
        mine = slice(warm * tk.ROW, None)
        smr = sm[mine].reshape(-1, tk.ROW)
        arg = smr.argmax(-1)
        ts = t[mine].reshape(-1, tk.ROW).gather(-1, arg[:, None])[:, 0]
        tc = ts - c
        ok = (tc >= 2 * L - 1) & (tc < nv)

        def pick(z):
            return torch.where(ok, z[(tc - base).clamp(0, len(z) - 1)], 0.0)

        for o, r in zip(out, (smr.amax(-1), ts.to(torch.int32), pick(Pre),
                              pick(Pim), pick(R2),
                              r2t[mine].reshape(-1, tk.ROW).amax(-1))):
            o.append(r)
    return tuple(torch.cat(o) for o in out)


def _rows_match(got, ref, unit=1.0):
    """chip_smoke.py's compare_rows: argmax identical on >= 99% of rows,
    the other rows at rtol 1e-4 / atol 1e-5 (P and R at 1e-5 * unit^2)
    where it agrees; -inf where the plain version has it."""
    same = got[1] == ref[1]
    assert same.float().mean() >= 0.99
    assert torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0]))
    live = torch.isfinite(ref[0]) & same
    for i in (0, 2, 3, 4, 5):
        m = live if i < 5 else torch.ones_like(live)
        torch.testing.assert_close(got[i][m], ref[i][m], rtol=1e-4,
                                   atol=1e-5 * (1.0 if i == 0 else unit ** 2))


def _same_selection(tspec, got, ref, nv, n_frames):
    """The selections of both rows: the same frames, the same starts but
    where a start sits on a float32 tie (chip_smoke.py check_selection:
    within 2 samples, row maxima within 2 ulps)."""
    n_sm = nv - tspec.fft_len - tspec.cp_len + 1
    sel = [tsync._select_from_rows(tspec, *r, n_sm=n_sm,
                                   max_frames=n_frames + 8,
                                   threshold=tspec.cfg.sync_threshold)
           for r in (got, ref)]
    v = sel[1].valid
    assert torch.equal(sel[0].valid, v)
    assert int(v.sum()) == n_frames
    moved = sel[0].start[v] != sel[1].start[v]
    assert ((sel[0].start[v] - sel[1].start[v]).abs() <= 2).all()
    a, b = sel[0][3][v][moved], sel[1][3][v][moved]
    assert ((a - b).abs() <= 2 * torch.finfo(torch.float32).eps
            * b.abs()).all()
    torch.testing.assert_close(sel[0].fine_cfo[v][~moved],
                               sel[1].fine_cfo[v][~moved], rtol=1e-3,
                               atol=1e-4)


SEG_N = 1 << 16   # every buffer of the segment model's cases


@pytest.mark.parametrize("h", [0, 4096])
@pytest.mark.parametrize("fft_len,cp", [(128, 32), (256, 64), (512, 128),
                                        (1024, 256), (256, 0)])
def test_seg_model_matches_plain_and_pallas(fft_len, cp, h):
    """The segment kernel's scheme, modelled in torch on [h | 2^16 - h]
    samples of golden frames, gives the plain version's rows at
    compare_rows' bars and (but at cp 0, where the selection finds extra
    frames on the plain rows too) its selection; and the JAX Pallas
    kernel's rows, run in TPU interpret mode on the same buffer, at
    tests/test_kernels_sc_detect.py's tolerances."""
    tspec, spec = _specs(fft_len, cp)
    gp = G.GoldenOfdmParams(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(40))).astype(np.complex64)
    x = _noise(13 + fft_len, SEG_N, 0.02)
    starts = list(range(700 + h, SEG_N - 2 * len(frame), 2 * len(frame)))
    for p in starts:
        x[p:p + len(frame)] += frame
    v = torch.as_tensor(x)
    head = v[:h] if h else None
    L = fft_len // 2
    assert tk.kernel_form(L, cp) == "seg"
    got = _seg_model_rows(v[h:], L, cp, head)
    ref = tk.sc_detect_rows_plain(v[h:], L, cp, head=head)
    _rows_match(got, ref)
    if cp:
        _same_selection(tspec, got, ref, SEG_N, len(starts))
    pallas = _pallas_rows(spec, x)
    live = np.isfinite(ref[0].numpy())
    pallas[0] = np.where(live, pallas[0], -np.inf)
    # at fft 1024, 9 of the 512 rows lie before the first full window
    _assert_rows_close([r.numpy() for r in got], pallas, live_frac=0.98)


@pytest.mark.parametrize("fft_len", [256, 512])
def test_seg_model_holds_a_quiet_stretch_past_a_frame(fft_len):
    """The segment kernel (fft 256 and 512, cp fft/4): golden frames ~1e5
    over 0.01-rms noise, each followed by a quiet stretch past its trailing
    edge, where windows start inside the frame's last strong row.  The
    frames end at offsets 16 apart within a row.  The suffix sums give the
    plain rows at compare_rows' bars carried to that scale (P and R at atol
    1e-5 * unit^2; M's boxcar at 1e-5); the T - C form misses them by more
    than 10x."""
    unit = 1000.0
    cp = fft_len // 4
    gp = G.GoldenOfdmParams(fft_len=fft_len, cp_len=cp, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(48)), 3).astype(np.complex64)
    gap = len(frame) + 3 * fft_len + 16
    n_frames = min(8, (SEG_N - 1000) // gap)
    x = _noise(14, SEG_N, 0.01)
    for j in range(n_frames):
        p = 1000 + gap * j
        x[p:p + len(frame)] += frame * np.float32(unit)
    x = torch.as_tensor(x)
    L = fft_len // 2
    ref = tk.sc_detect_rows_plain(x, L, cp)

    def worst(suffix):
        """The largest ratio of |model - plain| to its bar."""
        got = _seg_model_rows(x, L, cp, suffix=suffix)
        live = torch.isfinite(ref[0]) & (got[1] == ref[1])
        return max(((got[i] - ref[i]).abs()
                    / ((1e-5 if i == 0 else 1e-5 * unit ** 2)
                       + 1e-4 * ref[i].abs()))[live].max().item()
                   for i in (0, 2, 3, 4))

    assert worst(True) <= 1.0
    assert worst(False) > 10.0


@pytest.mark.parametrize("L,cp,form", [
    (32, 16, "l32"), (32, 8, "any_l"), (16, 4, "any_l"), (48, 24, "any_l"),
    (64, 32, "seg"), (96, 24, "seg"), (128, 0, "seg"), (128, 64, "seg"),
    (128, 255, "seg"), (128, 256, "any_l"), (512, 256, "seg"),
    (512, 1023, "seg"), (1024, 512, "any_l")])
def test_kernel_form_names_three_kernels(L, cp, form):
    """kernel_form follows csrc/sc_detect.cu's dispatch: the L = 32 kernel
    at fft 64 / cp 16, the segment kernel at L a multiple of 32 in [64,
    512] with cp < 2L, the any-L kernel elsewhere; the wrapper counts
    launches by these names."""
    assert tk.kernel_form(L, cp) == form
    assert form in tk.sc_detect_rows.forms
