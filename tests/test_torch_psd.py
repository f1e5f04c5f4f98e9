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
    for n in (192, 2048):
        assert tkpsd.supported(n) == jkpsd.supported(n) is False
    # the port's kernel also covers the per-channel bins 16, 32 and 64
    for n in (16, 32, 64):
        assert tkpsd.supported(n) and not jkpsd.supported(n)
    with pytest.raises(ValueError):
        tkpsd.psd_fused(x, 2048)
    with pytest.raises(TypeError):
        tkpsd.psd_fused(x.to(torch.complex128), 1024)


def test_folded_window_is_the_reference_fold():
    w, *_ = jkpsd._cached(512, "hamming")
    got = tkpsd.folded_window(512, "hamming", torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(w)[0])
    assert jax.devices()[0].platform == "cpu"


# -- csrc/psd.cu's FFT plan, modelled in torch (complex128) -----------------
# N = A NL, NL = min(N, 32) lanes a frame: lane l holds samples NL a + l,
# runs the A-point DFT in registers (Good-Thomas: a Q-point DFT, Q in
# {1, 3, 5, 7}, and a radix-2 DIT FFT of P = A / Q), multiplies by the
# host table's W_N^(l k1), then either (N = 256, 512, 1024) transposes
# through a 32 x 33 tile, row A u + k1 of frame u, and runs a 32-point
# radix-2 FFT per row, or runs log2(NL) radix-2 DIF butterfly stages
# across the lanes, after which lane l holds bin k1 + A bitrev(l) and, from
# A = 4 on, stages it through row bitrev(l) of rows of A + 1 floats read
# back as bins lane + 32 i.  The model must give the plain version's
# powers at the bar of tests/test_kernels_psd.py.

TILED = (256, 512, 1024)           # csrc/psd.cu psd_tile_kernel


def _root(e, q):
    return np.exp(-2j * np.pi * np.asarray(e) / q)


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _fft2_model(a):
    """radix-2 DIT over the last axis as csrc/psd.cu fft2: bit-reversed
    input, butterflies of span 2h with W_32^(j 32 / 2h)."""
    P = a.shape[-1]
    bits = P.bit_length() - 1
    b = torch.empty_like(a)
    b[..., [_bitrev(i, bits) for i in range(P)]] = a
    h = 1
    while h < P:
        for s in range(0, P, 2 * h):
            for j in range(h):
                t = b[..., s + j + h] * complex(_root(j * (32 // (2 * h)), 32))
                lo = b[..., s + j].clone()
                b[..., s + j] = lo + t
                b[..., s + j + h] = lo - t
        h *= 2
    return b


def _dft_lane_model(y):
    """The in-lane A-point DFT over the last axis (Good-Thomas maps)."""
    A = y.shape[-1]
    Q = next((q for q in (7, 5, 3) if A % q == 0), 1)
    P = A // Q
    u = next((x for x in range(Q) if (P * x) % Q == 1 % Q), 0)
    v = next((x for x in range(P) if (Q * x) % P == 1 % P), 0)
    t = torch.stack([y[..., [(P * n1 + Q * n2) % A for n2 in range(P)]]
                     for n1 in range(Q)], -2)           # (..., Q, P)
    if Q > 1:
        W = torch.as_tensor(_root(np.outer(range(Q), range(Q)) % Q, Q))
        t = torch.einsum("...np,nk->...kp", t, W)
    t = _fft2_model(t)
    out = torch.empty_like(y)
    for k1 in range(Q):
        for k2 in range(P):
            out[..., (P * u * k1 + Q * v * k2) % A] = t[..., k1, k2]
    return out


def _kernel_model(x, N, window):
    """(..., n // N, N) float64 powers of x (..., n) as csrc/psd.cu
    computes them."""
    nf = x.shape[-1] // N
    w = torch.as_tensor(tkpsd._window(N, window))
    frames = x[..., : nf * N].reshape(*x.shape[:-1], nf, N).to(
        torch.complex128) * w
    NL, A = min(N, 32), N // min(N, 32)
    v = frames.reshape(*frames.shape[:-1], A, NL).transpose(-1, -2)
    Y = _dft_lane_model(v)                             # (..., nf, NL, A)
    Y = Y * torch.as_tensor(tkpsd.twiddles(N)).reshape(A, NL).T
    out = torch.empty_like(frames)
    if N in TILED:
        F = 32 // A                                     # frames a warp
        lead = Y.shape[:-3]
        Yp = torch.cat([Y, Y.new_zeros((*lead, -nf % F, NL, A))], -3)
        g = Yp.shape[-3] // F
        # row A u + k1 of warp g's tile holds frame g F + u's values of k1
        tile = Yp.reshape(*lead, g, F, NL, A).transpose(-1, -2).reshape(
            *lead, g, 32, NL)
        Z = _fft2_model(tile).reshape(*lead, g, F, A, 32)  # (u, k1, k2)
        # lane A u + k1 stores bins k1 + A k2 of its frame
        out = Z.transpose(-1, -2).reshape(*lead, g * F, N)[..., :nf, :]
    else:
        H = Y.transpose(-1, -2)                         # (..., nf, A, NL)
        lp = torch.arange(NL)
        for s in range(NL.bit_length() - 1):
            half = NL >> (s + 1)
            upper = (lp & half) != 0
            b = H[..., lp ^ half]
            tw = torch.as_tensor(_root(lp & (half - 1), 2 * half))
            H = torch.where(upper, (b - H) * tw, H + b)
        k2 = torch.as_tensor([_bitrev(i, NL.bit_length() - 1)
                              for i in range(NL)])
        held = torch.arange(A)[:, None] + A * k2[None, :]  # lane's bins
        if A >= 4:                                        # staged rows
            st = torch.zeros((*H.shape[:-2], 32, A + 1), dtype=H.dtype)
            st[..., k2, :A] = H.transpose(-1, -2)
            k = torch.arange(N)
            out = st[..., k // A, k % A]
        else:
            out[..., held.reshape(-1)] = H.reshape(*H.shape[:-2], -1)
    return out.real ** 2 + out.imag ** 2


@pytest.mark.parametrize("fft_len", tkpsd.COVERED)
def test_kernel_plan_model_matches_plain_and_jax(fft_len):
    """The model of the kernel's plan at every covered N, on 2 rows with a
    ragged tail, against the plain version, and against the JAX package:
    its Pallas kernel (interpret mode) at 128 n1, its XLA chain else."""
    x = np.stack([_sig(fft_len * 8 + 7, seed=fft_len + s) for s in (0, 1)])
    got = _kernel_model(torch.as_tensor(x), fft_len, "blackman_harris")
    assert got.shape == (2, 8, fft_len)
    want = tkpsd.psd_fused_plain(torch.as_tensor(x), fft_len,
                                 "blackman_harris")
    _assert_power_close(got, want)
    if jkpsd.supported(fft_len):
        with pltpu.force_tpu_interpret_mode():
            ref = np.stack([np.asarray(jkpsd.psd_fused(
                jnp.asarray(row), fft_len, "blackman_harris")) for row in x])
    else:
        ref = jpsd.psd_frames(jnp.asarray(x), fft_len, "blackman_harris")
    _assert_power_close(got, ref)


@pytest.mark.parametrize("shape, fft_len", [((3, 5 * 64 + 7), 64),
                                            ((4, 2, 16 * 9 + 3), 16),
                                            ((2, 32 * 33), 32),
                                            ((3, 5 * 384 + 7), 384)])
def test_batched_ragged_rows_match_jax_xla(shape, fft_len):
    """psd_frames on batched inputs whose rows end in a ragged tail: each
    row's tail is dropped, as the JAX chain drops it."""
    rng = np.random.RandomState(fft_len)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    got = tpsd.psd_frames(torch.as_tensor(x), fft_len)
    want = jpsd.psd_frames(jnp.asarray(x), fft_len)
    assert got.shape == want.shape
    _assert_power_close(got, want)
    _assert_power_close(_kernel_model(torch.as_tensor(x), fft_len, "hann"),
                        want)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("fft_len", [16, 32, 48, 64, 100, 128, 192, 384,
                                     1024, 1152, 2048])
def test_psd_route_for_every_case(device, fft_len):
    """CPU: the plain chain at any length; the card: the kernel at the
    covered lengths, and the XLA chain's torch ops ("torch") at the others
    (never the kernel's plain version)."""
    route = tpsd.psd_route(device, fft_len)
    if device == "cpu":
        assert route == "plain"
    else:
        assert route == ("kernel" if fft_len in tkpsd.COVERED else "torch")
    assert (fft_len in tkpsd.COVERED) == tkpsd.supported(fft_len)
