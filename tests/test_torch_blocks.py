"""The port's utility blocks (tpu_ofdm_torch/stream/block.py) against the
JAX package's on the same numpy inputs, each run chunked through both
packages' StreamExecutor (several pushes, so every carry crosses block
seams).  Outputs and final carries are compared leaf by leaf at
atol = tol * max(1, max|want|), tol stated per case: 1e-6 for exact or
elementwise math, 1e-5 for the FFT FIRs and the float32 scans (the JAX
package uses shifted multiply-adds, a Toeplitz matmul and associative
scans), 1e-4 where the float32 mixer phase of freq_xlating_fir sits at
~330 rad.  FIR and resampler cases sit on both sides of the JAX package's
33-tap switch between its two FIR cores, with real and complex taps,
decimation and interpolation."""

import numpy as np
import pytest
import torch

import jax

from tpu_ofdm.ops import firdes as jfirdes
from tpu_ofdm.stream import block as jb
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.kernels import scan as tscan
from tpu_ofdm_torch.stream import block as tb
from tpu_ofdm_torch.stream import executor as tex

N = 4096


def _c64(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _f32(seed=0, n=N):
    return (np.abs(np.random.RandomState(seed).randn(n)) + 0.1).astype(
        np.float32)


def _tone(f, n=N):
    return np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)


LP21 = jfirdes.low_pass(1.0, 8.0, 1.5, 0.75, ntaps=21)      # K < 33
LP97 = jfirdes.low_pass(1.0, 8.0, 1.0, 0.5, ntaps=97)       # K >= 33
LP25 = jfirdes.low_pass(3.0, 24.0, 3.0, 1.5, ntaps=25)      # 9 taps an arm
LP81 = jfirdes.low_pass(2.0, 16.0, 3.0, 1.0, ntaps=81)      # 41 taps an arm
CBP41 = jfirdes.complex_band_pass(1.0, 8.0, 1.0, 3.0, 0.5, ntaps=41)
RAND16 = np.random.RandomState(5).randn(16).astype(np.float32)

# id -> (factory(module), input, block size, tol); the factory gets the
# package's block module (jb or tb) and the package's complex dtype
CASES = {
    "multiply_const": (lambda m, c: m.multiply_const(2.5), _c64(), 512, 1e-6),
    "multiply_const_complex": (lambda m, c: m.multiply_const(1.5 - 0.5j),
                               _f32(), 512, 1e-6),
    "add_const": (lambda m, c: m.add_const(1.0 + 2j), _c64(), 512, 1e-6),
    "complex_to_mag_squared": (lambda m, c: m.complex_to_mag_squared(),
                               _c64(), 512, 1e-6),
    "nlog10": (lambda m, c: m.nlog10(), _f32(), 512, 1e-6),
    "nlog10_scaled": (lambda m, c: m.nlog10(20.0, 3.0, 1e-3), _f32() - 0.5,
                      512, 1e-6),
    "stream_to_vector": (lambda m, c: m.stream_to_vector(64), _c64(), 512,
                         1e-6),
    "vector_to_stream": (lambda m, c: m.vector_to_stream(),
                         _c64().reshape(-1, 64), 64, 1e-6),
    "delay": (lambda m, c: m.delay(17), _c64(), 512, 1e-6),
    "delay_longer_than_block": (lambda m, c: m.delay(700), _c64(), 512, 1e-6),
    "moving_average": (lambda m, c: m.moving_average(8), _f32(), 512, 1e-5),
    "moving_average_scaled": (lambda m, c: m.moving_average(1000,
                                                            scale=1e-3),
                              _f32(), 512, 1e-5),
    "moving_average_complex": (lambda m, c: m.moving_average(5, dtype=c),
                               _c64(), 512, 1e-5),
    "single_pole_iir": (lambda m, c: m.single_pole_iir(0.1), _f32(), 512,
                        1e-5),
    "single_pole_iir_slow": (lambda m, c: m.single_pole_iir(0.002), _f32(),
                             1024, 1e-5),
    "fir_filter_21": (lambda m, c: m.fir_filter(LP21), _c64(), 512, 1e-5),
    "fir_filter_97": (lambda m, c: m.fir_filter(LP97), _c64(), 512, 1e-5),
    "fir_filter_complex_taps": (lambda m, c: m.fir_filter(CBP41), _c64(),
                                512, 1e-5),
    "fir_filter_decim": (lambda m, c: m.fir_filter(RAND16, decim=4), _c64(),
                         512, 1e-5),
    "fir_filter_97_decim": (lambda m, c: m.fir_filter(LP97, decim=4),
                            _c64(), 512, 1e-5),
    # the mixer's float32 phase reaches ~330 rad in a push of 512, where
    # one ulp is 3e-5 rad: cos/sin there differ by that much between the
    # packages' math libraries
    "freq_xlating_fir": (lambda m, c: m.freq_xlating_fir(LP21, 0.25),
                         _tone(0.25) + 0.1 * _c64(), 512, 1e-4),
    "freq_xlating_fir_decim": (lambda m, c: m.freq_xlating_fir(LP97, 0.1,
                                                               decim=4),
                               _tone(0.1) + 0.1 * _c64(), 512, 1e-4),
    "interpolating_fir": (lambda m, c: m.interpolating_fir(LP25, 3), _c64(),
                          512, 1e-5),
    "interpolating_fir_long": (lambda m, c: m.interpolating_fir(LP81, 2),
                               _c64(), 512, 1e-5),
    "rational_resampler": (lambda m, c: m.rational_resampler(LP25, 3, 2),
                           _c64(), 512, 1e-5),
    "rational_resampler_long": (lambda m, c: m.rational_resampler(LP81, 2, 4),
                                _c64(), 512, 1e-5),
    "head": (lambda m, c: m.head(1000), _c64(), 512, 1e-6),
    "probe_rate": (lambda m, c: m.probe_rate(), _c64(), 512, 1e-6),
}


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.iscomplexobj(got) == np.iscomplexobj(want), what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_jax_chunked(case):
    make, x, bs, tol = CASES[case]
    jblk, tblk = make(jb, jax.numpy.complex64), make(tb, torch.complex64)
    assert tblk.name == jblk.name
    jx = jex.StreamExecutor(jblk, bs, donate=False)
    tx = tex.StreamExecutor(tblk, bs, device="cpu")
    want = [jax.tree.leaves(o) for o in jx.run(x)]
    got = [tex.tree_leaves(o) for o in tx.run(x)]
    assert len(got) == len(want) == -(-x.shape[-1] // bs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            _close(a.numpy(), b, tol, f"{case} push {i}")
    js, ts = jax.tree.leaves(jx.state), tex.tree_leaves(tx.state)
    assert len(js) == len(ts)
    for a, b in zip(ts, js):
        _close(a.numpy(), np.asarray(b).astype(a.numpy().dtype), tol,
               f"{case} carry")


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_moving_average_takes_one_scan_call_per_push(dtype, monkeypatch):
    """The prefix sum comes from kernels.scan.cumsum, once per push for a
    complex stream too (real and imaginary parts stacked): on CUDA that is
    one scan launch per push."""
    calls = []

    def counted(x, axis=-1):
        calls.append(tuple(x.shape))
        return tscan.cumsum_plain(x, axis)

    monkeypatch.setattr(tscan, "cumsum", counted)
    ex = tex.StreamExecutor(tb.moving_average(16, dtype=dtype), 256,
                            device="cpu")
    x = torch.ones(4 * 256, dtype=dtype)
    y = torch.cat(ex.run(x))
    assert len(calls) == 4
    assert torch.allclose(y[15:].real, torch.full((1024 - 15,), 16.0))


def test_decay_scan_matches_the_recurrence():
    """z[i] = r z[i-1] + b[i] along either axis, against a float64 loop."""
    rng = np.random.RandomState(7)
    b = rng.randn(3, 100).astype(np.float32)
    r = 0.93
    want = np.zeros_like(b, dtype=np.float64)
    acc = np.zeros(3)
    for i in range(100):
        acc = r * acc + b[:, i]
        want[:, i] = acc
    got = tb.decay_scan(torch.as_tensor(b), r, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    got_t = tb.decay_scan(torch.as_tensor(b.T.copy()), r, 0).numpy()
    np.testing.assert_allclose(got_t, got.T, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_out", [1, 777, 1024])
def test_fir_ext_one_shot_matches_numpy(n_out):
    """The one-shot core at any n_out (odd lengths included), real and
    complex taps, against numpy's float64 convolution."""
    rng = np.random.RandomState(n_out)
    x = (rng.randn(n_out) + 1j * rng.randn(n_out)).astype(np.complex64)
    for taps in (LP97, CBP41, RAND16):
        K = len(taps)
        ext = np.concatenate([np.zeros(K - 1, np.complex64), x])
        got = tb.fir_ext(torch.as_tensor(ext), taps, n_out).numpy()
        want = np.convolve(x, taps)[:n_out]
        # the scale of a FIR's float32 rounding: max|x| * sum|taps|
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=2e-6 * np.abs(x).max() * np.abs(taps).sum())
    xr = rng.randn(n_out).astype(np.float32)
    ext = np.concatenate([np.zeros(20, np.float32), xr])
    got = tb.fir_ext(torch.as_tensor(ext), LP21, n_out)
    assert not got.is_complex()
    np.testing.assert_allclose(got.numpy(), np.convolve(xr, LP21)[:n_out],
                               rtol=0, atol=2e-5)
