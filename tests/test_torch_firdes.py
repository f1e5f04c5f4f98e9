"""The port's FIR designer (tpu_ofdm_torch/ops/firdes.py, a numpy-only
copy) against the JAX package's: the taps of every designer, window and
tap-count rule must be equal bit for bit, dtype included."""

import numpy as np
import pytest

from tpu_ofdm.ops import firdes as jf
from tpu_ofdm_torch.ops import firdes as tf

WINDOWS = ["hamming", "hann", "blackman", "blackman_harris", "rect",
           "kaiser"]

DESIGNS = {
    "low_pass": lambda f, w: f.low_pass(2.0, 1000.0, 100.0, 20.0, window=w),
    "low_pass_ntaps": lambda f, w: f.low_pass(1.0, 8.0, 1.5, 0.75, w,
                                              ntaps=21),
    "high_pass": lambda f, w: f.high_pass(1.0, 1000.0, 200.0, 25.0, w),
    "high_pass_even": lambda f, w: f.high_pass(1.0, 1000.0, 200.0, 25.0, w,
                                               beta=4.0, ntaps=40),
    "band_pass": lambda f, w: f.band_pass(1.0, 1000.0, 150.0, 250.0, 20.0, w),
    "complex_band_pass": lambda f, w: f.complex_band_pass(
        1.0, 1000.0, -250.0, -150.0, 20.0, w),
    "band_reject": lambda f, w: f.band_reject(1.0, 1000.0, 150.0, 250.0,
                                              20.0, w),
}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_windowed_designs_bit_equal(design, window):
    got, want = DESIGNS[design](tf, window), DESIGNS[design](jf, window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("make", [
    lambda f: f.root_raised_cosine(1.0, 4.0, 1.0, 0.35, 81),
    lambda f: f.root_raised_cosine(2.0, 8.0, 1.0, 0.25, 64),   # 4 a ti = 1
    lambda f: f.gaussian(1.0, 8.0, 1.0, 0.35, 33),
    lambda f: f.freq_response(f.low_pass(1.0, 1.0, 0.2, 0.05), 1.0, 512)[1],
    lambda f: np.asarray([f.compute_ntaps(1000.0, tw, w)
                          for tw in (25.0, 50.0, 7.0) for w in WINDOWS]),
], ids=["rrc", "rrc_singular_points", "gaussian", "freq_response",
        "compute_ntaps"])
def test_pulse_shapes_and_helpers_bit_equal(make):
    got, want = make(tf), make(jf)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_design_errors_match():
    for f in (tf, jf):
        with pytest.raises(ValueError, match="cutoff"):
            f.low_pass(1.0, 1.0, 0.6, 0.1)
        with pytest.raises(ValueError, match="transition_width"):
            f.compute_ntaps(1.0, 0.0)
        with pytest.raises(ValueError, match="alpha"):
            f.root_raised_cosine(1.0, 4.0, 1.0, 0.0, 11)
