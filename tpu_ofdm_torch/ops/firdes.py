"""Window-method FIR designer (counterpart of tpu_ofdm/ops/firdes.py, which
follows gr-filter's firdes).

Pure numpy: filter taps are designed once on the host at construction,
like the reference's.  A copy, not an import: the JAX module's package
imports jax.  The designers follow the textbook window method -- ideal
brick-wall impulse response, truncated to `ntaps` and shaped by a window
whose stopband attenuation sets the tap count from the requested
transition width:

    ntaps = attenuation_db / (22 * transition_width / fs)   (odd)

All gains are normalized at the band's reference frequency (DC for lowpass,
Nyquist for highpass, band center for bandpass) so the passband gain equals
`gain` exactly.  The formulas and casts are the JAX module's, so the taps
are bit-identical.
"""

from __future__ import annotations

import numpy as np

from tpu_ofdm_torch.spectrum import window as win

# Empirical max stopband attenuation of each window (dB), used to size the
# filter for a requested transition width (same constants class of numbers
# as the reference's window::max_attenuation).
_ATTEN_DB = {
    "rect": 21.0,
    "rectangular": 21.0,
    "hann": 44.0,
    "hanning": 44.0,
    "hamming": 53.0,
    "blackman": 74.0,
    "blackman_harris": 92.0,
    "blackmanharris": 92.0,
    "kaiser": None,  # beta-dependent, see _attenuation
}


def _attenuation(window: str, beta: float) -> float:
    a = _ATTEN_DB.get(window, 53.0)
    if a is None:  # kaiser: invert beta(att) = 0.1102*(att-8.7)
        return beta / 0.1102 + 8.7
    return a


def _get_window(window: str, n: int, beta: float) -> np.ndarray:
    if window == "kaiser":
        return win.kaiser(n, beta)
    return win.get(window, n)


def compute_ntaps(fs: float, transition_width: float,
                  window: str = "hamming", beta: float = 6.76) -> int:
    """Tap count for a given transition width; always odd."""
    if transition_width <= 0:
        raise ValueError("transition_width must be > 0")
    att = _attenuation(window, beta)
    n = int(att / (22.0 * transition_width / fs))
    return n + 1 if n % 2 == 0 else n


def _sinc_lowpass(cutoff: float, fs: float, ntaps: int) -> np.ndarray:
    """Ideal lowpass impulse response, symmetric about the middle tap."""
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    wc = 2.0 * np.pi * cutoff / fs
    h = np.where(n == 0, wc / np.pi, np.sin(wc * n) / (np.pi * np.where(n == 0, 1, n)))
    return h


def low_pass(gain: float, fs: float, cutoff: float,
             transition_width: float, window: str = "hamming",
             beta: float = 6.76, ntaps: int | None = None) -> np.ndarray:
    """Lowpass FIR, unity (=gain) at DC (cf. firdes::low_pass)."""
    if not 0 < cutoff < fs / 2:
        raise ValueError("cutoff must be in (0, fs/2)")
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition_width, window, beta)
    h = _sinc_lowpass(cutoff, fs, ntaps) * _get_window(window, ntaps, beta)
    return (gain * h / h.sum()).astype(np.float32)


def high_pass(gain: float, fs: float, cutoff: float,
              transition_width: float, window: str = "hamming",
              beta: float = 6.76, ntaps: int | None = None) -> np.ndarray:
    """Highpass FIR, unity (=gain) at Nyquist (cf. firdes::high_pass).
    Spectral inversion of the complementary lowpass; ntaps forced odd."""
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition_width, window, beta)
    if ntaps % 2 == 0:
        ntaps += 1
    h = -_sinc_lowpass(cutoff, fs, ntaps) * _get_window(window, ntaps, beta)
    m = (ntaps - 1) // 2
    h[m] += 1.0
    # normalize at Nyquist: H(pi) = sum h[n] * (-1)^n
    nyq = np.sum(h * np.where((np.arange(ntaps) - m) % 2 == 0, 1.0, -1.0))
    return (gain * h / nyq).astype(np.float32)


def band_pass(gain: float, fs: float, low_cutoff: float, high_cutoff: float,
              transition_width: float, window: str = "hamming",
              beta: float = 6.76, ntaps: int | None = None) -> np.ndarray:
    """Real bandpass FIR, unity (=gain) at band center
    (cf. firdes::band_pass): lowpass of half the bandwidth heterodyned to
    the band center with a cosine."""
    if not 0 < low_cutoff < high_cutoff < fs / 2:
        raise ValueError("need 0 < low < high < fs/2")
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition_width, window, beta)
    half_bw = (high_cutoff - low_cutoff) / 2.0
    center = (high_cutoff + low_cutoff) / 2.0
    proto = _sinc_lowpass(half_bw, fs, ntaps) * _get_window(window, ntaps, beta)
    m = (ntaps - 1) // 2
    n = np.arange(ntaps) - m
    h = proto * 2.0 * np.cos(2.0 * np.pi * center * n / fs)
    # normalize at the center frequency
    hc = np.abs(np.sum(h * np.exp(-2j * np.pi * center * n / fs)))
    return (gain * h / hc).astype(np.float32)


def complex_band_pass(gain: float, fs: float, low_cutoff: float,
                      high_cutoff: float, transition_width: float,
                      window: str = "hamming", beta: float = 6.76,
                      ntaps: int | None = None) -> np.ndarray:
    """One-sided (complex-tap) bandpass (cf. firdes::complex_band_pass):
    lowpass heterodyned by exp(j*2*pi*center*n/fs); cutoffs may be
    negative (band anywhere in (-fs/2, fs/2))."""
    if not -fs / 2 < low_cutoff < high_cutoff < fs / 2:
        raise ValueError("need -fs/2 < low < high < fs/2")
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition_width, window, beta)
    half_bw = (high_cutoff - low_cutoff) / 2.0
    center = (high_cutoff + low_cutoff) / 2.0
    lp = low_pass(gain, fs, half_bw, transition_width, window, beta, ntaps)
    m = (len(lp) - 1) // 2
    n = np.arange(len(lp)) - m
    return (lp * np.exp(2j * np.pi * center * n / fs)).astype(np.complex64)


def band_reject(gain: float, fs: float, low_cutoff: float,
                high_cutoff: float, transition_width: float,
                window: str = "hamming", beta: float = 6.76,
                ntaps: int | None = None) -> np.ndarray:
    """Band-reject (notch) FIR, unity (=gain) at DC
    (cf. firdes::band_reject): delta minus the bandpass."""
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition_width, window, beta)
    if ntaps % 2 == 0:
        ntaps += 1
    bp = band_pass(1.0, fs, low_cutoff, high_cutoff, transition_width,
                   window, beta, ntaps).astype(np.float64)
    h = -bp
    h[(ntaps - 1) // 2] += 1.0
    return (gain * h / h.sum()).astype(np.float32)


def root_raised_cosine(gain: float, fs: float, symbol_rate: float,
                       alpha: float, ntaps: int) -> np.ndarray:
    """Root-raised-cosine pulse (cf. firdes::root_raised_cosine): the
    matched TX/RX pulse pair -- rrc convolved with itself is a Nyquist
    (ISI-free) raised cosine."""
    if not 0 < alpha <= 1:
        raise ValueError("alpha in (0, 1]")
    ntaps |= 1  # odd
    spb = fs / symbol_rate  # samples per symbol
    m = (ntaps - 1) // 2
    t = (np.arange(ntaps) - m) / spb  # time in symbols
    h = np.empty(ntaps, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(abs(4.0 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha))
            )
        else:
            num = (np.sin(np.pi * ti * (1.0 - alpha))
                   + 4.0 * alpha * ti * np.cos(np.pi * ti * (1.0 + alpha)))
            den = np.pi * ti * (1.0 - (4.0 * alpha * ti) ** 2)
            h[i] = num / den
    return (gain * h / np.sqrt(np.sum(h ** 2))).astype(np.float32)


def gaussian(gain: float, fs: float, symbol_rate: float, bt: float,
             ntaps: int) -> np.ndarray:
    """Gaussian pulse-shaping filter (cf. firdes::gaussian), BT = 3 dB
    bandwidth * symbol time."""
    ntaps |= 1
    spb = fs / symbol_rate
    m = (ntaps - 1) // 2
    t = (np.arange(ntaps) - m) / spb
    a = np.sqrt(np.log(2.0) / 2.0) / bt
    h = (np.sqrt(np.pi) / a) * np.exp(-((np.pi * t / a) ** 2))
    return (gain * h / h.sum()).astype(np.float32)


def freq_response(taps: np.ndarray, fs: float, n: int = 2048):
    """(freqs, |H| dB) of a designed filter -- host-side analysis helper."""
    w = np.fft.fftshift(np.fft.fftfreq(n, d=1.0 / fs))
    h = np.fft.fftshift(np.fft.fft(taps, n))
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-12))
    return w, mag
