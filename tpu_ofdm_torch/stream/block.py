"""Streaming block contract and the utility blocks (counterpart of
tpu_ofdm/stream/block.py).

A Block is a pair of functions:

    init(device)      -> state            (history buffers, counters)
    apply(state, x)   -> (state, y)       (one time-block of samples)

State lives on the device given to `init`; `apply` runs eagerly on the
tensors' device and returns the new state rather than mutating the old.
Constants (FIR tap spectra) are built once per device, never copied from
the host inside `apply`.  `stateless` and `chain` compose Blocks; the
utility blocks are the JAX module's, with its names, arguments and output
alignment.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from tpu_ofdm_torch.ops.sync import moving_sum


@dataclasses.dataclass(frozen=True)
class Block:
    """A streaming processor.

    `latency`: samples of pipeline delay before an input sample's effect is
    fully emitted (e.g. the RX history carry).  The executor flushes this
    many zero samples at end of stream so trailing outputs are not lost."""

    init: Callable[[Any], Any]
    apply: Callable[[Any, Any], tuple[Any, Any]]
    name: str = "block"
    latency: int = 0
    # False for blocks whose input is not one block of samples (the
    # streaming TX takes PDU slot batches); the executor then skips its
    # block-size and device checks.
    stream_input: bool = True

    def __call__(self, state, x):
        return self.apply(state, x)


def stateless(fn: Callable[[Any], Any], name: str = "fn") -> Block:
    """Lift a pure function of one time-block into a Block with no
    state."""
    return Block(init=lambda device: (), apply=lambda s, x: (s, fn(x)),
                 name=name)


def chain(*blocks: Block, name: str = "chain") -> Block:
    """Sequential composition: y flows through the blocks in order; their
    states are carried as a tuple."""

    def init(device):
        return tuple(b.init(device) for b in blocks)

    def apply(states, x):
        new_states = []
        for b, s in zip(blocks, states):
            s, x = b.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x

    return Block(init=init, apply=apply, name=name)


# ---------------------------------------------------------------------------
# Utility blocks (the JAX module's, tpu_ofdm/stream/block.py:83-350)
# ---------------------------------------------------------------------------


def multiply_const(k, name: str = "multiply_const") -> Block:
    return stateless(lambda x: x * k, name)


def add_const(k, name: str = "add_const") -> Block:
    return stateless(lambda x: x + k, name)


def complex_to_mag_squared() -> Block:
    return stateless(lambda x: x.abs() ** 2, "complex_to_mag_squared")


def nlog10(n: float = 10.0, k: float = 0.0, floor: float = 1e-20) -> Block:
    """n*log10(x) + k, with a floor to avoid -inf."""
    return stateless(lambda x: n * torch.log10(x.clamp(min=floor)) + k,
                     "nlog10")


def stream_to_vector(vlen: int) -> Block:
    """(..., n) -> (..., n//vlen, vlen); block size must divide by vlen."""
    return stateless(
        lambda x: x.reshape(*x.shape[:-1], x.shape[-1] // vlen, vlen),
        "stream_to_vector")


def vector_to_stream() -> Block:
    return stateless(
        lambda x: x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]),
        "vector_to_stream")


def _history(n: int, dtype: torch.dtype):
    """init of a block whose carry is the last n inputs (zeros at start)."""
    return lambda device: torch.zeros(n, dtype=dtype, device=device)


def _tail(ext: torch.Tensor, n: int) -> torch.Tensor:
    """The last n samples of ext along the last axis (none for n = 0)."""
    return ext[..., ext.shape[-1] - n:]


def delay(n: int, dtype: torch.dtype = torch.complex64) -> Block:
    """Delay by n samples: carries the last n inputs."""

    def apply(state, x):
        ext = torch.cat([state, x], dim=-1)
        return _tail(ext, n), ext[..., : x.shape[-1]]

    return Block(_history(n, dtype), apply, f"delay({n})")


def moving_average(n: int, dtype: torch.dtype = torch.float32,
                   scale: float | None = None) -> Block:
    """Moving sum/average over the trailing n samples: y[i] = scale *
    sum_{k<n} x[i-k].  Carries the last n-1 inputs.  The window sums are
    differences of one prefix sum (ops.sync.moving_sum: the scan kernel on
    CUDA, one launch per push; complex input as its real and imaginary
    parts)."""
    scale = 1.0 if scale is None else scale

    def apply(state, x):
        ext = torch.cat([state, x], dim=-1)
        return _tail(ext, n - 1), moving_sum(ext, n) * scale

    return Block(_history(n - 1, dtype), apply, f"moving_average({n})")


def decay_scan(b: torch.Tensor, r: float, dim: int) -> torch.Tensor:
    """z[i] = sum_{j<=i} r^(i-j) b[j] along `dim`, in log depth: a
    Hillis-Steele scan over the affine maps y -> r*y + b[i], ~log2(n)
    shifted multiply-adds (the JAX package's associative_scan).  r^d is
    squared in float32."""
    n = b.shape[dim]
    d, rd = 1, np.float32(r)
    while d < n:
        # z[i] covers (i - 2d, i]: add the span that ends at i - d
        b = torch.cat([b.narrow(dim, 0, d),
                       b.narrow(dim, d, n - d)
                       + float(rd) * b.narrow(dim, 0, n - d)], dim=dim)
        d, rd = 2 * d, rd * rd
    return b


def decay_powers(r: float, n: int, device) -> torch.Tensor:
    """(n,) float32 r^(i+1), i < n: the weight of the state before a scan
    of decay_scan."""
    return torch.full((n,), float(np.float32(r)), device=device).cumprod(0)


def single_pole_iir(alpha: float, dtype: torch.dtype = torch.float32) -> Block:
    """y[i] = alpha*x[i] + (1-alpha)*y[i-1], evaluated for a whole block at
    once by decay_scan."""
    r = 1.0 - alpha

    def init(device):
        return torch.zeros((), dtype=dtype, device=device)

    def apply(y0, x):
        z = decay_scan((alpha * x).to(dtype), r, -1)
        y = decay_powers(r, x.shape[-1], x.device) * y0 + z
        return y[..., -1], y

    return Block(init, apply, f"single_pole_iir({alpha})")


class FirTaps:
    """FIR taps, one row per filter (P, K), and their DFTs at each (device,
    transform length), built once each on the host in float64 and cast
    (the JAX package's taps are float32 or complex64 on the device)."""

    def __init__(self, taps):
        t = np.atleast_2d(np.asarray(taps))
        self.real = not np.iscomplexobj(t)
        self.taps = t.astype(np.float32 if self.real else np.complex64)
        self.spectrum = functools.lru_cache(maxsize=None)(self._spectrum)

    def _spectrum(self, device: torch.device, nfft: int,
                  real: bool) -> torch.Tensor:
        h = self.taps.astype(np.float64 if self.real else np.complex128)
        f = np.fft.rfft(h, nfft) if real else np.fft.fft(h, nfft)
        return torch.as_tensor(f.astype(np.complex64), device=device)


def _fir(ext: torch.Tensor, t: FirTaps, n_out: int) -> torch.Tensor:
    """fir_ext of the P filters of `t` at once: (..., P, n_out), as one
    FFT convolution of the whole of ext, zero-padded to the next power of
    two (a power-of-two block plus its history takes twice the block)."""
    K = t.taps.shape[-1]
    n = ext.shape[-1]
    nfft = 1 << max(0, (n - 1).bit_length())
    real = t.real and not ext.is_complex()
    spec = t.spectrum(ext.device, nfft, real)               # (P, nfft')
    if real:
        y = torch.fft.irfft(torch.fft.rfft(ext, nfft)[..., None, :] * spec,
                            nfft)
    else:
        y = torch.fft.ifft(torch.fft.fft(ext.to(torch.complex64), nfft)
                           [..., None, :] * spec)
    return y[..., K - 1: K - 1 + n_out]


def fir_ext(ext: torch.Tensor, taps, n_out: int) -> torch.Tensor:
    """Causal FIR over a history-extended stream: ext (..., n_out + K - 1)
    whose first K-1 samples are history, y[m] = sum_k taps[k] *
    ext[K - 1 - k + m].

    One FFT of ext, a product with the taps' DFT and the inverse: a
    circular convolution of length nfft >= len(ext) wraps only into outputs
    before K-1, which are dropped.  The JAX package chose between shifted
    multiply-adds and a Toeplitz matmul because lax.conv did not lower on
    its TPU; torch.fft runs on every device, where a cuDNN conv1d would
    compute in TF32 on the card unless a global flag were changed."""
    return _fir(ext, FirTaps(np.asarray(taps).ravel()), n_out)[..., 0, :]


def fir_filter(taps, decim: int = 1,
               dtype: torch.dtype = torch.complex64) -> Block:
    """Causal FIR y[n] = sum_k taps[k] x[n-k], optionally decimating.
    Streaming via overlap-save: carries the last len(taps)-1 input samples.
    Block length must be a multiple of `decim`; output is len(x)//decim with
    output m tapping x at n = m*decim (phase 0)."""
    t = FirTaps(np.asarray(taps).ravel())
    nt = t.taps.shape[-1]

    def apply(state, x):
        ext = torch.cat([state, x.to(dtype)], dim=-1)
        y = _fir(ext, t, x.shape[-1])[..., 0, :]
        if decim > 1:
            y = y[..., ::decim]
        return _tail(ext, nt - 1), y

    return Block(_history(nt - 1, dtype), apply, f"fir({nt},decim={decim})")


def freq_xlating_fir(taps, center_freq_rel: float, decim: int = 1) -> Block:
    """Frequency-translating FIR: mix the band at `center_freq_rel`
    (fraction of fs) down to DC, lowpass, decimate.  Carries the mixer
    phase across blocks.  The phase is the JAX package's float32 ramp,
    ph0 + float32(-2 pi f) * (i + 1), whose rounding grows with the block
    length (ROADMAP, "Known, and not port faults")."""
    base = fir_filter(taps, decim=decim)
    w = float(np.float32(2.0 * np.pi * (-center_freq_rel)))

    def init(device):
        return (torch.zeros((), dtype=torch.float32, device=device),
                base.init(device))

    def apply(state, x):
        ph0, fs = state
        i = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
        ph = ph0 + w * (i + 1.0)
        mixed = x * torch.polar(torch.ones_like(ph), ph)
        fs, y = base.apply(fs, mixed.to(torch.complex64))
        return (torch.remainder(ph[-1], 2.0 * np.pi), fs), y

    return Block(init, apply, f"freq_xlating_fir({len(np.ravel(taps))})")


def interpolating_fir(taps, interp: int,
                      dtype: torch.dtype = torch.complex64) -> Block:
    """Interpolating FIR by polyphase decomposition: y[m*L + p] = sum_k
    taps[k*L + p] * x[m - k], the L phase filters run as one fir_ext and
    their outputs interleaved to a len(x)*L stream.  Carries ceil(nt/L)-1
    input samples (overlap-save)."""
    taps = np.asarray(taps).ravel()
    L = int(interp)
    nt = len(taps)
    k = -(-nt // L)  # taps per phase arm
    poly = np.zeros((k, L), dtype=taps.dtype)
    poly.ravel()[:nt] = taps  # poly[k, p] = taps[k*L + p]
    t = FirTaps(poly.T)

    def apply(state, x):
        n = x.shape[-1]
        ext = torch.cat([state, x.to(dtype)], dim=-1)
        y = _fir(ext, t, n).transpose(-1, -2)               # (..., n, L)
        return _tail(ext, k - 1), y.reshape(*x.shape[:-1], n * L)

    return Block(_history(k - 1, dtype), apply, f"interp_fir({nt},L={L})")


def rational_resampler(taps, interp: int, decim: int) -> Block:
    """Rate change by interp/decim: polyphase interpolation followed by
    decimation; block length must be a multiple of `decim` after
    interpolation."""
    up = interpolating_fir(taps, interp)

    def apply(state, x):
        state, y = up.apply(state, x)
        return state, y[..., ::decim]

    return Block(up.init, apply, f"resampler({interp}/{decim})")


def _counter(device):
    return torch.zeros((), dtype=torch.int64, device=device)


def head(n: int) -> Block:
    """Pass samples through until n total, then zero + mask (static-shape
    blocks.head: returns (y, mask))."""

    def apply(count, x):
        m = x.shape[-1]
        mask = count + torch.arange(m, device=x.device) < n
        return count + m, (torch.where(mask, x, 0), mask)

    return Block(_counter, apply, f"head({n})")


def probe_rate() -> Block:
    """Counts samples seen; the host divides by wall time to get
    samples/s.  State IS the metric."""
    return Block(_counter, lambda count, x: (count + x.shape[-1], x),
                 "probe_rate")
