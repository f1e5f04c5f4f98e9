"""PSD probe chain: window -> FFT -> |.|^2 / norm -> 10 log10 -> single-pole
IIR averaging (counterpart of tpu_ofdm/spectrum/psd.py).

Normalization matches the golden model (tests/golden/golden_ofdm.log_pwr_fft):
power divided by sum(w^2) * fft_len, folded into the window.  On the card
every input, 1-D or batched (..., n), runs the psd kernel (kernels/psd.py)
at the lengths it covers and raises at any other; on the CPU the plain
chain runs, where the JAX package takes its XLA chain.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ofdm_torch.kernels import psd as kpsd
from tpu_ofdm_torch.stream.block import Block


def psd_route(device_type: str, fft_len: int) -> str:
    """How psd_frames computes frames of fft_len on a device of this type:
    "plain" (the CPU), "kernel" (a length the psd kernel covers) or
    "raise"."""
    if device_type == "cpu":
        return "plain"
    return "kernel" if kpsd.supported(fft_len) else "raise"


def psd_frames(x: torch.Tensor, fft_len: int,
               window: str = "hann") -> torch.Tensor:
    """(..., n) samples -> (..., n//fft_len, fft_len) linear-power PSD
    frames; each row's ragged tail is dropped."""
    route = psd_route(x.device.type, fft_len)
    if route == "raise":
        raise ValueError(f"psd_frames: fft_len {fft_len} on {x.device}; the "
                         f"psd kernel covers {kpsd.COVERED}")
    if route == "plain":
        return kpsd.psd_fused_plain(x, fft_len, window)
    return kpsd.psd_fused(x.to(torch.complex64), fft_len, window)


def iir_average(pwr: torch.Tensor, alpha: float,
                y0: torch.Tensor | None = None):
    """Single-pole IIR across the frame axis (axis -2):
    y[i] = alpha*p[i] + (1-alpha)*y[i-1], y[-1] = y0 (default p[0], the
    golden model's warm start).  A log-depth scan (Hillis-Steele over the
    affine maps y -> r*y + alpha*p[i], r = 1 - alpha): ~log2(n) shifted
    multiply-adds, as the reference's associative_scan.  Returns
    (averaged_frames, last_frame)."""
    if alpha >= 1.0:
        return pwr, pwr[..., -1, :]
    if y0 is None:
        y0 = pwr[..., 0, :]
    r = np.float32(1.0 - alpha)
    n = pwr.shape[-2]
    b = alpha * pwr
    d, rd = 1, r                                  # rd = r ** d, float32
    while d < n:
        # b[i] covers frames (i - 2d, i]: add the span ending at i - d
        b = torch.cat([b[..., :d, :],
                       b[..., d:, :] + float(rd) * b[..., :-d, :]], dim=-2)
        d, rd = 2 * d, rd * rd
    mm = torch.full((n,), float(r), device=pwr.device).cumprod(0)
    y = mm[:, None] * y0[..., None, :] + b
    return y, y[..., -1, :]


def log_pwr_fft(
    x: torch.Tensor,
    fft_len: int,
    avg_alpha: float = 1.0,
    window: str = "hann",
    floor: float = 1e-20,
) -> torch.Tensor:
    """One-shot PSD in dB over a sample buffer; golden-model compatible."""
    pwr = psd_frames(x, fft_len, window)
    avg, _ = iir_average(pwr, avg_alpha)
    return 10.0 * torch.log10(avg.clamp(min=floor))


def log_pwr_fft_block(
    fft_len: int,
    avg_alpha: float = 1.0,
    window: str = "hann",
    floor: float = 1e-20,
) -> Block:
    """Streaming logpwrfft: carries the IIR state across time-blocks.
    Block size must be a multiple of fft_len.  Emits (n_frames, fft_len) dB
    frames per step."""

    def init(device):
        # IIR state: (warmed-up flag as float, last averaged frame)
        return (torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros(fft_len, dtype=torch.float32, device=device))

    def apply(state, x):
        warm, y_last = state
        pwr = psd_frames(x, fft_len, window)
        # warm start: the first frame ever seeds the IIR (golden semantics)
        y0 = torch.where(warm > 0, y_last, pwr[..., 0, :])
        avg, y_new = iir_average(pwr, avg_alpha, y0=y0)
        out = 10.0 * torch.log10(avg.clamp(min=floor))
        return (torch.ones_like(warm), y_new), out

    return Block(init, apply)
