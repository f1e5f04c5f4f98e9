"""PSD probe chain: window -> FFT -> |.|^2 / norm -> 10 log10 -> single-pole
IIR averaging (counterpart of tpu_ofdm/spectrum/psd.py).

Normalization matches the golden model (tests/golden/golden_ofdm.log_pwr_fft):
power divided by sum(w^2) * fft_len.  On the card every input, 1-D or
batched (..., n), runs the psd kernel (kernels/psd.py) at the lengths it
covers -- every length the JAX package runs in its Pallas kernel, and 16,
32 and 64 -- and the JAX package's XLA chain in torch ops (window,
torch.fft.fft, |.|^2 / norm) at any other; on the CPU the kernel's plain
version runs.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels import psd as kpsd
from tpu_ofdm_torch.stream.block import Block, decay_powers, decay_scan


def psd_route(device_type: str, fft_len: int) -> str:
    """How psd_frames computes frames of fft_len on a device of this type,
    from the length alone: "plain" (the CPU), "kernel" (a length the psd
    kernel covers) or "torch" (the XLA chain's torch ops, where the JAX
    package takes that chain too)."""
    if device_type == "cpu":
        return "plain"
    return "kernel" if kpsd.supported(fft_len) else "torch"


def psd_frames(x: torch.Tensor, fft_len: int,
               window: str = "hann") -> torch.Tensor:
    """(..., n) samples -> (..., n//fft_len, fft_len) linear-power PSD
    frames; each row's ragged tail is dropped."""
    route = psd_route(x.device.type, fft_len)
    if route == "plain":
        return kpsd.psd_fused_plain(x, fft_len, window)
    if route == "kernel":
        return kpsd.psd_fused(x.to(torch.complex64), fft_len, window)
    n = x.shape[-1] // fft_len
    frames = x[..., : n * fft_len].reshape(*x.shape[:-1], n, fft_len)
    w, norm = kpsd.device_window(fft_len, window, x.device)
    return torch.fft.fft(frames * w).abs() ** 2 / norm


def iir_average(pwr: torch.Tensor, alpha: float,
                y0: torch.Tensor | None = None):
    """Single-pole IIR across the frame axis (axis -2):
    y[i] = alpha*p[i] + (1-alpha)*y[i-1], y[-1] = y0 (default p[0], the
    golden model's warm start), by decay_scan.  Returns (averaged_frames,
    last_frame)."""
    if alpha >= 1.0:
        return pwr, pwr[..., -1, :]
    if y0 is None:
        y0 = pwr[..., 0, :]
    b = decay_scan(alpha * pwr, 1.0 - alpha, -2)
    mm = decay_powers(1.0 - alpha, pwr.shape[-2], pwr.device)
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

    return Block(init, apply, f"logpwrfft({fft_len})")
