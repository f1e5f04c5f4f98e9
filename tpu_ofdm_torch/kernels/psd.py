"""Windowed PSD frames: CUDA kernel (csrc/psd.cu) and its plain version.

Counterpart of tpu_ofdm/kernels/psd.py (`psd_fused`, built by
`_build_call`): x (n,) complex64 -> (n // N, N) float32 linear-power
frames, |DFT(frame * w)|^2 with w = window / sqrt(sum(window^2) * N) folded
on the host in float64 (the reference's normalization), bins in natural
order.  A ragged tail shorter than a frame is dropped.  CUDA tensors launch
the kernel; CPU tensors take `psd_fused_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.kernels.build import check_vector, complex_ptr, library

LANE = 128


def supported(fft_len: int) -> bool:
    """The JAX package's fused coverage, N = n1 * 128 with n1 <= 8; other
    lengths take spectrum.psd's plain chain, as they take the XLA chain
    there."""
    return fft_len % LANE == 0 and 1 <= fft_len // LANE <= 8


@functools.lru_cache(maxsize=64)
def folded_window(fft_len: int, window: str,
                  device: torch.device) -> torch.Tensor:
    """(fft_len,) float32 window with 1/sqrt(sum(w^2) * fft_len) folded in,
    on `device` (cached: the step never copies from the host)."""
    from tpu_ofdm_torch.spectrum import window as win

    wv = win.get(window, fft_len).astype(np.float64)
    w = wv / np.sqrt(np.sum(wv ** 2) * fft_len)
    return torch.as_tensor(w.astype(np.float32), device=device)


def psd_fused_plain(x: torch.Tensor, fft_len: int,
                    window: str = "hann") -> torch.Tensor:
    """Plain PyTorch version of `psd_fused` (same arguments); also takes
    (..., n) -> (..., n // fft_len, fft_len) and any fft_len, as
    spectrum.psd's plain chain."""
    nf = x.shape[-1] // fft_len
    frames = x[..., : nf * fft_len].reshape(*x.shape[:-1], nf, fft_len)
    y = torch.fft.fft(frames * folded_window(fft_len, window, x.device))
    return y.real ** 2 + y.imag ** 2


def psd_fused(x: torch.Tensor, fft_len: int,
              window: str = "hann") -> torch.Tensor:
    """(n // fft_len, fft_len) float32 PSD frames of x (n,) complex64."""
    check_vector(x, "x", torch.complex64)
    if not supported(fft_len):
        raise ValueError(f"psd_fused: fft_len {fft_len} not supported")
    if x.device.type == "cpu":
        return psd_fused_plain(x, fft_len, window)
    if x.device.type != "cuda":
        raise ValueError(f"psd_fused: unsupported device {x.device}")
    nf = x.shape[0] // fft_len
    w = folded_window(fft_len, window, x.device)
    out = torch.empty((nf, fft_len), dtype=torch.float32, device=x.device)
    library().launch(
        "psd_launch", x.device, complex_ptr(x), nf, w.data_ptr(), fft_len,
        out.data_ptr(),
    )
    psd_fused.launches += 1
    return out


psd_fused.launches = 0  # kernel launches since the last reset
