"""Windowed PSD frames: CUDA kernel (csrc/psd.cu) and its plain version.

Counterpart of tpu_ofdm/kernels/psd.py (`psd_fused`, built by
`_build_call`): x (..., n) complex64 -> (..., n // N, N) float32
linear-power frames, |DFT(frame * w)|^2 with w = window / sqrt(sum(window^2)
* N) folded on the host in float64 (the reference's normalization), bins in
natural order.  Each row's ragged tail shorter than a frame is dropped, as
the JAX chain drops it.  The kernel covers N = 16, 32, 64 and 128 n1 for
n1 = 1..8 (the TPU kernel's 128 n1, and the per-channel bins of the
wideband PSD); CUDA tensors launch it, CPU tensors take `psd_fused_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.kernels.build import complex_ptr, library

LANE = 128
COVERED = (16, 32, 64, *(LANE * n1 for n1 in range(1, 9)))


def supported(fft_len: int) -> bool:
    """The frame lengths the CUDA kernel covers (COVERED)."""
    return fft_len in COVERED


def window_norm(fft_len: int, window: str) -> tuple[np.ndarray, float]:
    """The window in float64 and the reference's norm sum(w^2) * fft_len:
    a PSD frame is |DFT(frame * w)|^2 / norm."""
    from tpu_ofdm_torch.spectrum import window as win

    wv = win.get(window, fft_len).astype(np.float64)
    return wv, float(np.sum(wv ** 2) * fft_len)


def _window(fft_len: int, window: str) -> np.ndarray:
    """The window with 1/sqrt(norm) folded in, in float64."""
    wv, norm = window_norm(fft_len, window)
    return wv / np.sqrt(norm)


def twiddles(fft_len: int) -> np.ndarray:
    """(N,) complex128 table of the kernel's cross twiddles: entry k1 NL + l
    is exp(-2 pi i ((l k1) mod N) / N), NL = min(N, 32), from the integer
    exponent."""
    nl = min(fft_len, 32)
    k1, lane = np.divmod(np.arange(fft_len), nl)
    e = (lane * k1) % fft_len
    return np.exp(-2j * np.pi * e / fft_len)


@functools.lru_cache(maxsize=64)
def device_consts(fft_len: int, window: str,
                  device: torch.device) -> torch.Tensor:
    """(3 N,) float32 on `device`: the folded window, then `twiddles` as
    interleaved (re, im), what csrc/psd.cu reads (cached: the step never
    copies from the host)."""
    tw = twiddles(fft_len)
    c = np.concatenate([_window(fft_len, window),
                        np.stack([tw.real, tw.imag], -1).ravel()])
    return torch.as_tensor(c.astype(np.float32), device=device)


def folded_window(fft_len: int, window: str,
                  device: torch.device) -> torch.Tensor:
    """(fft_len,) float32 window with 1/sqrt(norm) folded in, on `device`
    (the head of `device_consts`)."""
    return device_consts(fft_len, window, device)[:fft_len]


@functools.lru_cache(maxsize=64)
def device_window(fft_len: int, window: str, device: torch.device):
    """(the window (fft_len,) float32 on `device`, its norm): the operands
    of the JAX package's XLA chain, which divides by the norm after
    |.|^2 (cached)."""
    wv, norm = window_norm(fft_len, window)
    return torch.as_tensor(wv.astype(np.float32), device=device), norm


def psd_fused_plain(x: torch.Tensor, fft_len: int,
                    window: str = "hann") -> torch.Tensor:
    """Plain PyTorch version of `psd_fused` (same arguments); takes any
    fft_len, as spectrum.psd's plain chain."""
    nf = x.shape[-1] // fft_len
    frames = x[..., : nf * fft_len].reshape(*x.shape[:-1], nf, fft_len)
    y = torch.fft.fft(frames * folded_window(fft_len, window, x.device))
    return y.real ** 2 + y.imag ** 2


def psd_fused(x: torch.Tensor, fft_len: int,
              window: str = "hann") -> torch.Tensor:
    """(..., n // fft_len, fft_len) float32 PSD frames of x (..., n)
    complex64: one kernel launch for every row."""
    if not isinstance(x, torch.Tensor) or x.ndim < 1:
        raise TypeError("psd_fused: x must be a tensor of rank >= 1")
    if x.dtype != torch.complex64:
        raise TypeError(f"psd_fused: x must be complex64, got {x.dtype}")
    if not supported(fft_len):
        raise ValueError(f"psd_fused: fft_len {fft_len} not covered; the "
                         f"kernel takes {COVERED}")
    if x.device.type == "cpu":
        return psd_fused_plain(x, fft_len, window)
    if x.device.type != "cuda":
        raise ValueError(f"psd_fused: unsupported device {x.device}")
    n = x.shape[-1]
    nf = n // fft_len
    out = torch.empty((*x.shape[:-1], nf, fft_len), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    # rows of n samples at a common stride; a view where one exists
    rows = x.reshape(-1, n)
    if rows.stride(-1) != 1 or (rows.shape[0] > 1 and rows.stride(0) < n):
        rows = rows.contiguous()
    consts = device_consts(fft_len, window, x.device)
    library().launch(
        "psd_rows_launch", x.device, complex_ptr(rows), rows.shape[0],
        rows.stride(0), nf, consts.data_ptr(), fft_len, out.data_ptr(),
    )
    psd_fused.launches += 1
    return out


psd_fused.launches = 0  # kernel launches since the last reset
