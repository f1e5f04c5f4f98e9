"""Full-length Schmidl-Cox sliding metric: CUDA kernel (csrc/sc_metric.cu)
and its plain version.

Counterpart of tpu_ofdm/kernels/sc_metric.py.  `sc_sliding_metric(r, L)`
takes complex64 r (..., n), n >= 2L, and returns, in valid-mode indexing
(element d is the window pair starting at d, length n - 2L + 1):

    P  complex64  sum_{q<L} conj(r[d+q]) r[d+q+L]
    R  float32    sum_{q<L} |r[d+q+L]|^2
    M  float32    |P|^2 / max(R, 1e-12)^2, uncapped, as the TPU kernel

CUDA tensors launch the kernel (any L); CPU tensors take
`sc_sliding_metric_plain`.  ops.sync.schmidl_cox caps and zeroes M
afterwards.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import (ANY_RANK, check_vector,
                                          complex_ptr, library)
from tpu_ofdm_torch.kernels.sc_detect import window_sums


def sc_sliding_metric_plain(r: torch.Tensor, L: int):
    """Plain version of `sc_sliding_metric`: window sums from float64
    prefix sums (sc_detect's plain version's)."""
    a = torch.view_as_real(r[..., :-L])
    b = torch.view_as_real(r[..., L:])
    ar, ai, br, bi = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    p_re = window_sums(ar * br + ai * bi, L)
    p_im = window_sums(ar * bi - ai * br, L)
    R = window_sums(br * br + bi * bi, L)
    M = (p_re * p_re + p_im * p_im) / R.clamp(min=1e-12) ** 2
    return torch.complex(p_re, p_im), R, M


def sc_sliding_metric(r: torch.Tensor, L: int):
    """(P, R, M) of complex64 r (..., n) at half-length L (see module)."""
    check_vector(r, "r", torch.complex64, ndims=ANY_RANK)
    n = r.shape[-1]
    if L < 1 or n < 2 * L:
        raise ValueError(f"sc_sliding_metric: need L >= 1 and n >= 2L, got "
                         f"L {L}, n {n}")
    if r.device.type == "cpu":
        return sc_sliding_metric_plain(r, L)
    if r.device.type != "cuda":
        raise ValueError(f"sc_sliding_metric: unsupported device {r.device}")
    shape = (*r.shape[:-1], n - 2 * L + 1)
    P = torch.empty(shape, dtype=torch.complex64, device=r.device)
    R = torch.empty(shape, dtype=torch.float32, device=r.device)
    M = torch.empty(shape, dtype=torch.float32, device=r.device)
    B = r.numel() // n
    library().launch("sc_metric_launch", r.device, complex_ptr(r), n, B, L,
                     complex_ptr(P), R.data_ptr(), M.data_ptr())
    sc_sliding_metric.launches += 1
    return P, R, M


sc_sliding_metric.launches = 0  # kernel launches since the last reset
