"""Prefix and sliding sums along the last axis: CUDA kernel (csrc/scan.cu)
and its plain version.

Counterpart of tpu_ofdm/kernels/scan.py.  `cumsum(x)` takes float32
(..., n) at any n and any batch and returns its float32 prefix sum along the
last axis; CUDA tensors launch the kernel, CPU tensors take `cumsum_plain`,
and any other axis goes to the plain version, as in the JAX package.  There
is no minimum size and no tile padding.

The kernel keeps every partial sum in float64 and rounds once, so out[t]
is within ~eps * |cs[t]| of the exact prefix at any t.  A window sum taken
as a difference of two such prefixes (moving_sums) still carries their
rounding, ~eps * n / w of the window's value at length n and width w, as
the JAX docstring says.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import ANY_RANK, check_vector, library

TILE = 4096  # samples per CTA: kTile of csrc/scan.cu (the launch checks it)


def cumsum_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Plain version: accumulate in float64, return float32."""
    return torch.cumsum(x.to(torch.float64), dim=axis).to(torch.float32)


def cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """float32 prefix sum along `axis` (the kernel for the last axis)."""
    if axis not in (-1, x.ndim - 1):
        return cumsum_plain(x, axis)
    check_vector(x, "x", torch.float32, ndims=ANY_RANK)
    if x.device.type == "cpu":
        return cumsum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum: unsupported device {x.device}")
    n = x.shape[-1]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    B = x.numel() // n
    scratch = torch.empty(B * -(-n // TILE), dtype=torch.float64,
                          device=x.device)
    library().launch("scan_launch", x.device, x.data_ptr(), n, B,
                     scratch.data_ptr(), scratch.numel(), out.data_ptr())
    cumsum.launches += 1
    return out


cumsum.launches = 0  # kernel launches since the last reset


def moving_sums(arrs: list[torch.Tensor], w: int) -> list[torch.Tensor]:
    """Valid-mode sliding sums of width w over the last axis of several
    same-shape arrays in one cumsum: out[d] = sum x[d:d+w], length n-w+1."""
    cs = cumsum(torch.stack([a.to(torch.float32) for a in arrs]))
    lag = torch.cat([torch.zeros_like(cs[..., :1]),
                     cs[..., : cs.shape[-1] - w]], dim=-1)
    out = cs[..., w - 1:] - lag
    return list(out.unbind(0))
