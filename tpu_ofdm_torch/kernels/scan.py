"""Prefix and sliding sums: CUDA kernel (csrc/scan.cu) and its plain
version.

Counterpart of tpu_ofdm/kernels/scan.py.  `cumsum(x, axis)` takes float32
(..., n) at any n and any batch and returns its float32 prefix sum along
`axis`; CUDA tensors launch the kernel, along any axis (another axis is
moved last, scanned and moved back), and CPU tensors take `cumsum_plain`.
There is no minimum size and no tile padding.

The kernel keeps every partial sum in float64 and rounds once, so out[t]
is within ~eps * |cs[t]| of the exact prefix at any t.  A window sum taken
as a difference of two such prefixes (moving_sums) still carries their
rounding, ~eps * n / w of the window's value at length n and width w, as
the JAX docstring says.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import (ANY_RANK, KernelLibrary,
                                          check_vector, library)

TILE = 8192  # samples per CTA: kTile of csrc/scan.cu (the launch checks it)


def scratch_len(rows: int, n: int) -> int:
    """float64 entries of scan_launch's scratch for `rows` rows of n: a
    16-byte descriptor per tile, then the int32 tile counter."""
    return 2 * rows * -(-n // TILE) + 1


def cumsum_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Plain version: accumulate in float64, return float32."""
    return torch.cumsum(x.to(torch.float64), dim=axis).to(torch.float32)


def cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """float32 prefix sum along `axis`."""
    check_vector(x, "x", torch.float32, ndims=ANY_RANK)
    if not -x.ndim <= axis < x.ndim:
        raise IndexError(f"cumsum: axis {axis} out of range for shape "
                         f"{tuple(x.shape)}")
    axis %= x.ndim
    if x.device.type == "cpu":
        return cumsum_plain(x, axis)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum: unsupported device {x.device}")
    if axis != x.ndim - 1:
        last = cumsum(x.movedim(axis, -1).contiguous())
        return last.movedim(-1, axis).contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch(library(), x, out)
    cumsum.launches += 1
    return out


cumsum.launches = 0  # kernel launches since the last reset


def launch(lib: KernelLibrary, x: torch.Tensor, out: torch.Tensor,
           scratch: torch.Tensor | None = None) -> None:
    """scan_launch of `lib` on a checked, non-empty CUDA tensor: out = the
    prefix sum of x along its last axis.  `scratch` (float64, at least
    scratch_len entries) is allocated here when not given (kernel_ab.py
    gives one large enough for the other builds it times)."""
    n = x.shape[-1]
    B = x.numel() // n
    if scratch is None:
        scratch = torch.empty(scratch_len(B, n), dtype=torch.float64,
                              device=x.device)
    lib.launch("scan_launch", x.device, x.data_ptr(), n, B,
               scratch.data_ptr(), scratch.numel(), out.data_ptr())


def moving_sums(arrs: list[torch.Tensor], w: int) -> list[torch.Tensor]:
    """Valid-mode sliding sums of width w over the last axis of several
    same-shape arrays in one cumsum: out[d] = sum x[d:d+w], length n-w+1."""
    cs = cumsum(torch.stack([a.to(torch.float32) for a in arrs]))
    lag = torch.cat([torch.zeros_like(cs[..., :1]),
                     cs[..., : cs.shape[-1] - w]], dim=-1)
    out = cs[..., w - 1:] - lag
    return list(out.unbind(0))
