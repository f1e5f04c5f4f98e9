"""Slot-window gather: CUDA kernel (csrc/gather.cu) and its plain version.

Counterpart of tpu_ofdm/kernels/gather.py (`gather_windows` and
`gather_windows_two`): out[k] = virtual[starts[k] : starts[k] + length] as
a (K, length) complex64 tensor, over the virtual buffer [head | x] (head
None or empty gives the one-source form).  Positions outside the virtual
buffer read as zero.  CUDA tensors launch the kernel; CPU tensors take
`gather_windows_plain`.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import check_vector, complex_ptr, library


def gather_windows_plain(x: torch.Tensor, starts: torch.Tensor, length: int,
                         head: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `gather_windows` (same arguments)."""
    v = x if head is None else torch.cat([head, x])
    nv = v.shape[0]
    pos = starts.to(torch.int64)[:, None] + torch.arange(length,
                                                         device=x.device)
    inside = (pos >= 0) & (pos < nv)
    return torch.where(inside, v[pos.clamp(0, max(nv - 1, 0))], 0)


def gather_windows(x: torch.Tensor, starts: torch.Tensor, length: int,
                   head: torch.Tensor | None = None) -> torch.Tensor:
    """(K, length) complex64 windows of [head | x] at int32 `starts`."""
    check_vector(x, "x", torch.complex64)
    check_vector(starts, "starts", torch.int32, x.device)
    if head is not None:
        check_vector(head, "head", torch.complex64, x.device)
    if x.device.type == "cpu":
        return gather_windows_plain(x, starts, length, head)
    if x.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {x.device}")
    h = 0 if head is None else head.shape[0]
    K = starts.shape[0]
    out = torch.empty((K, length), dtype=torch.complex64, device=x.device)
    library().launch(
        "gather_launch", x.device, complex_ptr(head), h, complex_ptr(x),
        x.shape[0], starts.data_ptr(), K, length, complex_ptr(out),
    )
    gather_windows.launches += 1
    return out


gather_windows.launches = 0  # kernel launches since the last reset
