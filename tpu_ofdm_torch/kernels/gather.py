"""Slot-window gather: CUDA kernel (csrc/gather.cu) and its plain version.

Counterpart of tpu_ofdm/kernels/gather.py (`gather_windows` and
`gather_windows_two`): out[k] = virtual[starts[k] : starts[k] + length] as
a (K, length) complex64 tensor, over the virtual buffer [head | x] (head
None or empty gives the one-source form).  Batched: x (B, n), head (B, h)
and starts (B, K) give (B, K, length), row b reading its own buffer (the
wideband receiver's channels).  Positions outside the virtual buffer read as
zero.  CUDA tensors launch the kernel; CPU tensors take
`gather_windows_plain`.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import (KernelLibrary, check_vector,
                                          complex_ptr, library)


def gather_windows_plain(x: torch.Tensor, starts: torch.Tensor, length: int,
                         head: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of `gather_windows` (same arguments)."""
    v = x if head is None else torch.cat([head, x], dim=-1)
    nv = v.shape[-1]
    pos = starts.to(torch.int64)[..., None] + torch.arange(length,
                                                           device=x.device)
    inside = (pos >= 0) & (pos < nv)
    flat = pos.clamp(0, max(nv - 1, 0)).reshape(*pos.shape[:-2], -1)
    got = v.gather(-1, flat).reshape(pos.shape)
    return torch.where(inside, got, 0)


def gather_windows(x: torch.Tensor, starts: torch.Tensor, length: int,
                   head: torch.Tensor | None = None) -> torch.Tensor:
    """(K, length) complex64 windows of [head | x] at int32 `starts` (K,);
    batched, (B, K, length) from x (B, n), head (B, h), starts (B, K)."""
    check_vector(x, "x", torch.complex64, ndims=(1, 2))
    check_vector(starts, "starts", torch.int32, x.device, ndims=(x.ndim,))
    if head is not None:
        check_vector(head, "head", torch.complex64, x.device, ndims=(x.ndim,))
    for name, t in (("starts", starts), ("head", head)):
        if t is not None and t.shape[:-1] != x.shape[:-1]:
            raise ValueError(f"{name} {tuple(t.shape)} and x "
                             f"{tuple(x.shape)} differ in batch")
    if x.device.type == "cpu":
        return gather_windows_plain(x, starts, length, head)
    if x.device.type != "cuda":
        raise ValueError(f"gather_windows: unsupported device {x.device}")
    out = torch.empty((*starts.shape, length), dtype=torch.complex64,
                      device=x.device)
    launch(library(), x, starts, head, out)
    gather_windows.launches += 1
    return out


gather_windows.launches = 0  # kernel launches since the last reset


def launch(lib: KernelLibrary, x: torch.Tensor, starts: torch.Tensor,
           head: torch.Tensor | None, out: torch.Tensor) -> None:
    """gather_launch of `lib` on checked CUDA tensors: out (..., K, F) from
    [head | x] at `starts` (gather_windows; kernel_ab.py times other
    builds through it)."""
    h = 0 if head is None else head.shape[-1]
    B = x.shape[0] if x.ndim == 2 else 1
    lib.launch("gather_launch", x.device, complex_ptr(head), h, h,
               complex_ptr(x), x.shape[-1], x.shape[-1], B,
               starts.data_ptr(), starts.shape[-1], out.shape[-1],
               complex_ptr(out))
