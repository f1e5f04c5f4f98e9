"""Full-length Schmidl-Cox sliding metric: CUDA kernel (csrc/sc_metric.cu)
and its plain version, raw and with the energy gate of ops.sync.schmidl_cox.

Counterpart of tpu_ofdm/kernels/sc_metric.py.  `sc_sliding_metric(r, L)`
takes complex64 r (..., n), n >= 2L, and returns, in valid-mode indexing
(element d is the window pair starting at d, length n - 2L + 1):

    P  complex64  sum_{q<L} conj(r[d+q]) r[d+q+L]
    R  float32    sum_{q<L} |r[d+q+L]|^2
    M  float32    |P|^2 / max(R, 1e-12)^2, uncapped, as the TPU kernel

`sc_sync_metric(r, L, gate_w)` returns the same P and R and the M of
ops.sync.schmidl_cox (tpu_ofdm/ops/sync.py:148-168): capped at 2, zeroed
where R = 0, then zeroed where R <= 0.05 * coarse_sliding_max_same(R,
gate_w).  On CUDA one kernel computes all of it (the gate from each
128-output row's max of R over the rows around it); its plain version is
the raw plain version followed by that torch chain.

CUDA tensors launch the kernel (any L); CPU tensors take the plain
versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ofdm_torch.kernels.build import (ANY_RANK, check_vector,
                                          complex_ptr, library)
from tpu_ofdm_torch.kernels.sc_detect import window_sums

GATE_ROW = 128     # coarse_sliding_max_same's g: the kernel's row of outputs
MAX_HALO = 8       # csrc/sc_metric.cu kMaxHalo


def sliding_max(x: torch.Tensor, w: int) -> torch.Tensor:
    """Valid-mode sliding max along the last axis: out[i] = max x[i:i+w],
    length n - w + 1, by log-doubling (O(log w) shifted maxima)."""
    n = x.shape[-1]
    if w <= 1:
        return x
    y = x
    p = 1
    while p * 2 <= w:
        y = torch.maximum(y[..., :-p], y[..., p:])
        p *= 2
    # y[i] = max x[i:i+p]; two p-windows cover [i, i+w)
    if p < w:
        y = torch.maximum(y[..., : n - w + 1], y[..., w - p: w - p + n - w + 1])
    return y


def sliding_max_same(x: torch.Tensor, w: int, pad_left: int) -> torch.Tensor:
    """Same-length sliding max: out[i] = max x[i-pad_left : i-pad_left+w]
    (out-of-range treated as -inf)."""
    padded = F.pad(x, (pad_left, w - 1 - pad_left), value=float("-inf"))
    return sliding_max(padded, w)


def halo_rows(w: int, g: int = GATE_ROW) -> int:
    """k of coarse_sliding_max_same(., w, g): the rows of g on either side
    whose maxima a row's local max takes."""
    return -(-(w // 2 + g) // g)


def coarse_sliding_max_same(x: torch.Tensor, w: int,
                            g: int = GATE_ROW) -> torch.Tensor:
    """Block-granular same-length sliding max: out[i] is the max over a
    window that contains the centred w-window and spans at most w + 3g
    samples (maxima per g-block, the log-doubling ladder on the block
    array, broadcast back)."""
    n = x.shape[-1]
    nb = -(-n // g)
    xb = F.pad(x, (0, nb * g - n), value=float("-inf"))
    rowmax = xb.reshape(*x.shape[:-1], nb, g).amax(-1)
    k = halo_rows(w, g)
    wm = sliding_max_same(rowmax, 2 * k + 1, pad_left=k)
    full = wm[..., None].expand(*wm.shape, g)
    return full.reshape(*x.shape[:-1], nb * g)[..., :n]


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


def gate_metric(M: torch.Tensor, R: torch.Tensor,
                gate_w: int) -> torch.Tensor:
    """schmidl_cox's chain after the raw metric: M capped at 2 and zeroed
    where R = 0 (genuine M <= ~1; in exact silence R is 0 while |P|^2 may
    hold cancellation residue), then zeroed where R is not above 5% of the
    local energy."""
    M = torch.where(R > 0.0, M.clamp(max=2.0), 0.0)
    local = coarse_sliding_max_same(R, gate_w)
    return torch.where(R > 0.05 * local, M, 0.0)


def sc_sync_metric_plain(r: torch.Tensor, L: int, gate_w: int):
    """Plain version of `sc_sync_metric`."""
    P, R, M = sc_sliding_metric_plain(r, L)
    return P, R, gate_metric(M, R, gate_w)


def _check(what: str, r: torch.Tensor, L: int) -> None:
    check_vector(r, "r", torch.complex64, ndims=ANY_RANK)
    n = r.shape[-1]
    if L < 1 or n < 2 * L:
        raise ValueError(f"{what}: need L >= 1 and n >= 2L, got L {L}, "
                         f"n {n}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {r.device}")


def _launch(fn: str, r: torch.Tensor, L: int, *extra):
    n = r.shape[-1]
    shape = (*r.shape[:-1], n - 2 * L + 1)
    P = torch.empty(shape, dtype=torch.complex64, device=r.device)
    R = torch.empty(shape, dtype=torch.float32, device=r.device)
    M = torch.empty(shape, dtype=torch.float32, device=r.device)
    B = r.numel() // n
    library().launch(fn, r.device, complex_ptr(r), n, B, L, *extra,
                     complex_ptr(P), R.data_ptr(), M.data_ptr())
    return P, R, M


def sc_sliding_metric(r: torch.Tensor, L: int):
    """(P, R, M) of complex64 r (..., n) at half-length L (see module)."""
    _check("sc_sliding_metric", r, L)
    if r.device.type == "cpu":
        return sc_sliding_metric_plain(r, L)
    out = _launch("sc_metric_launch", r, L)
    sc_sliding_metric.launches += 1
    return out


def sc_sync_metric(r: torch.Tensor, L: int, gate_w: int):
    """(P, R, M) of complex64 r (..., n): P and R as `sc_sliding_metric`,
    M capped, zeroed where R = 0 and gated by the local energy over a
    window of gate_w (see module)."""
    _check("sc_sync_metric", r, L)
    if r.device.type == "cpu":
        return sc_sync_metric_plain(r, L, gate_w)
    k = halo_rows(gate_w)
    if k > MAX_HALO:
        raise ValueError(f"sc_sync_metric: gate width {gate_w} reaches "
                         f"{k} rows of {GATE_ROW}, the kernel takes "
                         f"{MAX_HALO}")
    out = _launch("sc_sync_metric_launch", r, L, k)
    sc_sync_metric.launches += 1
    return out


sc_sliding_metric.launches = 0  # kernel launches since the last reset
sc_sync_metric.launches = 0
