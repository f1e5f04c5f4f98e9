"""Schmidl-Cox detection row summaries: CUDA kernel (csrc/sc_detect.cu)
and its plain version.

Counterpart of tpu_ofdm/kernels/sc_detect.py (`sc_detect_rows` and
`sc_detect_rows_hist`).  `sc_detect_rows(x, L, cp, head)` works on the
virtual buffer [head | x] and returns the six per-row summaries that
ops.sync._select_from_rows consumes, each (ceil((h + n) / 128),).  It also
takes a batch: x (B, n) and head (B, h) are B separate virtual buffers (the
wideband receiver's channels), and each summary is then (B, rows).

    smmax f32   max over the row of the CP-boxcar-smoothed metric, plus the
                tie-break ramp; -inf where no full window exists
    smarg int32 its first argmax, a global (virtual) position
    pre, pim    P at smarg - (cp - cp//2), the plateau centre
    r_at        R2 at the same position
    rmax        max of R2 over the row

Positions are trailing-window indices t, as in ops.sync._detect_rows_jnp
(see the kernel source for the formulas).  CUDA tensors launch the kernel;
CPU tensors take `sc_detect_rows_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ofdm_torch.kernels.build import check_vector, complex_ptr, library

ROW = 128  # candidate granularity (ops.sync.ROW)


def tiebreak(t: torch.Tensor) -> torch.Tensor:
    """(t & 0xFFFF) * 1e-7: the deterministic ramp that resolves perfectly
    flat plateaus (see tpu_ofdm.ops.sync._tiebreak)."""
    return (t & 0xFFFF).to(torch.float32) * 1e-7


def window_sums(s: torch.Tensor, w: int) -> torch.Tensor:
    """Valid-mode trailing sums of width w, each summed over its own w terms
    in float64 and cast back to float32.  A difference of running sums
    loses eps times everything summed before the window: a float32 cumsum
    several percent over a 2^25-sample block, a float64 one ~1% of a quiet
    window just past a burst 120 dB above it (the wideband receiver's
    channels).  Summing each window alone keeps the plain version a
    trustworthy yardstick at any length and dynamic range."""
    return s.to(torch.float64).unfold(-1, w, 1).sum(-1).to(torch.float32)


def sc_detect_rows_plain(x: torch.Tensor, L: int, cp: int,
                         head: torch.Tensor | None = None):
    """Plain PyTorch version of `sc_detect_rows` (same arguments)."""
    v = x if head is None else torch.cat([head, x], dim=-1)
    lead = v.shape[:-1]
    nv = v.shape[-1]
    W = cp + 1
    c = cp - cp // 2
    t_sm = 2 * L + W - 2
    a = torch.view_as_real(v[..., :-L])       # x[u - L]
    b = torch.view_as_real(v[..., L:])        # x[u]
    ar, ai, br, bi = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    p_re = window_sums(ar * br + ai * bi, L)    # valid mode: index t - (2L-1)
    p_im = window_sums(ar * bi - ai * br, L)
    r2 = window_sums(br * br + bi * bi, L)
    r1 = window_sums(ar * ar + ai * ai, L)
    den = r1 * r2
    p2 = p_re * p_re + p_im * p_im
    M = torch.where(den > 0, (p2 / den.clamp(min=1e-12)).clamp(max=2.0), 0.0)
    sm = window_sums(M, W) / W                  # index t - t_sm

    rows = -(-nv // ROW)
    npad = rows * ROW

    def at(z, off, fill):
        # t-indexed: out[t] = z[t - off], filled outside, length npad
        keep = max(0, min(z.shape[-1], npad - off))
        return F.pad(z[..., :keep], (off, npad - off - keep), value=fill)

    t = torch.arange(npad, dtype=torch.int64, device=x.device)
    smf = at(sm, t_sm, float("-inf")) + tiebreak(t)
    smr = smf.reshape(*lead, rows, ROW)
    arg = smr.argmax(-1)
    smarg = (torch.arange(rows, device=x.device) * ROW + arg).to(torch.int32)

    def pick(z):
        return z.reshape(*lead, rows, ROW).gather(-1, arg[..., None])[..., 0]

    return (
        smr.amax(-1),
        smarg,
        pick(at(p_re, 2 * L - 1 + c, 0.0)),
        pick(at(p_im, 2 * L - 1 + c, 0.0)),
        pick(at(r2, 2 * L - 1 + c, 0.0)),
        at(r2, 2 * L - 1, 0.0).reshape(*lead, rows, ROW).amax(-1),
    )


def sc_detect_rows(x: torch.Tensor, L: int, cp: int,
                   head: torch.Tensor | None = None):
    """Row summaries over the virtual buffer [head | x]: complex64, x (n,)
    with head (h,), or a batch x (B, n) with head (B, h)."""
    check_vector(x, "x", torch.complex64, ndims=(1, 2))
    if head is not None:
        check_vector(head, "head", torch.complex64, x.device, ndims=(x.ndim,))
        if head.shape[:-1] != x.shape[:-1]:
            raise ValueError(f"head {tuple(head.shape)} and x "
                             f"{tuple(x.shape)} differ in batch")
    h = 0 if head is None else head.shape[-1]
    nv = h + x.shape[-1]
    # 2^30, not the int32 limit: _select_from_rows marks invalid candidates
    # with the sentinel 1 << 30
    if nv >= 1 << 30:
        raise ValueError(f"buffer of {nv} samples: positions must stay "
                         "below the selection sentinel 2^30")
    if x.device.type == "cpu":
        return sc_detect_rows_plain(x, L, cp, head)
    if x.device.type != "cuda":
        raise ValueError(f"sc_detect_rows: unsupported device {x.device}")
    rows = -(-nv // ROW)
    B = x.shape[0] if x.ndim == 2 else 1
    out = torch.empty((6, B, rows), dtype=torch.float32, device=x.device)
    library().launch(
        "sc_detect_launch", x.device, complex_ptr(head), h, h,
        complex_ptr(x), x.shape[-1], x.shape[-1], B, L, cp, out.data_ptr(),
        rows,
    )
    sc_detect_rows.launches += 1
    out = out.reshape(6, *x.shape[:-1], rows)
    return (out[0], out[1].view(torch.int32), out[2], out[3], out[4], out[5])


sc_detect_rows.launches = 0  # kernel launches since the last reset
