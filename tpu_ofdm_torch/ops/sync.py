"""Schmidl-Cox frame detection and CFO derotation (counterpart of the
detection half of tpu_ofdm/ops/sync.py).

Structure, as in the JAX package: per-row (ROW = 128 samples) candidate
summaries from one fused pass over the samples (kernels/sc_detect.py), then
a selection -- local energy gate, windowed non-max suppression, threshold,
top-K -- on the 128x smaller row arrays.  Every shape is static: up to
`max_frames` detections with a validity mask, so the step never waits on
the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_ofdm_torch.config import OfdmSpec
from tpu_ofdm_torch.kernels.sc_detect import ROW, sc_detect_rows


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


class Detections(NamedTuple):
    start: torch.Tensor     # (K,) int32: index of first FFT-window sample
    fine_cfo: torch.Tensor  # (K,) float32: fractional CFO, subcarrier units
    valid: torch.Tensor     # (K,) bool
    peak: torch.Tensor      # (K,) float32: smoothed metric at the peak


def min_frame_gap(spec: OfdmSpec) -> int:
    """Smallest start-to-start spacing at which two frames are guaranteed
    to be detected separately (peaks more than the NMS radius of rows
    apart)."""
    kn = max(1, -(-(spec.sym_len // 2) // ROW))
    return (kn + 1) * ROW


def _select_from_rows(
    spec: OfdmSpec,
    smmax, smarg, pre, pim, r_at, rmax,
    n_sm: int,
    max_frames: int,
    threshold: float,
) -> Detections:
    """Candidate selection over the per-row summaries (see
    kernels/sc_detect.py): local energy gate, non-max suppression at row
    granularity, threshold, then the `max_frames` earliest survivors."""
    cp = spec.cp_len
    # local energy scale: sliding max over ~2 symbols of row maxima; STRICT
    # > so an exactly-silent candidate never passes
    kg = max(1, -(-spec.sym_len // ROW))
    local = sliding_max_same(rmax, 2 * kg + 1, pad_left=kg)
    gate = r_at > 0.05 * local
    # gated-out rows are excluded BEFORE the max, so a residue row cannot
    # suppress a real peak
    kn = max(1, -(-(spec.sym_len // 2) // ROW))
    smg = torch.where(gate, smmax, float("-inf"))
    win = sliding_max_same(smg, 2 * kn + 1, pad_left=kn)
    t0 = spec.sym_len - 1          # trailing t of sm index 0 (= 2L + W - 2)
    ps = smarg - t0
    ok = gate & (smmax >= win) & (smmax > threshold)
    ok &= (ps >= 0) & (ps < n_sm)
    big = 1 << 30
    pos = torch.where(ok, ps, big)
    neg, idx = torch.topk(-pos, max_frames)
    order = -neg                   # ascending sm positions
    valid = order < big
    backoff = min(4, cp // 4)
    # the sm window [ps, ps+cp] peaks at the plateau centre ps + cp/2;
    # frame start = centre + cp - cp//2 - backoff = ps + cp - backoff
    start = order + cp - backoff
    fine_cfo = torch.atan2(pim[idx], pre[idx]) / math.pi
    return Detections(start.to(torch.int32), fine_cfo.to(torch.float32),
                      valid, smmax[idx])


def detect_frames(
    spec: OfdmSpec,
    x: torch.Tensor,
    max_frames: int,
    head: torch.Tensor | None = None,
) -> Detections:
    """Find up to `max_frames` frame starts in the virtual buffer
    [head | x] (complex64; head None for x alone).  Detections come sorted
    by position with a validity mask; positions are virtual coordinates.
    `start` points a few samples inside the CP before sync word 1's FFT
    window (the golden model's ISI backoff).  The threshold is the spec's
    sync_threshold."""
    L = spec.fft_len // 2
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    n_sm = nv - 2 * L - spec.cp_len + 1
    rows6 = sc_detect_rows(x, L, spec.cp_len, head=head)
    return _select_from_rows(spec, *rows6, n_sm=n_sm, max_frames=max_frames,
                             threshold=spec.cfg.sync_threshold)


def derotate(r: torch.Tensor, cfo_subcarriers: torch.Tensor,
             fft_len: int) -> torch.Tensor:
    """Remove a carrier frequency offset: r[..., n] * exp(-j 2 pi cfo n /
    N), one float32 cfo per leading index.  The phase is float32, computed
    in the JAX package's order."""
    n = torch.arange(r.shape[-1], dtype=torch.float32, device=r.device)
    ph = ((-2.0 * math.pi) * cfo_subcarriers)[..., None] * n / fft_len
    return r * torch.complex(torch.cos(ph), torch.sin(ph))
