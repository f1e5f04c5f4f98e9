"""Schmidl-Cox frame detection, the diagnostic sync metric, and CFO
derotation (counterpart of tpu_ofdm/ops/sync.py).

Detection, as in the JAX package: per-row (ROW = 128 samples) candidate
summaries from one fused pass over the samples (kernels/sc_detect.py), then
a selection -- local energy gate, windowed non-max suppression, threshold,
top-K -- on the 128x smaller row arrays.  Every shape is static: up to
`max_frames` detections with a validity mask, so the step never waits on
the host.  Detection and selection take an optional leading batch axis
(the wideband receiver's channels; the JAX package vmaps instead).

The diagnostic half -- `schmidl_cox` (full-length P, R and the gated M;
the CFO estimator statistics read it) and `moving_sum` -- runs the
sc_metric (gated form) and scan kernels respectively on CUDA tensors and
their plain versions on the CPU.  The sliding maxima live beside the
sc_metric kernel, whose gate they define.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_ofdm_torch.config import OfdmSpec
from tpu_ofdm_torch.kernels import scan
from tpu_ofdm_torch.kernels.sc_detect import ROW, sc_detect_rows
from tpu_ofdm_torch.kernels.sc_metric import (  # noqa: F401
    coarse_sliding_max_same, sc_sync_metric, sliding_max, sliding_max_same)


def moving_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """Valid-mode moving sum along the last axis: out[d] = sum x[d:d+w],
    length n - w + 1, from one cumsum (the scan kernel on CUDA).  Complex
    input gives complex64; float64 input is summed as float32, as in the
    JAX package."""
    if x.is_complex():
        re, im = scan.moving_sums([x.real, x.imag], w)
        return torch.complex(re, im)
    return scan.moving_sums([x], w)[0]


class SyncMetric(NamedTuple):
    metric: torch.Tensor   # M(d), float32, length n - fft_len + 1
    corr: torch.Tensor     # P(d), complex64, same length
    energy: torch.Tensor   # R(d), float32, same length


def schmidl_cox(spec: OfdmSpec, r: torch.Tensor) -> SyncMetric:
    """The Schmidl-Cox metric over a sample block (..., n), last axis:
    P and R of the window pairs, M capped at 2 and zeroed where R = 0 (the
    JAX package's CPU route; its TPU kernel leaves M uncapped, ROADMAP sec.
    C), then zeroed where R is below 5% of the local energy (a sliding max
    over ~2 symbols).  One sc_sync_metric kernel on CUDA; its plain version
    (float64 window sums, then the torch gate) on the CPU."""
    P, R, M = sc_sync_metric(r.to(torch.complex64).contiguous(),
                             spec.fft_len // 2, 2 * spec.sym_len + 1)
    return SyncMetric(M, P, R)


class Detections(NamedTuple):
    # each ([B,] K)
    start: torch.Tensor     # int32: index of first FFT-window sample
    fine_cfo: torch.Tensor  # float32: fractional CFO, subcarrier units
    valid: torch.Tensor     # bool
    peak: torch.Tensor      # float32: smoothed metric at the peak


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
    kernels/sc_detect.py), each ([B,] rows): local energy gate, non-max
    suppression at row granularity, threshold, then the `max_frames`
    earliest survivors of each batch row."""
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
    fine_cfo = torch.atan2(pim.gather(-1, idx), pre.gather(-1, idx)) / math.pi
    return Detections(start.to(torch.int32), fine_cfo.to(torch.float32),
                      valid, smmax.gather(-1, idx))


def detect_frames(
    spec: OfdmSpec,
    x: torch.Tensor,
    max_frames: int,
    head: torch.Tensor | None = None,
    threshold: float | None = None,
) -> Detections:
    """Find up to `max_frames` frame starts in the virtual buffer
    [head | x] (complex64, x (n,) and head (h,), or a batch of B buffers,
    x (B, n) and head (B, h); head None for x alone).  Detections come sorted
    by position with a validity mask; positions are virtual coordinates.
    `start` points a few samples inside the CP before sync word 1's FFT
    window (the golden model's ISI backoff).  `threshold` (default: the
    spec's sync_threshold) applies in the selection over the row summaries,
    not in the kernel."""
    if threshold is None:
        threshold = spec.cfg.sync_threshold
    L = spec.fft_len // 2
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    n_sm = nv - 2 * L - spec.cp_len + 1
    rows6 = sc_detect_rows(x, L, spec.cp_len, head=head)
    return _select_from_rows(spec, *rows6, n_sm=n_sm, max_frames=max_frames,
                             threshold=threshold)


def derotate(r: torch.Tensor, cfo_subcarriers: torch.Tensor,
             fft_len: int, n0: torch.Tensor | int = 0) -> torch.Tensor:
    """Remove a carrier frequency offset: r[..., n] * exp(-j 2 pi cfo
    (n + n0) / N), one float32 cfo (and one n0, where n0 is a tensor) per
    leading index.  The phase is float32, computed in the JAX package's
    order."""
    if isinstance(n0, torch.Tensor):
        n0 = n0.to(torch.float32)[..., None]
    n = torch.arange(r.shape[-1], dtype=torch.float32, device=r.device) + n0
    ph = ((-2.0 * math.pi) * cfo_subcarriers)[..., None] * n / fft_len
    return r * torch.complex(torch.cos(ph), torch.sin(ph))
