"""Frame equalizers (counterpart of tpu_ofdm/ops/equalizer.py):
zero-forcing with pilot common-phase correction, and the decision-feedback
variant.

`equalize_pilot_phase` is parallel over OFDM symbols and matches the golden
model's equalize_frame.  `equalize_simpledfe` is sequential over symbols
(each symbol's decisions update the channel estimate for the next), so it
loops over the symbol axis, batched over every leading axis (the frame
slots; the JAX package scans one slot and vmaps).
"""

from __future__ import annotations

import functools

import torch

from tpu_ofdm_torch.config import OfdmSpec
from tpu_ofdm_torch.ops.carrier_alloc import data_bins, pilots
from tpu_ofdm_torch.ops.constellation import hard_decisions, points


@functools.lru_cache(maxsize=64)
def _dfe_active(spec: OfdmSpec, device: torch.device) -> torch.Tensor:
    """(fft_len,) mask of the bins whose estimate the DFE updates: the data
    and pilot bins."""
    active = torch.zeros(spec.fft_len, dtype=torch.bool, device=device)
    active[data_bins(spec, device)] = True
    active[pilots(spec, device)[0]] = True
    return active


def _common_phase(spec: OfdmSpec, eq: torch.Tensor) -> torch.Tensor:
    """Unit phasor of the pilots' rotation per symbol, (..., n_syms)."""
    pb, pil = pilots(spec, eq.device)
    rot = (pil.conj() * eq[..., pb]).sum(-1)
    mag = rot.abs()
    return torch.where(mag > 1e-12, rot / mag.clamp(min=1e-12), 1.0 + 0j)


def equalize_pilot_phase(spec: OfdmSpec, grids: torch.Tensor,
                         H: torch.Tensor) -> torch.Tensor:
    """grids (..., n_syms, fft_len), H (..., fft_len) -> equalized grids.
    The pilot rotation is summed per symbol over that symbol's own pilots."""
    Hs = torch.where(H.abs() > 1e-9, H, 1.0 + 0j)
    eq = grids / Hs[..., None, :]
    return eq * _common_phase(spec, eq).conj()[..., None]


def equalize_simpledfe(spec: OfdmSpec, grids: torch.Tensor, H: torch.Tensor,
                       modulation: str | None = None,
                       alpha: float = 0.1) -> torch.Tensor:
    """Decision-feedback equalizer (cf. ofdm_equalizer_simpledfe): per OFDM
    symbol, equalize with the current estimate and remove the pilots'
    common phase, slice the data carriers to the nearest point (pilots use
    their known symbols), then H <- (1 - alpha) H + alpha rx / decision on
    the data and pilot bins.  grids (..., n_syms, fft_len), H (...,
    fft_len) -> equalized grids."""
    modulation = modulation or spec.modulation
    dev = grids.device
    pts = points(modulation, dev)
    pb, pil = pilots(spec, dev)
    db = data_bins(spec, dev)
    active = _dfe_active(spec, dev)
    Hc = H.to(torch.complex64)
    out = []
    for s in range(grids.shape[-2]):
        sym = grids[..., s, :]
        Hs = torch.where(Hc.abs() > 1e-9, Hc, 1.0 + 0j)
        ph = _common_phase(spec, (sym / Hs)[..., None, :])[..., 0, None]
        eq = sym / Hs * ph.conj()
        decisions = torch.zeros_like(sym)
        decisions[..., db] = pts[hard_decisions(eq[..., db], modulation)]
        decisions[..., pb] = pil
        ratio = sym * ph.conj() / torch.where(decisions.abs() > 1e-9,
                                              decisions, 1.0 + 0j)
        Hc = torch.where(active, (1 - alpha) * Hc + alpha * ratio, Hc)
        out.append(eq)
    return torch.stack(out, dim=-2)
