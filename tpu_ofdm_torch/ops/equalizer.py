"""Zero-forcing + pilot common-phase equalizer (counterpart of
`equalize_pilot_phase` in tpu_ofdm/ops/equalizer.py).  Matches the golden
model's equalize_frame."""

from __future__ import annotations

import functools

import torch

from tpu_ofdm_torch.config import OfdmSpec


@functools.lru_cache(maxsize=64)
def _pilots(spec: OfdmSpec, device: torch.device):
    return (torch.as_tensor(spec.pilot_bins, device=device),
            torch.as_tensor(spec.pilot_symbols, device=device))


def equalize_pilot_phase(spec: OfdmSpec, grids: torch.Tensor,
                         H: torch.Tensor) -> torch.Tensor:
    """grids (..., n_syms, fft_len), H (..., fft_len) -> equalized grids.
    The pilot rotation is summed per symbol over that symbol's own pilots."""
    pb, pil = _pilots(spec, grids.device)
    Hs = torch.where(H.abs() > 1e-9, H, 1.0 + 0j)
    eq = grids / Hs[..., None, :]
    rot = (pil.conj() * eq[..., pb]).sum(-1)                  # (..., n_syms)
    mag = rot.abs()
    ph = torch.where(mag > 1e-12, rot / mag.clamp(min=1e-12), 1.0 + 0j)
    return eq * ph.conj()[..., None]
