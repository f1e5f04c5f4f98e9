"""Subcarrier serialization (counterpart of tpu_ofdm/ops/carrier_alloc.py,
RX side): frequency grids -> flat data-carrier symbol stream."""

from __future__ import annotations

import functools

import torch

from tpu_ofdm_torch.config import OfdmSpec


@functools.lru_cache(maxsize=64)
def _data_bins(spec: OfdmSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(spec.data_bins, device=device)


def serialize(spec: OfdmSpec, grids: torch.Tensor) -> torch.Tensor:
    """Grids (..., n_syms, fft_len) -> data symbols (..., n_syms*n_data),
    dropping pilots and unoccupied carriers."""
    d = grids[..., _data_bins(spec, grids.device)]
    return d.reshape(*grids.shape[:-2], grids.shape[-2] * spec.n_data)
