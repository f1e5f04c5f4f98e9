"""Subcarrier allocation and serialization (counterpart of
tpu_ofdm/ops/carrier_alloc.py): data symbols + pilots + sync words ->
frequency grids on TX, grids -> flat data-carrier symbol stream on RX."""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec


@functools.lru_cache(maxsize=64)
def data_bins(spec: OfdmSpec, device: torch.device) -> torch.Tensor:
    """spec.data_bins on `device` (cached)."""
    return torch.as_tensor(spec.data_bins, device=device)


@functools.lru_cache(maxsize=64)
def pilots(spec: OfdmSpec, device: torch.device):
    """(spec.pilot_bins, spec.pilot_symbols) on `device` (cached)."""
    return (torch.as_tensor(spec.pilot_bins, device=device),
            torch.as_tensor(spec.pilot_symbols, device=device))


@functools.lru_cache(maxsize=64)
def _sync_words(spec: OfdmSpec, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.stack([spec.sync_word1_freq,
                                     spec.sync_word2_freq]), device=device)


def allocate(spec: OfdmSpec, data_syms: torch.Tensor) -> torch.Tensor:
    """Data symbols (..., n_syms*n_data) -> complex64 grids (..., n_syms,
    fft_len): data on the data bins, pilots on the pilot bins, zeros
    elsewhere.  The length must be a multiple of n_data."""
    nd = spec.n_data
    n_syms = data_syms.shape[-1] // nd
    lead = data_syms.shape[:-1]
    dev = data_syms.device
    grid = torch.zeros((*lead, n_syms, spec.fft_len), dtype=torch.complex64,
                       device=dev)
    grid[..., data_bins(spec, dev)] = data_syms.reshape(*lead, n_syms, nd).to(
        torch.complex64)
    pb, pil = pilots(spec, dev)
    grid[..., pb] = pil
    return grid


def serialize(spec: OfdmSpec, grids: torch.Tensor) -> torch.Tensor:
    """Grids (..., n_syms, fft_len) -> data symbols (..., n_syms*n_data),
    dropping pilots and unoccupied carriers."""
    d = grids[..., data_bins(spec, grids.device)]
    return d.reshape(*grids.shape[:-2], grids.shape[-2] * spec.n_data)


def sync_grids(spec: OfdmSpec, batch_shape, device) -> torch.Tensor:
    """The two sync-word grids (..., 2, fft_len), broadcast to
    batch_shape (a view: clone before writing into it)."""
    sw = _sync_words(spec, torch.device(device))
    return sw.expand(*batch_shape, 2, spec.fft_len)
