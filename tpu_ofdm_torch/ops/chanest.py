"""Coarse integer-CFO estimation and LS channel estimation (counterpart of
tpu_ofdm/ops/chanest.py).

Every function takes a batch of frame slots on the leading axes; the integer
CFO is resolved per slot and `roll_bins` undoes it with a per-slot gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec


@functools.lru_cache(maxsize=64)
def _rolled_refs_np(spec: OfdmSpec, max_shift: int) -> np.ndarray:
    ref = np.abs(spec.sync_word1_freq)
    return np.stack(
        [np.roll(ref, s) for s in range(-max_shift, max_shift + 1)]
    ).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _rolled_refs(spec: OfdmSpec, max_shift: int, device: torch.device):
    return torch.as_tensor(_rolled_refs_np(spec, max_shift), device=device)


@functools.lru_cache(maxsize=64)
def _sync2_consts(spec: OfdmSpec, device: torch.device):
    """(occupied mask, sync word 2 with 1 on unoccupied bins) over all
    fft_len bins, so the LS estimate is one elementwise pass."""
    occ = np.zeros(spec.fft_len, dtype=bool)
    occ[spec.occupied_bins] = True
    x = np.where(occ, spec.sync_word2_freq, 1.0).astype(np.complex64)
    return (torch.as_tensor(occ, device=device),
            torch.as_tensor(x, device=device))


def coarse_int_cfo(spec: OfdmSpec, sync1_fd: torch.Tensor,
                   max_shift: int | None = None) -> torch.Tensor:
    """Integer CFO in bins, searched over +-max_shift (default
    spec.cfg.max_int_cfo), from the received sync word 1 spectrum (..., N)
    -> int32 (...).  Positive means the RX spectrum is shifted UP; undo it
    with roll_bins(grid, ic)."""
    if max_shift is None:
        max_shift = spec.cfg.max_int_cfo
    refs = _rolled_refs(spec, max_shift, sync1_fd.device)    # (2K+1, N)
    scores = sync1_fd.abs() @ refs.T                         # (..., 2K+1)
    return (torch.argmax(scores, dim=-1) - max_shift).to(torch.int32)


def roll_bins(grid: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[..., b] = grid[..., (b + shift) % N], with one shift per leading
    batch index: grid (B..., S..., N), shift (B...)."""
    n = grid.shape[-1]
    idx = (torch.arange(n, device=grid.device)
           + shift.to(torch.int64)[..., None]) % n
    lead = [1] * (grid.ndim - idx.ndim)
    idx = idx.reshape(*idx.shape[:-1], *lead, n).expand(grid.shape)
    return torch.gather(grid, -1, idx)


def ls_estimate(spec: OfdmSpec, sync2_fd: torch.Tensor) -> torch.Tensor:
    """LS channel estimate from sync word 2 (..., N) -> (..., N): H = Y/X on
    occupied bins, 1.0 elsewhere (neutral under division; never
    serialized)."""
    occ, x = _sync2_consts(spec, sync2_fd.device)
    return torch.where(occ, sync2_fd / x, 1.0 + 0j)
