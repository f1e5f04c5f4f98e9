"""Constellation points, mapping, hard and soft (max-log LLR) demapping,
and EVM (counterpart of tpu_ofdm/ops/constellation.py).

Bit conventions match tests/golden/golden_ofdm.py: symbol value =
stream-order bits, MSB first; unit average power.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.config import BITS_PER_SYMBOL
from tpu_ofdm_torch.utils.bits import group_bits, ungroup_bits

_GRAY_2 = np.array([-1.0, 1.0])
_GRAY_4 = np.array([-3.0, -1.0, 3.0, 1.0])
_GRAY_8 = np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0])


@functools.lru_cache(maxsize=None)
def points_np(modulation: str) -> np.ndarray:
    """2**k constellation points indexed by MSB-first symbol value."""
    if modulation == "bpsk":
        return _GRAY_2.astype(np.complex64)
    if modulation == "qpsk":
        i = _GRAY_2[np.arange(4) >> 1]
        q = _GRAY_2[np.arange(4) & 1]
        return ((i + 1j * q) / np.sqrt(2.0)).astype(np.complex64)
    if modulation == "qam16":
        idx = np.arange(16)
        i = _GRAY_4[(idx >> 2) & 0x3]
        q = _GRAY_4[idx & 0x3]
        return ((i + 1j * q) / np.sqrt(10.0)).astype(np.complex64)
    if modulation == "qam64":
        idx = np.arange(64)
        i = _GRAY_8[(idx >> 3) & 0x7]
        q = _GRAY_8[idx & 0x7]
        return ((i + 1j * q) / np.sqrt(42.0)).astype(np.complex64)
    raise ValueError(f"unknown modulation {modulation!r}")


@functools.lru_cache(maxsize=None)
def bit_masks_np(modulation: str) -> np.ndarray:
    """(k, n_points) bool: bit b of the point index is 1."""
    k = BITS_PER_SYMBOL[modulation]
    idx = np.arange(2**k)
    return np.stack([((idx >> (k - 1 - b)) & 1).astype(bool)
                     for b in range(k)])


@functools.lru_cache(maxsize=64)
def points(modulation: str, device: torch.device) -> torch.Tensor:
    """points_np(modulation) on `device` (cached)."""
    return torch.as_tensor(points_np(modulation), device=device)


@functools.lru_cache(maxsize=64)
def _bit_masks(modulation: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bit_masks_np(modulation), device=device)


def map_bits(bits: torch.Tensor, modulation: str) -> torch.Tensor:
    """Bits (..., n*k) -> complex64 symbols (..., n)."""
    k = BITS_PER_SYMBOL[modulation]
    return points(modulation, bits.device)[group_bits(bits, k)]


def hard_decisions(symbols: torch.Tensor, modulation: str) -> torch.Tensor:
    """Min-distance point indices (..., n) -> int64 symbol values.
    torch.argmin returns the first minimum on ties, as jnp.argmin does."""
    pts = points(modulation, symbols.device)
    d2 = (symbols[..., None] - pts).abs() ** 2
    return torch.argmin(d2, dim=-1)


def demap_hard(symbols: torch.Tensor, modulation: str) -> torch.Tensor:
    """Symbols (..., n) -> uint8 bits (..., n*k), stream order."""
    k = BITS_PER_SYMBOL[modulation]
    return ungroup_bits(hard_decisions(symbols, modulation), k)


def demap_soft(symbols: torch.Tensor, modulation: str,
               noise_var: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Max-log LLRs (..., n*k) of symbols (..., n); positive => bit 0 is
    more likely.  noise_var is a float or one value per row, shape (...)."""
    k = BITS_PER_SYMBOL[modulation]
    pts = points(modulation, symbols.device)
    masks = _bit_masks(modulation, symbols.device)           # (k, P)
    d2 = (symbols[..., None] - pts).abs() ** 2                # (..., n, P)
    d2 = d2[..., None, :]                                     # (..., n, 1, P)
    d0 = torch.where(masks, float("inf"), d2).amin(-1)        # (..., n, k)
    d1 = torch.where(masks, d2, float("inf")).amin(-1)
    if isinstance(noise_var, torch.Tensor):
        nv = noise_var.clamp(min=1e-12)[..., None, None]
    else:
        nv = max(noise_var, 1e-12)
    llr = (d1 - d0) / nv
    return llr.reshape(*symbols.shape[:-1], symbols.shape[-1] * k)


def evm(symbols: torch.Tensor, modulation: str, mask=None) -> torch.Tensor:
    """RMS error-vector magnitude vs hard decisions, reduced over the last
    axis only: (..., n) -> (...), one value per frame slot."""
    pts = points(modulation, symbols.device)
    hard = pts[hard_decisions(symbols, modulation)]
    err = (symbols - hard).abs() ** 2
    if mask is not None:
        err = torch.where(mask, err, 0.0)
        denom = mask.sum(-1).clamp(min=1)
    else:
        denom = symbols.shape[-1]
    return torch.sqrt(err.sum(-1) / denom)
