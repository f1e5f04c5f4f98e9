"""Bit/byte packing, MSB-first (counterpart of tpu_ofdm/utils/bits.py).

Integer results are int64: torch's unsigned types beyond uint8 have little
op coverage, so values that JAX keeps in uint32 ride in int64 here.
"""

from __future__ import annotations

import torch


def _msb_weights(width: int, device) -> torch.Tensor:
    return 1 << torch.arange(width - 1, -1, -1, dtype=torch.int64, device=device)


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 array (..., n) -> uint8 bits (..., n*8), MSB of each byte
    first."""
    return ungroup_bits(data, 8)


def uint_to_bits(x: torch.Tensor, width: int) -> torch.Tensor:
    """Unsigned integers (...) -> uint8 MSB-first bits (..., width)."""
    shifts = torch.arange(width - 1, -1, -1, dtype=torch.int64, device=x.device)
    return ((x.to(torch.int64)[..., None] >> shifts) & 1).to(torch.uint8)


def group_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Bit stream (..., n*k) -> int64 symbol values (..., n), MSB-first
    within each k-bit group."""
    n = bits.shape[-1] // k
    g = bits[..., : n * k].reshape(*bits.shape[:-1], n, k).to(torch.int64)
    return (g * _msb_weights(k, bits.device)).sum(-1)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Bit array (..., n*8) -> uint8 array (..., n), MSB-first."""
    n = bits.shape[-1] // 8
    b = bits[..., : n * 8].reshape(*bits.shape[:-1], n, 8).to(torch.int64)
    return (b * _msb_weights(8, bits.device)).sum(-1).to(torch.uint8)


def bits_to_uint(bits: torch.Tensor, width: int) -> torch.Tensor:
    """MSB-first bit vector (..., width) -> int64 value."""
    b = bits[..., :width].to(torch.int64)
    return (b * _msb_weights(width, bits.device)).sum(-1)


def ungroup_bits(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Symbol values (..., n) -> uint8 bit stream (..., n*k), MSB-first."""
    return uint_to_bits(vals, k).reshape(*vals.shape[:-1], vals.shape[-1] * k)
