"""CRC32 (IEEE 802.3) and CRC-8 in the parallel GF(2) basis form
(counterpart of tpu_ofdm/ops/crc.py).

A CRC is GF(2)-linear in the message bits, so the register after n bytes is
the XOR of one precomputed table row per set bit, plus a constant for the
initial value: one gather and a log-depth XOR tree, no byte-serial loop.
Reductions run over the LAST axis only, so a batch of frame slots (K, n)
gets one CRC per slot.

Arithmetic is int64 masked to 32 bits: torch.uint32 has little op coverage
(no reliable shifts or xor on CUDA).  Conventions match zlib.crc32
(reflected, init/xorout 0xFFFFFFFF) and the golden model's crc8 (poly 0x07,
init 0, MSB-first).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _crc32_table_np() -> np.ndarray:
    poly = 0xEDB88320
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        table[i] = c
    return table


@functools.lru_cache(maxsize=None)
def _crc32_basis_np(cap: int) -> tuple[np.ndarray, np.ndarray]:
    """(basis, initc) for the parallel CRC32.

    One byte step is reg' = A(reg) ^ table[b] with A(r) = table[r & 0xFF] ^
    (r >> 8), so over n bytes reg_n = A^n(init) ^ XOR_i A^(n-1-i)(table[b_i]):
      basis[d, j] = A^d(table[1 << j]), byte-bit j at distance d from the
                    END of the message; (cap, 8) uint32
      initc[n]    = A^n(0xFFFFFFFF); (cap + 1,) uint32
    """
    table = _crc32_table_np()

    def A(r: np.ndarray) -> np.ndarray:
        return table[r & 0xFF] ^ (r >> np.uint32(8))

    basis = np.zeros((max(cap, 1), 8), dtype=np.uint32)
    basis[0] = table[1 << np.arange(8)]
    for d in range(1, cap):
        basis[d] = A(basis[d - 1])
    initc = np.zeros(cap + 1, dtype=np.uint32)
    initc[0] = 0xFFFFFFFF
    for n in range(1, cap + 1):
        initc[n] = A(initc[n - 1 : n])[0]
    return basis, initc


@functools.lru_cache(maxsize=None)
def _crc8_powers_np(n: int) -> np.ndarray:
    """P[d] = L^d(0x07), L the one-bit CRC-8 register step
    L(r) = ((r << 1) & 0xFF) ^ (0x07 if r & 0x80 else 0); over n bits
    (init 0) reg_n = XOR_{i: b_i=1} P[n-1-i]."""
    p = np.zeros(max(n, 1), dtype=np.uint32)
    p[0] = 0x07
    for d in range(1, n):
        r = int(p[d - 1])
        p[d] = ((r << 1) & 0xFF) ^ (0x07 if r & 0x80 else 0)
    return p


@functools.lru_cache(maxsize=64)
def _crc32_tables(cap: int, device: torch.device):
    basis, initc = _crc32_basis_np(cap)
    return (torch.as_tensor(basis.astype(np.int64), device=device),
            torch.as_tensor(initc.astype(np.int64), device=device))


@functools.lru_cache(maxsize=64)
def _crc8_rows(n: int, device: torch.device) -> torch.Tensor:
    rows = _crc8_powers_np(n)[::-1].astype(np.int64)   # rows[i] = P[n-1-i]
    return torch.as_tensor(rows.copy(), device=device)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis, log-depth tree."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def crc32(data: torch.Tensor, length: torch.Tensor | None = None
          ) -> torch.Tensor:
    """CRC32 of uint8 data (..., n) over the first `length` (...) bytes of
    each row (all n if None); int64 result in [0, 2^32)."""
    n = data.shape[-1]
    dev = data.device
    if length is None:
        length = torch.full(data.shape[:-1], n, device=dev)
    length = length.to(torch.int64)
    basis, initc = _crc32_tables(n, dev)
    d = length[..., None] - 1 - torch.arange(n, device=dev)   # distance from end
    rows = basis[d.clamp(0, n - 1)]                           # (..., n, 8)
    bits = (data.to(torch.int64)[..., None]
            >> torch.arange(8, device=dev)) & 1
    contrib = torch.where((bits == 1) & (d >= 0)[..., None], rows, 0)
    reg = _xor_reduce(contrib.reshape(*contrib.shape[:-2], n * 8))
    return reg ^ initc[length.clamp(0, n)] ^ 0xFFFFFFFF


def check_crc32(data: torch.Tensor, wire_len: torch.Tensor) -> torch.Tensor:
    """True where data[:wire_len-4] has CRC32 == data[wire_len-4:wire_len]
    (little-endian); data (..., cap) uint8, wire_len (...) int."""
    n = data.shape[-1]
    dev = data.device
    wire_len = wire_len.to(torch.int64)
    body_len = (wire_len - 4).clamp(min=0)
    got = crc32(data, body_len)
    idx = (body_len[..., None] + torch.arange(4, device=dev)).clamp(max=n - 1)
    tail = torch.gather(data.to(torch.int64), -1, idx)
    want = (tail << torch.arange(0, 32, 8, device=dev)).sum(-1)
    return (got == want) & (wire_len >= 4)


def crc8_bits(bits: torch.Tensor) -> torch.Tensor:
    """CRC-8 (poly 0x07, init 0) over MSB-first bits (..., n) -> int64."""
    rows = _crc8_rows(bits.shape[-1], bits.device)
    return _xor_reduce(torch.where(bits.to(torch.int64) == 1, rows, 0))
