"""OFDM packet header generation and parsing (counterpart of
tpu_ofdm/ops/header.py): 12-bit payload length, 12-bit frame number, CRC-8
-- 32 bits, MSB-first."""

from __future__ import annotations

import torch

from tpu_ofdm_torch.config import (
    HEADER_BITS,
    HEADER_CRC_BITS,
    HEADER_LEN_BITS,
    HEADER_NUM_BITS,
)
from tpu_ofdm_torch.ops.crc import crc8_bits
from tpu_ofdm_torch.utils.bits import bits_to_uint, uint_to_bits


def make_header_bits(payload_len: torch.Tensor,
                     frame_num: torch.Tensor) -> torch.Tensor:
    """(...) wire lengths and frame numbers -> (..., 32) uint8 header bits;
    the frame number is taken mod 2^12."""
    lbits = uint_to_bits(payload_len, HEADER_LEN_BITS)
    nbits = uint_to_bits(frame_num.to(torch.int64) % (1 << HEADER_NUM_BITS),
                         HEADER_NUM_BITS)
    body = torch.cat([lbits, nbits], dim=-1)
    return torch.cat([body, uint_to_bits(crc8_bits(body), HEADER_CRC_BITS)],
                     dim=-1)


def parse_header_bits(bits: torch.Tensor):
    """(..., 32) header bits -> (payload_len int32, frame_num int32,
    crc_ok bool), each (...)."""
    nb = HEADER_LEN_BITS + HEADER_NUM_BITS
    body = bits[..., :nb]
    plen = bits_to_uint(body[..., :HEADER_LEN_BITS], HEADER_LEN_BITS)
    fnum = bits_to_uint(body[..., HEADER_LEN_BITS:], HEADER_NUM_BITS)
    got = bits_to_uint(bits[..., nb:HEADER_BITS], HEADER_CRC_BITS)
    ok = got == crc8_bits(body)
    return plen.to(torch.int32), fnum.to(torch.int32), ok
