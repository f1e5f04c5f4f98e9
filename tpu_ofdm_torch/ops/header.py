"""OFDM packet header parsing (counterpart of tpu_ofdm/ops/header.py):
12-bit payload length, 12-bit frame number, CRC-8 -- 32 bits, MSB-first."""

from __future__ import annotations

import torch

from tpu_ofdm_torch.config import (
    HEADER_BITS,
    HEADER_CRC_BITS,
    HEADER_LEN_BITS,
    HEADER_NUM_BITS,
)
from tpu_ofdm_torch.ops.crc import crc8_bits
from tpu_ofdm_torch.utils.bits import bits_to_uint


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
