"""OFDM transmitter (counterpart of tpu_ofdm/modem/tx.py).

CRC32 append, header symbol, payload mapping, carrier allocation, IFFT,
cyclic prefix and scale, written for a batch of B frames at once (the JAX
package vmaps one frame).  Every frame occupies a fixed (max_frame_len,)
buffer: OFDM symbols beyond its payload are zeros and `n_samples` is its
true length, so nothing waits on the host.  Bits, header and symbols are
those of tests/golden/golden_ofdm.py exactly; samples match the JAX TX to
float32 rounding (torch.fft here, a matmul DFT there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_ofdm_torch.config import HEADER_BITS, OfdmSpec
from tpu_ofdm_torch.ops import carrier_alloc
from tpu_ofdm_torch.ops.constellation import map_bits
from tpu_ofdm_torch.ops.crc import append_crc32_bytes, crc32
from tpu_ofdm_torch.ops.header import make_header_bits
from tpu_ofdm_torch.ops.transform import add_cyclic_prefix, ofdm_ifft
from tpu_ofdm_torch.utils.bits import bytes_to_bits


class TxFrame(NamedTuple):
    samples: torch.Tensor    # ([B,] max_frame_len) complex64; 0 beyond n_samples
    n_samples: torch.Tensor  # ([B,]) int32: true frame length incl. sync+header
    wire_len: torch.Tensor   # ([B,]) int32: payload bytes incl. CRC32


def tx_frames(spec: OfdmSpec, payloads: torch.Tensor,
              payload_lens: torch.Tensor,
              frame_nums: torch.Tensor) -> TxFrame:
    """Modulate B frames: payloads (B, max_payload_bytes - 4) uint8 with
    payload_lens (B,) valid bytes each (0 .. max_payload_bytes - 4) and
    frame_nums (B,) -> (B, max_frame_len) frames [sync1 | sync2 | header |
    payload symbols], each symbol with its CP."""
    dev = payloads.device
    B = payloads.shape[0]
    cap = spec.max_payload_bytes
    bps = spec.bits_per_symbol
    nd = spec.n_data
    plen = payload_lens.to(torch.int64)

    # wire = payload || CRC32(payload), little-endian, in a cap-byte buffer;
    # bytes at and after the payload length are zeroed first
    w = min(payloads.shape[-1], cap)
    pay = F.pad(payloads[:, :w], (0, cap - w))
    pay = torch.where(torch.arange(cap, device=dev) < plen[:, None], pay, 0)
    crc_b = append_crc32_bytes(crc32(pay, plen))
    wire_len = plen + 4
    # the CRC bytes go to plen .. plen+3; any position >= cap is dropped
    # into one of four spare columns
    k = torch.arange(4, device=dev)
    idx = plen[:, None] + k
    idx = torch.where(idx < cap, idx, cap + k)
    wire = F.pad(pay, (0, 4)).scatter_(-1, idx, crc_b)[:, :cap]

    # header symbol: BPSK over all data carriers, zero-bit padded
    hdr = F.pad(make_header_bits(wire_len, frame_nums), (0, nd - HEADER_BITS))
    hdr_grid = carrier_alloc.allocate(spec, map_bits(hdr, "bpsk"))

    # payload symbols; the golden model pads the last OFDM symbol's unused
    # data carriers with zero symbols, not zero-bit points
    sym_cap = spec.max_payload_ofdm_syms * nd
    bit_cap = sym_cap * bps
    wire_bits = wire_len[:, None] * 8
    n_mod = (wire_len * 8 + bps - 1) // bps
    bits = F.pad(bytes_to_bits(wire), (0, bit_cap - cap * 8))
    bits = torch.where(torch.arange(bit_cap, device=dev) < wire_bits, bits, 0)
    syms = map_bits(bits, spec.modulation)
    syms = torch.where(torch.arange(sym_cap, device=dev) < n_mod[:, None],
                       syms, 0)

    # carrier allocation; OFDM symbols past the payload are zeroed
    n_pay = (n_mod + nd - 1) // nd
    pay_grid = carrier_alloc.allocate(spec, syms)
    live = torch.arange(spec.max_payload_ofdm_syms, device=dev) < n_pay[:, None]
    pay_grid = torch.where(live[..., None], pay_grid, 0)
    grid = torch.cat([carrier_alloc.sync_grids(spec, (B,), dev), hdr_grid,
                      pay_grid], dim=-2)

    samples = add_cyclic_prefix(spec, ofdm_ifft(grid)) * spec.cfg.scale
    n_syms = spec.n_sync_syms + spec.n_header_syms + n_pay
    return TxFrame(samples.to(torch.complex64),
                   (n_syms * spec.sym_len).to(torch.int32),
                   wire_len.to(torch.int32))


def tx_frame(spec: OfdmSpec, payload: torch.Tensor,
             payload_len: torch.Tensor | int,
             frame_num: torch.Tensor | int = 0) -> TxFrame:
    """One frame: payload (max_payload_bytes - 4,) uint8 -> TxFrame with
    samples (max_frame_len,) and scalar n_samples, wire_len."""
    dev = payload.device
    one = tx_frames(spec, payload[None],
                    torch.as_tensor(payload_len, device=dev).reshape(1),
                    torch.as_tensor(frame_num, device=dev).reshape(1))
    return TxFrame(*(f[0] for f in one))


def pack_stream(frames: TxFrame, gap: int = 0) -> torch.Tensor:
    """Concatenate padded frames (B, F) into one stream, each frame's zero
    padding kept as silence plus `gap` more zeros."""
    s = frames.samples
    if gap:
        s = F.pad(s, (0, gap))
    return s.reshape(-1)
