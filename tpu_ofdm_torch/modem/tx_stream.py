"""Streaming OFDM transmitter: the TX chain as an executor Block
(counterpart of tpu_ofdm/modem/tx_stream.py).

  * input per step: a fixed batch of K payload slots (payloads, lens,
    frame_nums, valid), tensors on the carry's device,
  * carry: the pending samples, a (B,) complex64 buffer with B = block_size
    + K * (max_frame_len + gap), and a write cursor () int32 -- the stream
    modulated but not yet emitted,
  * output per step: exactly block_size samples and an `accepted` mask; a
    slot the pending buffer cannot hold is refused (back-pressure) and the
    host queues it again.

Where the JAX package places frames with a sequential scan over the slots,
here the placement is one pass with no loop over K and no read-back: the
cursors are a prefix sum of valid * (n_samples + gap), a slot is accepted
when it is valid and its frame fits (cursor + max_frame_len <= B), and the
frames land with one index_add_.  The acceptance is the JAX package's: its
cursor stops at the first refused slot, and every later slot is refused
there too.  Frames overlap only where one frame's zero tail meets the
next frame, so the adds are exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec, StreamConfig
from tpu_ofdm_torch.modem.tx import tx_frames
from tpu_ofdm_torch.stream.block import Block


class TxStreamIn(NamedTuple):
    payloads: torch.Tensor    # (K, max_payload_bytes - 4) uint8
    lens: torch.Tensor        # (K,) int32 valid bytes per slot
    frame_nums: torch.Tensor  # (K,) int32
    valid: torch.Tensor       # (K,) bool: slot holds a queued PDU


class TxStreamOut(NamedTuple):
    samples: torch.Tensor     # (block_size,) complex64 continuous TX stream
    accepted: torch.Tensor    # (K,) bool: slot was modulated this step
    n_pending: torch.Tensor   # () int32 samples still queued after this step


def _host_tx_in(spec: OfdmSpec, k: int):
    return TxStreamIn(np.zeros((k, spec.max_payload_bytes - 4), np.uint8),
                      np.zeros(k, np.int32), np.zeros(k, np.int32),
                      np.zeros(k, bool))


def _to_device(ti: TxStreamIn, device) -> TxStreamIn:
    return TxStreamIn(*(torch.as_tensor(a, device=device) for a in ti))


def empty_tx_in(spec: OfdmSpec, k: int, device="cuda") -> TxStreamIn:
    """An all-invalid input batch on `device`."""
    return _to_device(_host_tx_in(spec, k), device)


def queue_tx_in(spec: OfdmSpec, k: int, pdus, frame_num0: int = 0,
                device="cuda"):
    """Pack up to k (bytes-like) PDUs into a TxStreamIn on `device`, slot
    i numbered frame_num0 + i; returns (tx_in, leftover PDUs)."""
    ti = _host_tx_in(spec, k)
    cap = spec.max_payload_bytes - 4
    for i, p in enumerate(pdus[:k]):
        data = bytes(p)[:cap]
        ti.payloads[i, : len(data)] = np.frombuffer(data, np.uint8)
        ti.lens[i] = len(data)
        ti.frame_nums[i] = frame_num0 + i
        ti.valid[i] = True
    return _to_device(ti, device), list(pdus[k:])


def pending_len(spec: OfdmSpec, stream_cfg: StreamConfig,
                gap: int | None = None) -> int:
    """B, the pending buffer's length."""
    gap = 4 * spec.cp_len if gap is None else gap
    return (stream_cfg.block_size
            + stream_cfg.max_frames_per_block * (spec.max_frame_len + gap))


def tx_stream_block(spec: OfdmSpec, stream_cfg: StreamConfig,
                    gap: int | None = None) -> Block:
    """Continuous transmitter Block (see the module docstring).  gap:
    inter-frame silence in samples (default 4 * cp_len)."""
    S = stream_cfg.block_size
    F = spec.max_frame_len
    gap = 4 * spec.cp_len if gap is None else gap
    B = pending_len(spec, stream_cfg, gap)

    def init(device):
        return (torch.zeros(B, dtype=torch.complex64, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def apply(state, x: TxStreamIn):
        buf, cur = state
        dev = buf.device
        frames = tx_frames(spec, x.payloads, x.lens, x.frame_nums)
        step = torch.where(x.valid, frames.n_samples.to(torch.int64) + gap, 0)
        starts = cur + torch.cumsum(step, 0) - step
        accepted = x.valid & (starts + F <= B)
        # a new buffer of the pending samples and S zeros, so the previous
        # carry and outputs are left as they were; the new carry is its
        # tail, and the emitted block a copy of its head, so an output kept
        # by the caller holds S samples, not the whole buffer
        work = torch.cat([buf, buf.new_zeros(S)])
        pos = (torch.where(accepted, starts, 0)[:, None]
               + torch.arange(F, device=dev))
        contrib = torch.where(accepted[:, None], frames.samples, 0)
        torch.view_as_real(work).index_add_(
            0, pos.reshape(-1), torch.view_as_real(contrib).reshape(-1, 2))
        cur = (cur + (step * accepted).sum() - S).clamp(min=0).to(torch.int32)
        return (work[S:], cur), TxStreamOut(work[:S].clone(), accepted, cur)

    return Block(init, apply, "ofdm_tx_stream", latency=0,
                 stream_input=False)


def carry_from_jax(state, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX transmitter's carry (pending complex64 (B,), cursor int32),
    as numpy arrays or anything np.asarray takes, -> this package's carry
    on `device`.  The layout is the same on both sides."""
    buf, cur = state
    return (torch.tensor(np.asarray(buf, dtype=np.complex64), device=device),
            torch.tensor(np.asarray(cur, dtype=np.int32), device=device))


def carry_to_jax(state) -> tuple[np.ndarray, np.ndarray]:
    """This package's carry -> (pending complex64 (B,), cursor int32) numpy
    arrays, the JAX transmitter's carry layout."""
    buf, cur = state
    return (buf.cpu().numpy().astype(np.complex64),
            np.asarray(cur.cpu().numpy(), dtype=np.int32))
