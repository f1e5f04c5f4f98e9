"""Streaming OFDM receiver: the RX chain as an executor Block (counterpart
of tpu_ofdm/modem/rx_stream.py).

carry = (history (H,) complex64, step () int32), H >= max_frame_len +
2 * sym_len.  Each step works on the virtual buffer ext = [history | block]
(H + S samples) without building it, and accepts only detections whose
start lies in [0, S) of ext -- exactly the samples that entered one step
earlier -- so every frame is reported once however it straddles block
seams, at a fixed latency of H samples.  The new history is ext[S : S + H],
a copy: callers may reuse a block's memory once push() returns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec, StreamConfig
from tpu_ofdm_torch.modem import sink
from tpu_ofdm_torch.modem.rx import RxBlockResult, rx_block
from tpu_ofdm_torch.stream.block import Block


class RxStreamOut(NamedTuple):
    result: RxBlockResult       # frame slots for this step
    block_index: torch.Tensor   # () int32 steps processed before this one
    # Absolute sample positions are derived on the host (collect_frames) as
    # block_index * block_size - history_len + start, in Python ints.


def history_len(spec: OfdmSpec) -> int:
    """Carry length: a full frame plus margin for the sync metric windows,
    rounded up to a multiple of 1024 (the JAX package's value, so the two
    carries have one layout)."""
    need = spec.max_frame_len + 2 * spec.sym_len
    return -(-need // 1024) * 1024


def rx_stream_block(spec: OfdmSpec, stream_cfg: StreamConfig,
                    equalizer: str = "pilot_phase",
                    output: str = "hard") -> Block:
    H = history_len(spec)
    S = stream_cfg.block_size
    K = stream_cfg.max_frames_per_block

    def init(device):
        # history starts as zeros occupying absolute [-H, 0)
        return (torch.zeros(H, dtype=torch.complex64, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def apply(state, x):
        hist, step = state
        res = rx_block(spec, x, max_frames=K, own_lo=0, own_hi=S, head=hist,
                       equalizer=equalizer, output=output)
        if S >= H:
            new_hist = x[S - H:].clone()
        else:
            new_hist = torch.cat([hist[S:], x])
        return (new_hist, step + 1), RxStreamOut(res, step)

    return Block(init, apply, "ofdm_rx_stream", latency=H)


def carry_from_jax(state, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX receiver's carry (history complex64 (H,), step int32), as
    numpy arrays or anything np.asarray takes, -> this package's carry on
    `device`.  The layout is the same on both sides."""
    hist, step = state
    # torch.tensor copies: the JAX arrays' host buffers are read-only
    return (torch.tensor(np.asarray(hist, dtype=np.complex64), device=device),
            torch.tensor(np.asarray(step, dtype=np.int32), device=device))


def carry_to_jax(state) -> tuple[np.ndarray, np.ndarray]:
    """This package's carry -> (history complex64 (H,), step int32) numpy
    arrays, the JAX receiver's carry layout."""
    hist, step = state
    return (hist.cpu().numpy().astype(np.complex64),
            np.asarray(step.cpu().numpy(), dtype=np.int32))


def collect_frames(outs, block_size: int | None = None,
                   hist: int | None = None) -> list[dict]:
    """Flatten a list of RxStreamOut (one per step) into one dict per valid
    frame, on the host (modem.sink).  With block_size and hist given, each
    frame carries "abs_start", the absolute sample index of its detected
    start; with a soft-output receiver, "llr" holds the LLRs of the wire
    bytes (payload and CRC32)."""
    if block_size is None or hist is None:
        block_size = hist = 0               # abs_start: the start as is
    return sink.collect(
        ((o.result, o.block_index, (0, 0, 1)) for o in outs),
        ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok", "evm",
         "int_cfo", "fine_cfo", "abs_start", "llr"),
        lambda step, t: step * block_size - hist)
