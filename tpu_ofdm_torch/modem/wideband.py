"""Wideband RX: polyphase channelizer -> N parallel OFDM demods, one Block
(counterpart of tpu_ofdm/modem/wideband.py; BASELINE.json config 4).

Where the JAX package vmaps rx_block over the channels, the channels here
are the batch axis of one rx_block call: one detect launch, one selection
and one gather for all of them, and one demod over the n_chan * K slots.
The channelizer hands its output over channel-major, (n_chan, S), as
rx_block batches it: on the card pfb writes that layout itself.

carry = (channelizer tail (C,) raw samples, per-channel history
(n_chan, H), step () int32).  Per-channel sample rate is fs / n_chan; each
step consumes block_size wideband samples and advances every channel by
S = block_size / n_chan.  Each channel's virtual buffer is [history |
channel block] (H + S samples), read in place; only detections starting in
[0, S) of it are accepted, as in the single-channel streaming receiver.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec, StreamConfig
from tpu_ofdm_torch.modem import sink
from tpu_ofdm_torch.modem.rx import RxBlockResult, rx_block
from tpu_ofdm_torch.modem.rx_stream import history_len
from tpu_ofdm_torch.spectrum.channelizer import (
    channelize_stream,
    device_poly,
    lowpass_taps,
    stream_tail_len,
)
from tpu_ofdm_torch.stream.block import Block
from tpu_ofdm_torch.utils import metrics


class WidebandRxOut(NamedTuple):
    result: RxBlockResult     # fields lead with (n_chan, K)
    block_index: torch.Tensor  # () int32 steps processed before this one


def wideband_rx_block(
    spec: OfdmSpec,
    n_chan: int,
    stream_cfg: StreamConfig,
    taps: np.ndarray | None = None,
    equalizer: str = "pilot_phase",
) -> Block:
    """Channelizer + N parallel streaming OFDM RX chains as one Block.

    stream_cfg.block_size counts WIDEBAND samples and must be a multiple of
    n_chan; per-channel blocks are block_size // n_chan samples.
    `equalizer` goes to rx_block ("pilot_phase" or "simpledfe")."""
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = device_poly(taps_np, n_chan)
    C = stream_tail_len(n_chan, taps_np)

    H = history_len(spec)
    S = stream_cfg.block_size // n_chan
    if S * n_chan != stream_cfg.block_size:
        raise ValueError("block_size must be a multiple of n_chan")
    K = stream_cfg.max_frames_per_block

    def init(device):
        return (
            torch.zeros(C, dtype=torch.complex64, device=device),
            torch.zeros((n_chan, H), dtype=torch.complex64, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    def apply(state, x):
        ch_tail, rx_hist, step = state
        with metrics.span("wideband.channelize"):
            chans, new_tail = channelize_stream(x, ch_tail, n_chan,
                                                poly(x.device),
                                                layout="chan")  # (n_chan, S)
        res = rx_block(spec, chans, K, own_lo=0, own_hi=S, head=rx_hist,
                       equalizer=equalizer)
        if S >= H:
            new_hist = chans[:, S - H:].clone()
        else:
            new_hist = torch.cat([rx_hist[:, S:], chans], dim=-1)
        return (new_tail, new_hist, step + 1), WidebandRxOut(res, step)

    return Block(init, apply, f"wideband_rx({n_chan})",
                 latency=H * n_chan + C)


def carry_from_jax(state, device):
    """The JAX wideband carry (channelizer tail (C,), per-channel history
    (n_chan, H), step), as numpy arrays or anything np.asarray takes, ->
    this package's carry on `device`.  The layout is the same on both
    sides."""
    tail, hist, step = state
    # torch.tensor copies: the JAX arrays' host buffers are read-only
    return (torch.tensor(np.asarray(tail, dtype=np.complex64), device=device),
            torch.tensor(np.asarray(hist, dtype=np.complex64), device=device),
            torch.tensor(np.asarray(step, dtype=np.int32), device=device))


def carry_to_jax(state):
    """This package's wideband carry -> (tail complex64 (C,), history
    complex64 (n_chan, H), step int32) numpy arrays, the JAX layout."""
    tail, hist, step = state
    return (tail.cpu().numpy().astype(np.complex64),
            hist.cpu().numpy().astype(np.complex64),
            np.asarray(step.cpu().numpy(), dtype=np.int32))


def collect_wideband_frames(outs, per_chan_block: int, spec: OfdmSpec):
    """Flatten WidebandRxOut steps -> frame dicts with channel + abs_start
    in PER-CHANNEL sample units (host-side, modem.sink)."""
    H = history_len(spec)
    return sink.collect(
        ((o.result, o.block_index, (0, 0, 1)) for o in outs),
        ("channel", "payload", "frame_num", "crc_ok", "evm", "abs_start"),
        lambda step, t: step * per_chan_block - H)
