"""Spectrum probe accumulators: average / max-hold / min-hold PSD
(counterpart of tpu_ofdm/spectrum/probe.py).

The accumulation runs on the device as a streaming Block; the host drains a
small (3, fft_len) summary per time-block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_ofdm_torch.spectrum.psd import psd_frames
from tpu_ofdm_torch.stream.block import Block


class SpectrumSummary(NamedTuple):
    avg_db: torch.Tensor      # (fft_len,) running average PSD, dB
    max_db: torch.Tensor      # (fft_len,) max-hold, dB
    min_db: torch.Tensor      # (fft_len,) min-hold, dB
    n_frames: torch.Tensor    # () int32 frames accumulated


def spectrum_probe_block(
    fft_len: int,
    window: str = "hann",
    floor: float = 1e-20,
) -> Block:
    """Accumulate avg/max/min PSD across all frames seen since reset.

    Averaging is done in linear power (then converted to dB on output);
    max/min hold are per-bin extrema over frames.
    """

    def init(device):
        return (
            torch.zeros(fft_len, dtype=torch.float32, device=device),
            torch.full((fft_len,), float("-inf"), device=device),
            torch.full((fft_len,), float("inf"), device=device),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    def apply(state, x):
        s, mx, mn, cnt = state
        pwr = psd_frames(x, fft_len, window)                  # (n, fft_len)
        s = s + pwr.sum(-2)
        mx = torch.maximum(mx, pwr.amax(-2))
        mn = torch.minimum(mn, pwr.amin(-2))
        cnt = cnt + pwr.shape[-2]

        def db(p):
            return 10.0 * torch.log10(p.clamp(min=floor))

        out = SpectrumSummary(
            avg_db=db(s / cnt.clamp(min=1).to(torch.float32)),
            max_db=db(mx),
            # an empty min-hold (+inf) reads as 0 before dB, as in the JAX
            # package
            min_db=db(torch.where(torch.isinf(mn), 0.0, mn)),
            n_frames=cnt,
        )
        return (s, mx, mn, cnt), out

    return Block(init, apply, f"spectrum_probe({fft_len})")
