"""Waterfall buffers (device) and terminal/ASCII rendering (host)
(counterpart of tpu_ofdm/spectrum/waterfall.py).

The device keeps a rolling (depth, fft_len) ring of PSD rows; the host
renders ASCII frames from drained rows (numpy, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ofdm_torch.spectrum.psd import psd_frames
from tpu_ofdm_torch.stream.block import Block

# dark -> bright ramp, same idea as the reference's ASCII art sink
_RAMP = " .:-=+*#%@"


def waterfall_block(
    fft_len: int,
    depth: int = 64,
    window: str = "hann",
    decim: int = 1,
    floor: float = 1e-20,
) -> Block:
    """Rolling waterfall: keep the newest `depth` PSD rows (dB, fftshifted so
    DC is centred).  `decim` keeps every decim-th frame."""

    def init(device):
        return torch.full((depth, fft_len), -200.0, device=device)

    def apply(ring, x):
        pwr = psd_frames(x, fft_len, window)[..., ::decim, :]
        rows = 10.0 * torch.log10(pwr.clamp(min=floor))
        rows = torch.roll(rows, fft_len // 2, dims=-1)       # centre DC
        k = min(rows.shape[-2], depth)
        ring = torch.cat([ring[k:], rows[-k:]], dim=0)
        return ring, ring

    return Block(init, apply, f"waterfall({fft_len}x{depth})")


def render_ascii(
    rows,
    db_min: float | None = None,
    db_max: float | None = None,
    width: int | None = None,
) -> str:
    """Render (n_rows, fft_len) dB rows (numpy, or a CPU tensor) as ASCII
    art.  Auto-scales to the data range unless db_min/db_max are given;
    optionally column-decimates to `width` characters."""
    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    finite = rows[np.isfinite(rows)]
    lo = db_min if db_min is not None else (finite.min() if finite.size else -120)
    hi = db_max if db_max is not None else (finite.max() if finite.size else 0)
    hi = max(hi, lo + 1e-6)
    if width and width < rows.shape[1]:
        step = rows.shape[1] // width
        rows = rows[:, : width * step].reshape(rows.shape[0], width, step).max(-1)
    t = np.clip((rows - lo) / (hi - lo), 0.0, 1.0)
    idx = (t * (len(_RAMP) - 1)).astype(np.int64)
    lut = np.frombuffer(_RAMP.encode(), dtype=np.uint8)
    return "\n".join(bytes(lut[r]).decode() for r in idx)


def render_spectrum_line(
    psd_db, width: int = 80, db_min: float = -100, db_max: float = 0
) -> str:
    """One-line spectrum bar view of a single PSD row."""
    return render_ascii(np.asarray(psd_db)[None, :], db_min, db_max, width)
