"""FFT/IFFT and cyclic prefix (counterpart of tpu_ofdm/ops/transform.py).

The JAX package ran its transforms as matmul DFTs because jnp.fft did not
lower on its TPU stack; here torch.fft does them.  Normalization matches the
golden model: ifft * sqrt(N) on TX, fft / sqrt(N) on RX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec


def ofdm_ifft(grids: torch.Tensor) -> torch.Tensor:
    """Freq grids (..., fft_len) -> time-domain symbols, scaled by
    sqrt(N); complex64."""
    n = grids.shape[-1]
    return torch.fft.ifft(grids) * math.sqrt(n)


def ofdm_fft(symbols: torch.Tensor) -> torch.Tensor:
    """Time-domain symbols (..., fft_len) -> freq grids, scaled by
    1/sqrt(N); complex64."""
    n = symbols.shape[-1]
    return torch.fft.fft(symbols) / math.sqrt(n)


@functools.lru_cache(maxsize=64)
def _ramp(r: int, device: torch.device) -> torch.Tensor:
    """The raised-cosine up-ramp 0.5 (1 - cos(pi i / (r + 1))), i = 1..r,
    float32 (the JAX package's table)."""
    i = np.arange(1, r + 1, dtype=np.float32)
    return torch.as_tensor(0.5 * (1.0 - np.cos(np.pi * i / (r + 1))),
                           device=device)


def add_cyclic_prefix(spec: OfdmSpec, td_syms: torch.Tensor) -> torch.Tensor:
    """(..., n_syms, fft_len) -> (..., n_syms * (fft_len + cp_len)) samples
    with each symbol's CP prepended.

    With spec.rolloff_len = r > 0 the first r samples of each CP ramp up
    on a raised cosine while the previous symbol's cyclic tail (the first r
    samples of its FFT body) ramps down into them; the flanks sum to 1 and
    stay inside the CP, so the frame length is unchanged.  The first symbol
    ramps up from zero."""
    with_cp = torch.cat([td_syms[..., -spec.cp_len:], td_syms], dim=-1)
    r = spec.rolloff_len
    if r > 0:
        up = _ramp(r, td_syms.device)
        tails = td_syms[..., :r] * (1.0 - up)
        prev_tails = torch.cat([torch.zeros_like(tails[..., :1, :]),
                                tails[..., :-1, :]], dim=-2)
        flank = with_cp[..., :r] * up + prev_tails
        with_cp = torch.cat([flank, with_cp[..., r:]], dim=-1)
    return with_cp.reshape(*td_syms.shape[:-2], -1)


def remove_cyclic_prefix(spec: OfdmSpec, samples: torch.Tensor,
                         n_syms: int) -> torch.Tensor:
    """Samples (..., n_syms * sym_len) -> (..., n_syms, fft_len), dropping
    each symbol's CP."""
    s = samples[..., : n_syms * spec.sym_len].reshape(
        *samples.shape[:-1], n_syms, spec.sym_len)
    return s[..., spec.cp_len:]
