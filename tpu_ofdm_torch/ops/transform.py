"""FFT demodulation (counterpart of tpu_ofdm/ops/transform.py, RX side).

The JAX package ran its FFT as a matmul DFT because jnp.fft did not lower on
its TPU stack; here torch.fft does the transform.  Normalization matches the
golden model: fft / sqrt(N) on RX.
"""

from __future__ import annotations

import math

import torch


def ofdm_fft(symbols: torch.Tensor) -> torch.Tensor:
    """Time-domain symbols (..., fft_len) -> freq grids, scaled by
    1/sqrt(N); complex64."""
    n = symbols.shape[-1]
    return torch.fft.fft(symbols) / math.sqrt(n)
