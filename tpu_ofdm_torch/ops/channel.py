"""Channel models for loopback testing (counterpart of
tpu_ofdm/ops/channel.py): AWGN, carrier frequency offset and static phase,
multipath FIR, integer timing offset.

Noise comes from an explicit `torch.Generator` on the samples' device.  The
JAX package draws from `jax.random`, whose bits torch cannot reproduce, so
with noise the two agree in distribution only; without noise they agree to
float32 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmConfig
from tpu_ofdm_torch.stream.block import Block


def awgn(gen: torch.Generator, x: torch.Tensor, snr_db: float,
         signal_power: torch.Tensor | float | None = None) -> torch.Tensor:
    """Add complex white Gaussian noise at snr_db against signal_power
    (measured from x when None); `gen` lives on x's device."""
    if signal_power is None:
        signal_power = (x.abs() ** 2).mean()
    noise_pow = signal_power / 10.0 ** (snr_db / 10.0)
    z = torch.randn((*x.shape, 2), generator=gen, device=x.device)
    return (x + torch.view_as_complex(z) * (noise_pow / 2.0) ** 0.5).to(
        torch.complex64)


def _rotate(x: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    return (x * torch.complex(torch.cos(ph), torch.sin(ph))).to(
        torch.complex64)


def apply_cfo(x: torch.Tensor, cfo_subcarriers: float, fft_len: int,
              phase: float = 0.0) -> torch.Tensor:
    """Multiply by exp(j (2 pi cfo n / N + phase)) along the last axis
    (float32 phase, in the JAX package's order)."""
    n = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    return _rotate(x, 2.0 * math.pi * cfo_subcarriers * n / fft_len + phase)


def multipath(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR multipath y[n] = sum_k taps[k] x[n-k], same length as x;
    taps an array-like or a complex64 tensor on x's device."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.as_tensor(np.asarray(taps, np.complex64),
                               device=x.device)
    k = taps.shape[0]
    n = x.shape[-1]
    xp = torch.cat([x.new_zeros((*x.shape[:-1], k - 1)), x], dim=-1)
    y = taps[k - 1] * xp[..., :n]
    for j in range(k - 2, -1, -1):
        y = y + taps[j] * xp[..., k - 1 - j: k - 1 - j + n]
    return y.to(torch.complex64)


def timing_offset(x: torch.Tensor, delay: int) -> torch.Tensor:
    """Prepend `delay` zero samples (the array grows)."""
    if delay == 0:
        return x
    return torch.cat([x.new_zeros((*x.shape[:-1], delay)), x], dim=-1)


def ofdm_signal_power(spec) -> float:
    """Per-sample TX power of this modem's OFDM frames: n_occupied unit
    carriers over fft_len bins, times the TX scale squared."""
    return float(spec.n_occupied) / float(spec.fft_len) * float(
        getattr(spec, "scale", 1.0)) ** 2


def channel_model(gen: torch.Generator | None, x: torch.Tensor,
                  snr_db: float | None = None, cfo: float = 0.0,
                  fft_len: int = 64, taps=None, delay: int = 0,
                  phase: float = 0.0) -> torch.Tensor:
    """Multipath -> CFO and phase -> delay -> AWGN, in the golden model's
    order; the SNR is against the clean input's power.  `gen` may be None
    when snr_db is None."""
    sig_pow = (x.abs() ** 2).mean()
    y = x if taps is None else multipath(x, taps)
    y = timing_offset(apply_cfo(y, cfo, fft_len, phase), delay)
    if snr_db is not None:
        y = awgn(gen, y, snr_db, signal_power=sig_pow)
    return y


def channel_block(seed: int = 0, snr_db: float | None = None,
                  cfo: float = 0.0, fft_len: int = 64, taps=None,
                  phase: float = 0.0,
                  signal_power: float | str = "ofdm") -> Block:
    """Streaming channel_model for 1-D sample streams.

    carry = (torch.Generator seeded from `seed` on the stream's device,
    CFO phase () float32 in radians, multipath history (len(taps) - 1,)
    complex64), so the rotation and the FIR continue across block seams.
    The generator advances in place as noise is drawn.  AWGN is sized
    against a static `signal_power` ("ofdm": ofdm_signal_power of the
    default carrier map at this fft_len), since a block may be mostly
    silence."""
    if signal_power == "ofdm":
        signal_power = ofdm_signal_power(OfdmConfig(fft_len=fft_len).spec)
    taps_np = None if taps is None else np.asarray(taps, np.complex64)
    k_hist = 0 if taps_np is None else len(taps_np) - 1
    w = float(np.float32(2.0 * np.pi * cfo / fft_len))
    taps_on = {}  # device -> taps tensor, copied to the device once

    def init(device):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return (gen, torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros(k_hist, dtype=torch.complex64, device=device))

    def apply(state, x):
        if x.ndim != 1:
            raise ValueError("channel_block takes a 1-D sample stream; use "
                             "channel_model for batches")
        gen, ph0, hist = state
        y = x
        if taps_np is not None:
            if x.device not in taps_on:
                taps_on[x.device] = torch.as_tensor(taps_np, device=x.device)
            ext = torch.cat([hist, y])
            y = multipath(ext, taps_on[x.device])[k_hist:]
            hist = ext[-k_hist:] if k_hist else hist
        n = torch.arange(y.shape[-1], dtype=torch.float32, device=y.device)
        y = _rotate(y, w * n + ph0 + phase)
        ph1 = torch.remainder(ph0 + w * y.shape[-1], 2.0 * math.pi)
        if snr_db is not None:
            y = awgn(gen, y, snr_db, signal_power=signal_power)
        return (gen, ph1, hist), y

    return Block(init, apply, "channel_model")


def carry_from_jax(state, device, seed: int = 0):
    """The JAX channel_block's carry (key, phase, history) -> this
    package's carry on `device`.  Phase and history carry over exactly; the
    JAX PRNG key cannot be turned into a torch.Generator, so the noise
    restarts from a generator seeded with `seed`."""
    _, phase, hist = state
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (gen,
            torch.tensor(np.asarray(phase, dtype=np.float32), device=device),
            torch.tensor(np.asarray(hist, dtype=np.complex64), device=device))
