"""Polyphase filterbank channelizer, critically sampled (counterpart of
tpu_ofdm/spectrum/channelizer.py).

Commutator -> N polyphase FIR arms -> N-point IDFT across arms, with the
reference's arm order (arm a at output m consumes x[m*N + (N-1-a)]; channel
k centred at k*fs/N; output scaled by N).  The streaming step runs the
fused CUDA kernel (kernels/pfb.py) and carries the last `stream_tail_len`
RAW samples, the JAX package's carry layout, so a carry saved by either
package resumes in the other; the one-shot `channelize` runs the same
kernel with a zero tail.  On the card a 1-D stream at a channel count the
kernel covers launches it, as in the JAX package; anything else takes the
JAX package's XLA chain in torch ops (commutator, shifted multiply-adds,
torch.fft.ifft), which is also what runs on the CPU (`channelize_route`).
The streaming step hands out the layout its caller asks for: (rows, N),
or channel-major (N, rows), which the kernel writes directly.

The numpy table functions (`lowpass_taps`, `polyphase_decompose`) and the
host-side synthesis filterbank are the reference's, re-implemented because
the JAX module imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_ofdm_torch.kernels import pfb
from tpu_ofdm_torch.kernels.pfb import (  # noqa: F401
    channelize_ext,
    commutator_rows,
)
from tpu_ofdm_torch.stream.block import Block


def lowpass_taps(n_chan: int, taps_per_arm: int = 8, beta: float = 9.0) -> np.ndarray:
    """Prototype lowpass: windowed sinc, cutoff fs/(2*n_chan), unity per-arm
    DC gain (the reference's and the golden model's)."""
    ntaps = n_chan * taps_per_arm
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n / n_chan) * np.kaiser(ntaps, beta)
    return (h / np.sum(h) * n_chan).astype(np.float32)


def polyphase_decompose(taps: np.ndarray, n_chan: int) -> np.ndarray:
    """taps -> (taps_per_arm, n_chan) polyphase matrix poly[j, arm]."""
    ntaps = len(taps)
    j = -(-ntaps // n_chan)
    tp = np.zeros(j * n_chan, dtype=np.float32)
    tp[:ntaps] = taps
    return tp.reshape(j, n_chan)


def device_poly(taps: np.ndarray, n_chan: int):
    """device -> the (J, n_chan) float32 polyphase matrix on that device,
    built once per device (the step never copies from the host)."""
    poly = polyphase_decompose(np.asarray(taps), n_chan)
    return functools.lru_cache(maxsize=None)(
        lambda device: torch.as_tensor(poly, device=device))


def channelize_route(device_type: str, ndim: int, n_chan: int) -> str:
    """How the channelizer runs a stream x of rank `ndim` on a device of
    this type, from the shape alone: "kernel" (a 1-D stream on the card at
    a channel count pfb covers) or "torch" (the chain in torch ops, where
    the JAX package takes its XLA chain, and always on the CPU)."""
    if device_type != "cpu" and ndim == 1 and pfb.supported(n_chan):
        return "kernel"
    return "torch"


def channelize(x: torch.Tensor, n_chan: int, taps: np.ndarray) -> torch.Tensor:
    """One-shot channelizer over a sample buffer (zero history), matching
    the golden model: (..., n_samples) -> (..., n_out, n_chan).  On the
    card a 1-D x at a channel count pfb covers runs the kernel with a zero
    tail."""
    poly = torch.as_tensor(polyphase_decompose(np.asarray(taps), n_chan),
                           device=x.device)
    if channelize_route(x.device.type, x.ndim, n_chan) == "kernel":
        n = x.shape[-1] // n_chan * n_chan
        return pfb.channelize_fused(x[:n].contiguous(), poly)
    rows = commutator_rows(x, n_chan)
    pad = rows.new_zeros((*rows.shape[:-2], poly.shape[0] - 1, n_chan))
    return channelize_ext(torch.cat([pad, rows], dim=-2), poly)


def stream_tail_len(n_chan: int, taps: np.ndarray) -> int:
    """Raw-sample streaming-carry length for channelize_stream (>= the
    (J-1)*n_chan FIR lookback)."""
    J = polyphase_decompose(np.asarray(taps), n_chan).shape[0]
    return pfb.tail_len(n_chan, J)


def channelize_stream(x: torch.Tensor, tail: torch.Tensor, n_chan: int,
                      poly: torch.Tensor, layout: str = "row"):
    """One streaming channelizer step with a RAW-SAMPLE tail carry.

    x: (block,) complex64, block % n_chan == 0; tail: the
    stream_tail_len samples immediately preceding x (zeros at stream
    start); poly: the (J, n_chan) float32 polyphase matrix on x's device.
    Returns (out, new_tail): out (block // n_chan, n_chan), or with layout
    "chan" its (n_chan, block // n_chan) transpose (pfb.channelize_fused's
    layouts, on either route); new_tail is a copy, so the caller may reuse
    x's memory."""
    if layout not in pfb.LAUNCH:
        raise ValueError(f"channelize_stream: layout {layout!r}, expected "
                         f"one of {sorted(pfb.LAUNCH)}")
    J = poly.shape[0]
    C = pfb.tail_len(n_chan, J)
    if channelize_route(x.device.type, x.ndim, n_chan) == "kernel":
        out = pfb.channelize_fused(x, poly, tail=tail, layout=layout)
    else:
        k = (J - 1) * n_chan
        hist = commutator_rows(tail[..., C - k:], n_chan)
        ext = torch.cat([hist, commutator_rows(x, n_chan)], dim=-2)
        out = channelize_ext(ext, poly)
        if layout == "chan":
            out = out.transpose(-1, -2).contiguous()
    n = x.shape[-1]
    if n >= C:
        new_tail = x[..., n - C:].clone()
    else:
        new_tail = torch.cat([tail, x], dim=-1)[..., -C:]
    return out, new_tail


def synthesize_wideband(chans: np.ndarray,
                        taps: np.ndarray | None = None) -> np.ndarray:
    """Synthesis filterbank (host-side numpy): per-channel baseband samples
    (M, n_chan) -> one wideband stream (M * n_chan,).  The dual of
    `channelize`; channels that are all-zero are skipped."""
    chans = np.asarray(chans)
    M, N = chans.shape
    active = np.nonzero(np.abs(chans).sum(axis=0))[0]
    return synthesize_bursts(
        M * N, N, [(int(k), 0, chans[:, k]) for k in active], taps=taps
    )


def synthesize_bursts(wide_len: int, n_chan: int, bursts,
                      taps: np.ndarray | None = None) -> np.ndarray:
    """Sparse synthesis filterbank: place per-channel bursts into one
    wideband stream (host-side numpy).

    bursts: iterable of (channel k, per-channel offset, complex samples).
    Each burst is upsampled by n_chan, shaped with the prototype lowpass
    (exact FFT-based linear convolution over just the burst's footprint),
    upconverted to k*fs/n_chan with ABSOLUTE-index phase, and summed.  Cost
    scales with the occupied samples, not the capture length."""
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    out = np.zeros(wide_len, np.complex128)
    for k, off, f in bursts:
        f = np.asarray(f)
        seg = np.zeros(len(f) * n_chan, np.complex128)
        seg[::n_chan] = f
        L = len(seg) + len(taps_np) - 1
        nfft = 1 << max(1, (L - 1).bit_length())
        s = np.fft.ifft(np.fft.fft(seg, nfft) * np.fft.fft(taps_np, nfft))[:L]
        pos = off * n_chan
        end = min(wide_len, pos + L)
        nn = np.arange(pos, end)
        out[pos:end] += s[: end - pos] * np.exp(2j * np.pi * k * nn / n_chan)
    return out.astype(np.complex64)


def channelizer_block(n_chan: int, taps: np.ndarray | None = None) -> Block:
    """Streaming channelizer Block: (block,) samples -> (n_out, n_chan)
    channel samples per step; carries a raw-sample overlap-save tail.
    Block size must be a multiple of n_chan."""
    taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
    poly = device_poly(taps_np, n_chan)
    C = stream_tail_len(n_chan, taps_np)

    def init(device):
        return torch.zeros(C, dtype=torch.complex64, device=device)

    def apply(tail, x):
        out, new_tail = channelize_stream(x, tail, n_chan, poly(x.device))
        return new_tail, out

    return Block(init, apply, f"pfb_channelizer({n_chan})")
