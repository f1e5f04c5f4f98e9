"""OFDM receiver: detect frames in a sample buffer and demodulate every
frame slot (counterpart of tpu_ofdm/modem/rx.py).

The static two-pass design of the JAX package carries over:

  pass 1: detect up to K frame starts (ops.sync.detect_frames),
  pass 2: gather a fixed-capacity window per slot (kernels.gather), derotate,
          FFT the whole frame, estimate/equalize, parse the header, demap
          the payload bytes under masks derived from the header length.

Where JAX vmapped a one-frame `demod_frame` over the slots, `demod_frame`
here is written for a batch (K, ...) of slots; every reduction runs over
one slot's own axes.  Everything is fixed capacity plus validity masks, so
the whole block is enqueued on the device without waiting on the host.

`equalizer` is "pilot_phase" (the default) or "simpledfe"; `output` is
"hard" (the default) or "soft", which adds max-log LLRs of the payload bits
scaled by each frame's post-equalization noise estimate (EVM^2), computed
on the device.

rx_block also takes a batch of B buffers (B, n) -- the wideband receiver's
channels, which the JAX package vmaps over -- and then every result field
leads with (B, K).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_ofdm_torch.config import HEADER_BITS, OfdmSpec
from tpu_ofdm_torch.kernels.gather import gather_windows
from tpu_ofdm_torch.ops import carrier_alloc
from tpu_ofdm_torch.ops.chanest import coarse_int_cfo, ls_estimate, roll_bins
from tpu_ofdm_torch.ops.constellation import demap_hard, demap_soft
from tpu_ofdm_torch.ops.constellation import evm as evm_op
from tpu_ofdm_torch.ops.crc import check_crc32
from tpu_ofdm_torch.ops.equalizer import (equalize_pilot_phase,
                                          equalize_simpledfe)
from tpu_ofdm_torch.ops.header import parse_header_bits
from tpu_ofdm_torch.ops.sync import derotate, detect_frames
from tpu_ofdm_torch.ops.transform import ofdm_fft
from tpu_ofdm_torch.utils import metrics
from tpu_ofdm_torch.utils.bits import bits_to_bytes


class FrameResult(NamedTuple):
    payload: torch.Tensor      # (K, max_payload_bytes) uint8 wire bytes (incl CRC)
    payload_len: torch.Tensor  # (K,) int32: payload bytes EXCL. CRC32 (wire-4)
    frame_num: torch.Tensor    # (K,) int32
    hdr_ok: torch.Tensor       # (K,) bool: header CRC8 passed
    crc_ok: torch.Tensor       # (K,) bool: payload CRC32 passed
    evm: torch.Tensor          # (K,) float32: payload EVM vs hard decisions
    int_cfo: torch.Tensor      # (K,) int32
    data_syms: torch.Tensor    # (K, sym_capacity) complex64 equalized payload
    sym_mask: torch.Tensor     # (K, sym_capacity) bool: valid payload symbols
    sync_q: torch.Tensor       # (K,) float32: sync1 spectral-support quality
    sync_ok: torch.Tensor      # (K,) bool: sync_q above acquisition threshold
    llr: torch.Tensor          # (K, sym_capacity*bps) float32 max-log LLRs of
    #   the payload bits (positive => bit 0; 0 beyond the wire bits), scaled
    #   by the frame's EVM^2; (K, 0) when output="hard"


@functools.lru_cache(maxsize=64)
def _bins(spec: OfdmSpec, device: torch.device):
    return (torch.as_tensor(spec.sync1_bins, device=device),
            torch.as_tensor(spec.occupied_bins, device=device))


EQUALIZERS = ("pilot_phase", "simpledfe")
OUTPUTS = ("hard", "soft")


def _check_options(equalizer: str, output: str) -> None:
    if equalizer not in EQUALIZERS or output not in OUTPUTS:
        raise ValueError(f"equalizer {equalizer!r} / output {output!r}: "
                         f"expected one of {EQUALIZERS} / {OUTPUTS}")


def demod_frame(spec: OfdmSpec, frames: torch.Tensor,
                equalizer: str = "pilot_phase",
                output: str = "hard") -> FrameResult:
    """Demodulate a batch of start-aligned, CFO-derotated frame windows
    (K, >= max_frame_len) complex64.

    frames[k, 0] is the detected FFT-window start of sync word 1 (a few
    samples inside its CP; the circular shift this causes is absorbed into
    the channel estimate as a linear phase)."""
    _check_options(equalizer, output)
    K = frames.shape[0]
    dev = frames.device
    n_syms = spec.max_frame_ofdm_syms
    wins = frames[:, : n_syms * spec.sym_len].reshape(K, n_syms, spec.sym_len)
    grids = ofdm_fft(wins[..., : spec.fft_len])                 # (K, S, N)

    ic = coarse_int_cfo(spec, grids[:, 0])                      # (K,)
    grids = roll_bins(grids, ic)                                # undo +ic shift

    # Frame-acquisition gate: sync word 1 occupies ONLY the even occupied
    # bins, so symbol-0 energy concentrated there (~1) separates a true
    # preamble from a mid-frame or noise window (~0.5).
    s1_bins, occ_bins = _bins(spec, dev)
    g0 = grids[:, 0]
    e_on = (g0[:, s1_bins].abs() ** 2).sum(-1)
    e_occ = (g0[:, occ_bins].abs() ** 2).sum(-1)
    sync_q = e_on / e_occ.clamp(min=1e-12)
    sync_ok = (sync_q > 0.75) & (e_occ > 1e-9)

    H = ls_estimate(spec, grids[:, 1])                          # (K, N)

    hdr_eq = equalize_pilot_phase(spec, grids[:, 2:3], H)       # (K, 1, N)
    hdr_syms = carrier_alloc.serialize(spec, hdr_eq)            # (K, n_data)
    hdr_bits = demap_hard(hdr_syms[:, :HEADER_BITS], "bpsk")
    wire_len, fnum, hdr_ok = parse_header_bits(hdr_bits)
    cap = spec.max_payload_bytes
    wire_len = wire_len.clamp(0, cap)

    equalize = (equalize_simpledfe if equalizer == "simpledfe"
                else equalize_pilot_phase)
    pay_eq = equalize(spec, grids[:, 3:], H)                    # (K, P, N)
    syms = carrier_alloc.serialize(spec, pay_eq)                # (K, sym_cap)

    bps = spec.bits_per_symbol
    wire_bits = wire_len[:, None] * 8
    n_mod_syms = (wire_bits + bps - 1) // bps
    sym_cap = syms.shape[1]
    sym_mask = torch.arange(sym_cap, device=dev) < n_mod_syms

    bits = demap_hard(syms, spec.modulation)                    # (K, sym_cap*bps)
    bits = torch.where(torch.arange(bits.shape[1], device=dev) < wire_bits,
                       bits, 0)
    wire = bits_to_bytes(bits)[:, :cap]
    wire = torch.where(torch.arange(cap, device=dev) < wire_len[:, None],
                       wire, 0)

    crc_ok = check_crc32(wire, wire_len) & hdr_ok & sync_ok
    e = evm_op(syms, spec.modulation, mask=sym_mask)

    if output == "soft":
        noise_var = (e.to(torch.float32) ** 2).clamp(min=1e-6)
        llr = demap_soft(syms, spec.modulation, noise_var)
        llr = torch.where(torch.arange(llr.shape[1], device=dev) < wire_bits,
                          llr, 0.0)
    else:
        llr = torch.zeros((K, 0), dtype=torch.float32, device=dev)

    return FrameResult(
        payload=wire,
        payload_len=(wire_len - 4).clamp(min=0),
        frame_num=fnum,
        hdr_ok=hdr_ok,
        crc_ok=crc_ok,
        evm=e.to(torch.float32),
        int_cfo=ic,
        data_syms=syms,
        sym_mask=sym_mask,
        sync_q=sync_q.to(torch.float32),
        sync_ok=sync_ok,
        llr=llr,
    )


class RxBlockResult(NamedTuple):
    frames: FrameResult      # batched over ([B,] K) slots
    starts: torch.Tensor     # ([B,] K) int32 start index in the virtual buffer
    fine_cfo: torch.Tensor   # ([B,] K) float32
    valid: torch.Tensor      # ([B,] K) bool: slot holds an accepted detection


def rx_block(
    spec: OfdmSpec,
    x: torch.Tensor,
    max_frames: int,
    own_lo: int = 0,
    own_hi: int | None = None,
    head: torch.Tensor | None = None,
    equalizer: str = "pilot_phase",
    output: str = "hard",
) -> RxBlockResult:
    """Detect and demodulate up to `max_frames` frames in the virtual
    buffer [head | x] (complex64; x (n,) with head (h,), or a batch x
    (B, n) with head (B, h); head None for x alone), without building the
    concatenation: detection and the slot-window gather both read the two
    pieces in place.  Same semantics as the JAX rx_block on
    concat([head, x]) (vmapped over the batch); all positions are virtual
    coordinates.

    Ownership window [own_lo, own_hi): only detections whose start falls in
    it are accepted (the streaming receiver's exactly-once rule).
    `equalizer` and `output` as in demod_frame."""
    _check_options(equalizer, output)
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    if own_hi is None:
        own_hi = nv
    with metrics.span("rx.detect"):
        det = detect_frames(spec, x, max_frames, head=head)
    with metrics.span("rx.demod"):
        owned = det.valid & (det.start >= own_lo) & (det.start < own_hi)
        F = spec.max_frame_len
        # clamp so invalid slots still gather in range
        gstart = det.start.clamp(0, max(nv - F, 0))
        wins = derotate(gather_windows(x, gstart, F, head=head),
                        det.fine_cfo, spec.fft_len)
        lead = wins.shape[:-1]                      # ([B,] K)
        flat = demod_frame(spec, wins.reshape(-1, F), equalizer, output)
        frames = FrameResult(*(f.reshape(*lead, *f.shape[1:]) for f in flat))
        # a slot is valid only if owned AND acquisition confirmed AND
        # header ok
        valid = owned & frames.sync_ok & frames.hdr_ok
    metrics.count("rx.slots", lead.numel())
    return RxBlockResult(frames, det.start, det.fine_cfo, valid)
