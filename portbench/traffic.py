"""The one generator of every traffic mix: a mix is a data file of
parameters under traffic/, read here.

Everything is drawn from the run's seed: payload bytes, frame numbers,
the order of the payload lengths, and the noise.  The lengths themselves
are one fixed multiset spread evenly over the mix's range, so every seed
does the same work in another order.  Frames come from the reference's
golden TX, never from the program; noise is made on the device with a
seeded generator, in one call for all blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import golden_ofdm as G
from portbench.reference.receiver import Spec


@dataclasses.dataclass
class Frame:
    channel: int        # 0 for a single-channel stream
    pos: int            # first sample of the frame (its CP), in its block
    payload: bytes
    frame_num: int
    samples: np.ndarray  # complex128, as the golden TX makes it


def seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds derived from the run's seed."""
    ss = np.random.SeedSequence(seed)
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> 1]


def payloads(rng, n: int, lo: int, hi: int) -> tuple[list[bytes], list[int]]:
    """n payloads whose lengths are lo..hi spread evenly, in a seeded
    order, with seeded bytes; and n seeded frame numbers (12 bits)."""
    lens = lo + (np.arange(n) * (hi - lo + 1)) // n
    lens = rng.permutation(lens)
    pays = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in lens]
    return pays, [int(v) for v in rng.integers(0, 4096, n)]


def golden(spec: Spec, payload: bytes, frame_num: int) -> np.ndarray:
    return G.tx_frame(spec.p, payload, frame_num)


def dense_layout(spec: Spec, block: int, n_frames: int, first: int):
    """Frame positions in a block, bench.py's layout: every frame whole
    inside the block, at the same offsets in every block."""
    gap = (block - 2 * spec.max_frame_len) // n_frames
    if gap <= spec.max_frame_len:
        raise ValueError("frames would overlap")
    return [first + j * gap for j in range(n_frames)]


def dense_frames(spec: Spec, rng, n_blocks: int, block: int, mix: dict):
    """[[Frame]] per block: mix["frames_per_block"] golden frames each."""
    n = mix["frames_per_block"]
    pos = dense_layout(spec, block, n, mix["first_offset"])
    pays, nums = payloads(rng, n * n_blocks, *mix["payload_bytes"])
    out = []
    for b in range(n_blocks):
        out.append([Frame(0, pos[j], pays[b * n + j], nums[b * n + j],
                          golden(spec, pays[b * n + j], nums[b * n + j]))
                    for j in range(n)])
    return out


def noise_blocks(n_blocks: int, n: int, rms: float, seed: int,
                 device) -> torch.Tensor:
    """(n_blocks, n) complex64 Gaussian noise of `rms` per axis."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((n_blocks, n, 2), generator=gen, device=device)
    return torch.view_as_complex(z.mul_(rms))


def add_segments(blocks: torch.Tensor, segs) -> None:
    """blocks[b, start : start + len(x)] += x for each (b, start, x), with
    one copy to the device and one index_add."""
    if not segs:
        return
    n = blocks.shape[-1]
    idx = np.concatenate([b * n + s + np.arange(len(x)) for b, s, x in segs])
    val = np.concatenate([x for _, _, x in segs]).astype(np.complex64)
    dev = blocks.device
    flat = torch.view_as_real(blocks.view(-1))
    flat.index_add_(0, torch.as_tensor(idx, device=dev),
                    torch.view_as_real(torch.as_tensor(val, device=dev)))


def burst(n_chan: int, k: int, off: int, f: np.ndarray, taps: np.ndarray):
    """(start, samples) of one channel burst through the synthesis
    filterbank: f upsampled by n_chan, shaped by the prototype lowpass and
    moved to k * fs / n_chan with the phase of its absolute index (the
    dual of the golden channelizer)."""
    seg = np.zeros(len(f) * n_chan, np.complex128)
    seg[::n_chan] = f
    s = np.convolve(seg, taps)
    start = off * n_chan
    nn = start + np.arange(len(s))
    return start, s * np.exp(2j * np.pi * k * (nn % n_chan) / n_chan)


def wideband_frames(spec: Spec, rng, n_blocks: int, mix: dict):
    """[[Frame]] per block: one golden frame on each of mix["channels"], at
    per-channel offset mix["offset"]."""
    chans = mix["channels"]
    pays, nums = payloads(rng, len(chans) * n_blocks, *mix["payload_bytes"])
    out = []
    for b in range(n_blocks):
        row = []
        for i, c in enumerate(chans):
            k = b * len(chans) + i
            row.append(Frame(c, mix["offset"], pays[k], nums[k],
                             golden(spec, pays[k], nums[k])))
        out.append(row)
    return out


def wideband_segments(frames, n_chan: int, taps: np.ndarray):
    """(block, start, samples) of every frame's burst; each frame is
    scaled by n_chan so that it leaves the channelizer at unit power."""
    segs = []
    for b, row in enumerate(frames):
        for f in row:
            start, s = burst(n_chan, f.channel, f.pos, f.samples * n_chan,
                             taps)
            segs.append((b, start, s))
    return segs
