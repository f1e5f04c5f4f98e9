"""Sharded OFDM RX over a (channel x time) mesh (counterpart of
tpu_ofdm/shard/rx.py).

  * channel axis: data parallelism -- each shard demodulates its own subset
    of channels, batched: one rx_block over its (c_local, S) block.
  * time axis: sequence parallelism over a long capture -- each shard works
    on the virtual buffer [left halo | local] (overlap-save, shard.halo) and
    OWNS the detections whose start falls in its tiling window, so every
    frame is reported by exactly one shard however it straddles a shard
    boundary.

The ownership tiling matches modem.rx_stream: shard t's virtual buffer is
[H halo | S local] with position 0 at absolute t*S - H, and it owns
positions [0, S) = absolute [t*S - H, (t+1)*S - H).  rx_block reads the halo
and the block in place (one sc_detect and one gather launch a shard), as
the JAX rx_block does on their concatenation.  S >= H is required: a
shard's halo is the last H samples of its left neighbour.

Outputs: with the local communicator the per-shard results are assembled
into the JAX package's global layout, leading (C, T*K) axes; with the dist
communicator each rank returns its own (c_local, K) shard, and
ShardedStreamOut.origin (or the `origin` argument of
collect_sharded_frames) places it in global channel and time-shard
coordinates.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec
from tpu_ofdm_torch.modem import sink
from tpu_ofdm_torch.modem.rx import RxBlockResult, rx_block
# the carry (tail complex64 (C, H), step int32) converts to and from the
# JAX package's as the receiver's carry does: a dtype cast a leaf
from tpu_ofdm_torch.modem.rx_stream import (carry_from_jax,  # noqa: F401
                                            carry_to_jax, history_len)
from tpu_ofdm_torch.shard.halo import halo_from_left
from tpu_ofdm_torch.shard.mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, split
from tpu_ofdm_torch.stream.block import Block
from tpu_ofdm_torch.stream.executor import tree_map

# result leaves lead with (channel rows, time shards * K slots)
RESULT_SPEC = (CHANNEL_AXIS, TIME_AXIS)


def check_shards(n_channels: int, mesh: Mesh, shard_len: int, H: int) -> int:
    """Raise ValueError unless the channels split evenly over the channel
    axis and each time shard holds at least the H-sample halo its right
    neighbour takes from it; returns the channels a shard."""
    n_c = mesh.shape[CHANNEL_AXIS]
    if n_channels % n_c:
        raise ValueError(f"{n_channels} channels not divisible by mesh "
                         f"channel={n_c}")
    if shard_len < H:
        raise ValueError(f"shard_len={shard_len} is shorter than the "
                         f"history H={H} a shard passes to its right "
                         "neighbour")
    return n_channels // n_c


def demod_shards(spec: OfdmSpec, mesh: Mesh, xs: list, tail, K: int,
                 equalizer: str):
    """One step of the (channel x time) demod over this process's shards
    xs, each (c_local, S) contiguous on its device.  Time shard 0 takes its
    halo from `tail` (the process's carry rows (rows, H), one block of
    c_local rows per held channel group in order; None: zeros), the others
    from their left neighbour.  Returns (per-shard RxBlockResults, new
    carry rows: the last H samples of each channel group's last time shard,
    moved to its time shard 0)."""
    comm = mesh.comm
    H = history_len(spec)
    n_t = mesh.shape[TIME_AXIS]
    groups = sorted({comm.coords(i)[0] for i in comm.shards})
    halos = halo_from_left(xs, H, mesh)
    results = []
    for i, x, halo in zip(comm.shards, xs, halos):
        c, t = comm.coords(i)
        if t == 0 and tail is not None:
            c_local = x.shape[0]
            g = groups.index(c)
            halo = tail[g * c_local:(g + 1) * c_local].to(x.device)
        results.append(rx_block(spec, x, K, own_lo=0, own_hi=x.shape[-1],
                                head=halo.contiguous(), equalizer=equalizer))
    ends = comm.ppermute([x[:, x.shape[-1] - H:] for x in xs], TIME_AXIS,
                         [(n_t - 1, 0)])
    first = {}
    for i, e in zip(comm.shards, ends):
        first.setdefault(comm.coords(i)[0], e)
    new_tail = torch.cat([first[c] for c in groups], dim=0)
    return results, new_tail


def collect_results(mesh: Mesh, results: list) -> RxBlockResult:
    """Per-shard results -> the global layout (local communicator) or this
    rank's own shard (dist communicator)."""
    return tree_map(lambda *leaves: mesh.comm.collect(list(leaves),
                                                      RESULT_SPEC), *results)


def sharded_rx_capture_fn(
    spec: OfdmSpec,
    mesh: Mesh,
    shard_len: int,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
):
    """Build the sharded-capture RX: (C, T*shard_len) complex64 -> an
    RxBlockResult with leading (C, T*K) axes (with the dist communicator:
    this rank's (C/n_channel, K) shard).  Shard 0's halo is zeros (stream
    start).

    C must be divisible by the mesh's channel axis and the capture by T
    time shards of shard_len >= history_len samples."""
    H = history_len(spec)
    K = max_frames_per_shard

    def fn(samples):
        check_shards(samples.shape[0], mesh, shard_len, H)
        if samples.shape[-1] != mesh.shape[TIME_AXIS] * shard_len:
            raise ValueError(f"capture of {samples.shape[-1]} samples, "
                             f"expected {mesh.shape[TIME_AXIS]} x {shard_len}")
        xs = split(samples.to(torch.complex64), mesh.comm, RESULT_SPEC)
        results, _ = demod_shards(spec, mesh, xs, None, K, equalizer)
        return collect_results(mesh, results)

    return fn


class ShardedStreamOut(NamedTuple):
    result: RxBlockResult     # frame slots, leading (rows, time shards * K)
    chunk_index: torch.Tensor  # () int32 chunks processed before this one
    origin: torch.Tensor       # (3,) int32: the result's first channel, its
    #   first time shard and its number of time shards (0, 0, T with the
    #   local communicator; a rank's (c * c_local, t, 1) with the dist one)


def _origin(mesh: Mesh, c_local: int):
    """device -> the constant origin tensor of this process's outputs."""
    origin = np.asarray(mesh.comm.origin(c_local), dtype=np.int32)
    return functools.lru_cache(maxsize=None)(
        lambda device: torch.as_tensor(origin, device=device))


def carry_rows(mesh: Mesh, n_channels: int) -> int:
    """Rows of this process's channel-domain carry: c_local for each
    channel group it holds (all n_channels with the local communicator)."""
    groups = {mesh.comm.coords(i)[0] for i in mesh.comm.shards}
    return len(groups) * n_channels // mesh.shape[CHANNEL_AXIS]


def sharded_rx_stream_block(
    spec: OfdmSpec,
    mesh: Mesh,
    n_channels: int,
    shard_len: int,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
) -> Block:
    """RESUMABLE sharded streaming RX: an executor Block whose one step
    demodulates a (C, T*shard_len) chunk over the (channel x time) mesh.

    carry = (tail, step): `tail` is the last H = history_len samples of the
    previous chunk per channel, (C, H) complex64 (with the dist
    communicator, this rank's channel rows; only time shard 0 reads it).
    Inside the chunk every time shard fetches its left halo by ppermute
    (shard.halo); shard 0 -- which has no left neighbour -- takes the carry
    instead, so the ownership tiling of modem.rx_stream extends across
    chunks: shard t of chunk k owns absolute [(k*T + t)*S - H, (k*T + t)*S
    - H + S), every frame reported exactly once however it straddles a chunk
    boundary.  The carry is explicit, so stream.checkpoint save_state /
    load_state work unchanged, and carry_from_jax / carry_to_jax convert
    the JAX package's."""
    H = history_len(spec)
    K = max_frames_per_shard
    c_local = check_shards(n_channels, mesh, shard_len, H)
    rows = carry_rows(mesh, n_channels)
    origin = _origin(mesh, c_local)

    def init(device):
        return (torch.zeros((rows, H), dtype=torch.complex64, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def apply(state, samples):  # samples: (C, T*S) global
        tail, step = state
        xs = split(samples.to(torch.complex64), mesh.comm, RESULT_SPEC)
        results, new_tail = demod_shards(spec, mesh, xs, tail, K, equalizer)
        out = ShardedStreamOut(collect_results(mesh, results), step,
                               origin(samples.device))
        return (new_tail.to(tail.device), step + 1), out

    return Block(init, apply, f"sharded_rx_stream({n_channels}ch)", latency=H)


# the keys of the sharded sinks' frame dicts
_KEYS = ("channel", "payload", "payload_len", "frame_num", "crc_ok", "evm",
         "abs_start")


def collect_sharded_stream_frames(outs, shard_len: int, spec: OfdmSpec,
                                  n_time: int):
    """Flatten ShardedStreamOut chunks into frame dicts with ABSOLUTE start
    positions in the global per-channel stream (host-side PDU sink,
    modem.sink), sorted by channel and start; n_time is the mesh's time
    shards.  Each out's origin places its rows and slots."""
    H = history_len(spec)
    frames = sink.collect(
        ((o.result, o.chunk_index, o.origin) for o in outs), _KEYS,
        lambda step, t: (step * n_time + t) * shard_len - H)
    frames.sort(key=lambda d: (d["channel"], d["abs_start"]))
    return frames


def collect_sharded_frames(res: RxBlockResult, shard_len: int,
                           spec: OfdmSpec, n_time: int,
                           origin: tuple[int, int] = (0, 0)):
    """Flatten a sharded-capture result into per-channel frame dicts with
    absolute start positions (host-side PDU sink equivalent, modem.sink).
    n_time is the number of time shards the result covers; `origin` is its
    first channel and first time shard (a dist rank's own shard: n_time 1
    and its (c * c_local, t))."""
    H = history_len(spec)
    return sink.collect(
        [(res, None, (*origin, n_time))], _KEYS,
        lambda step, t: t * shard_len - H)
