"""BASELINE config 5: a wideband capture channelized and demodulated over a
(channel x time) mesh (counterpart of tpu_ofdm/shard/wideband.py).

Two stages a step:

  1. **Channelize, sharded over ALL shards.**  The flat wideband chunk is
     split into contiguous pieces over the flattened (channel, time) shard
     order; each shard channelizes its piece (spectrum.channelizer.
     channelize_stream: the pfb kernel on the card, for a 1-D piece at a
     channel count it covers) after fetching the stream_tail_len raw
     samples of its left neighbour with one ppermute ring step; shard 0
     takes the carried raw tail (zeros in the one-shot capture).
  2. **Demodulate, (channel x time) sharded.**  One all_to_all moves
     stage 1's time-major rows into the demod layout -- shard (c, t) takes
     channel group c of the pieces of time shard t -- and shard.rx's demod
     runs with its ownership tiling: every frame reported once, straddles
     included.  With the local communicator the all_to_all is slicing and
     a transpose.

Constraints (each raises ValueError): n_chan % mesh.channel == 0,
per_chan_shard % mesh.channel == 0 (a stage-1 piece is whole commutator
loads), per_chan_shard >= history_len, and a stage-1 piece of n_chan *
per_chan_shard / mesh.channel samples holds at least stream_tail_len
samples (the halo its right neighbour takes).

Entry points: sharded_wideband_capture_fn (one-shot capture, stream start
assumed), sharded_wideband_stream_block (the RESUMABLE streaming form:
raw-sample + channel-domain carries, checkpointable, exactly once across
chunk boundaries), and mesh_psd_step_fn (the distributed analyzer's
PSD-consensus step).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmSpec
from tpu_ofdm_torch.modem.rx_stream import history_len
# the carry (raw tail complex64 (C,), channel tail complex64 (n_chan, H),
# step int32) converts to and from the JAX package's as the unsharded
# wideband receiver's carry does: a dtype cast a leaf
from tpu_ofdm_torch.modem.wideband import (carry_from_jax,  # noqa: F401
                                           carry_to_jax)
from tpu_ofdm_torch.shard.distributed import gather_spectrum_shards
from tpu_ofdm_torch.shard.mesh import (AXES, CHANNEL_AXIS, TIME_AXIS, Mesh,
                                       split)
from tpu_ofdm_torch.shard.rx import (ShardedStreamOut, _origin, carry_rows,
                                     check_shards, collect_results,
                                     demod_shards)
from tpu_ofdm_torch.spectrum.channelizer import (channelize_stream,
                                                 device_poly, lowpass_taps,
                                                 stream_tail_len)
from tpu_ofdm_torch.spectrum.psd import psd_frames
from tpu_ofdm_torch.stream.block import Block


class _Stages:
    """The two stages over one mesh at one channel count and taps."""

    def __init__(self, mesh: Mesh, n_chan: int, taps):
        taps_np = lowpass_taps(n_chan) if taps is None else np.asarray(taps)
        self.mesh = mesh
        self.n_chan = n_chan
        self.poly = device_poly(taps_np, n_chan)
        self.C_tail = stream_tail_len(n_chan, taps_np)
        self.n_c = mesh.shape[CHANNEL_AXIS]
        self.n_t = mesh.shape[TIME_AXIS]
        self.n_dev = self.n_c * self.n_t
        if n_chan % self.n_c:
            raise ValueError(f"n_chan={n_chan} not divisible by mesh "
                             f"channel={self.n_c}")
        self.c_local = n_chan // self.n_c

    def check_piece(self, per_chan_shard: int) -> None:
        """A stage-1 piece is whole commutator loads and holds the raw halo
        its right neighbour takes."""
        if per_chan_shard % self.n_c:
            raise ValueError(f"per_chan_shard={per_chan_shard} not divisible"
                             f" by mesh channel={self.n_c} (stage-1 chunks "
                             "must hold whole commutator loads)")
        piece = self.n_chan * per_chan_shard // self.n_c
        if piece < self.C_tail:
            raise ValueError(f"stage-1 piece of {piece} samples is shorter "
                             f"than the channelizer tail {self.C_tail}")

    def channelize(self, x: torch.Tensor, raw_tail) -> list:
        """Stage 1: the flat chunk x -> per held shard its rows (L / n_chan,
        n_chan); shard 0's raw halo is raw_tail (None: zeros)."""
        comm = self.mesh.comm
        xs = split(x.to(torch.complex64), comm, (AXES,))
        C = self.C_tail
        tails = [p[p.shape[0] - C:] for p in xs]
        halos = comm.ppermute(tails, AXES,
                              [(i, i + 1) for i in range(self.n_dev - 1)])
        rows = []
        for i, p, h in zip(comm.shards, xs, halos):
            if i == 0 and raw_tail is not None:
                h = raw_tail.to(p.device)
            out, _ = channelize_stream(p, h, self.n_chan, self.poly(p.device))
            rows.append(out)
        return rows

    def to_demod_layout(self, rows: list) -> list:
        """Stage 2: all_to_all from stage 1's rows to per held shard (c, t)
        its (c_local, S) channel block: the channel group c of stage-1
        pieces t*n_c .. t*n_c + n_c - 1, in time order."""
        comm = self.mesh.comm
        n_c, n_t, cl = self.n_c, self.n_t, self.c_local
        routes = [(i, c * n_t + i // n_c)
                  for i in range(self.n_dev) for c in range(n_c)]
        pieces = [{c * n_t + i // n_c: r[:, c * cl:(c + 1) * cl].t()
                   for c in range(n_c)} for i, r in zip(comm.shards, rows)]
        r0 = rows[0]
        like = r0.new_empty((cl, r0.shape[0]))
        got = comm.all_to_all(pieces, routes, like)
        out = []
        for i, recv in zip(comm.shards, got):
            _, t = comm.coords(i)
            out.append(torch.cat([recv[t * n_c + j] for j in range(n_c)],
                                 dim=-1))
        return out


def mesh_psd_step_fn(
    mesh: Mesh,
    n_chan: int,
    nbins: int,
    taps: np.ndarray | None = None,
    window: str = "hann",
    floor: float = 1e-20,
):
    """The distributed analyzer's step: (tail, wideband block) -> ((n_chan,
    nbins) dB consensus PSD on this process's first shard, new tail).
    Returns (step, stream_tail_len).

    Per step: the sharded channelizer (stage 1, shard 0 taking the carried
    raw tail) -> the demod layout (stage 2) -> per shard the windowed PSD
    frames of its channels, summed in linear power (psd_frames: the psd
    kernel on the card at a covered nbins, one launch a shard) -> psum of
    the sums over time shards, divided by the step's frame count, to dB ->
    all_gather over the channel axis (shard.distributed, with its pmean
    over identical time shards).  The JAX package averages linear power over
    every frame before the dB conversion too.  The returned tail is the
    block's last stream_tail_len raw samples; thread it back in as the next
    step's carry.  The block length must be a multiple of n_chan * nbins *
    n_time (whole PSD frames a time shard) and of n_chan * mesh.size
    (equal stage-1 pieces)."""
    st = _Stages(mesh, n_chan, taps)
    comm = mesh.comm

    def step(tail, samples):
        n = samples.shape[-1]
        if n % (n_chan * nbins * st.n_t) or n % (n_chan * st.n_dev):
            raise ValueError(f"block of {n} samples: need a multiple of "
                             f"{n_chan * nbins * st.n_t} and of "
                             f"{n_chan * st.n_dev}")
        st.check_piece(n // n_chan // st.n_t)
        chans = st.to_demod_layout(st.channelize(samples, tail))
        sums = [psd_frames(ch, nbins, window).sum(dim=-2) for ch in chans]
        frames = (n // n_chan // nbins)
        total = comm.psum(sums, TIME_AXIS)
        db = [10.0 * torch.log10((s / frames).clamp(min=floor)) for s in total]
        full = gather_spectrum_shards(db, mesh)[0]
        return full, samples[n - st.C_tail:].to(torch.complex64).clone()

    return step, st.C_tail


def flatten_band(psd_cn: np.ndarray) -> np.ndarray:
    """(n_chan, nbins) per-channel PSD -> one full-band vector ordered by
    absolute frequency (host-side presentation): flat[i] covers
    -fs/2 + i*fs/(n_chan*nbins).  Channel k is centered at k*fs/n_chan
    (wrapped), each channel's bins are FFT-ordered; fftshift both axes,
    flatten, then roll half a channel (the lowest channel straddles the
    -fs/2 wrap, so the shifted grid starts at -fs/2 - fs/(2*n_chan))."""
    shifted = np.fft.fftshift(psd_cn, axes=0)     # channels by center freq
    shifted = np.fft.fftshift(shifted, axes=1)    # bins within each channel
    return np.roll(shifted.reshape(-1), -(psd_cn.shape[1] // 2))


def sharded_wideband_stream_block(
    spec: OfdmSpec,
    mesh: Mesh,
    n_chan: int,
    per_chan_shard: int,
    taps: np.ndarray | None = None,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
) -> Block:
    """RESUMABLE streaming config-5 wideband RX: an executor Block whose one
    step channelizes AND demodulates a flat (n_chan * n_time *
    per_chan_shard,) wideband chunk over the (channel x time) mesh.

    carry = (raw_tail, chan_tail, step):
      raw_tail  (stream_tail_len,) complex64 -- the raw wideband samples
                immediately preceding this chunk; shard 0 of the flattened
                (channel, time) order takes it as its channelizer halo, so
                the polyphase FIR state is continuous across chunks.  Raw
                samples, not kernel state: a carry saved on the card
                resumes on the CPU and the reverse, and the JAX package's
                carry is the same.
      chan_tail (n_chan, H) complex64 -- the last history_len
                channel-domain samples of the previous chunk; time shard 0
                takes it as its demod halo, exactly sharded_rx_stream_block's
                carry (with the dist communicator: this rank's channel
                rows), so shard t of chunk k owns channel-domain absolute
                [(k*n_time + t)*S - H, ... + S) and every frame is reported
                once however it straddles a chunk OR shard boundary.

    Both carries are explicit, so stream.checkpoint save_state / load_state
    work unchanged.  Collect outputs with shard.rx.
    collect_sharded_stream_frames (channel-domain abs_start)."""
    st = _Stages(mesh, n_chan, taps)
    S = per_chan_shard
    H = history_len(spec)
    K = max_frames_per_shard
    check_shards(n_chan, mesh, S, H)
    st.check_piece(S)
    rows = carry_rows(mesh, n_chan)
    origin = _origin(mesh, st.c_local)
    C = st.C_tail

    def init(device):
        return (
            torch.zeros(C, dtype=torch.complex64, device=device),
            torch.zeros((rows, H), dtype=torch.complex64, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
        )

    def apply(state, samples):  # samples: (n_chan * n_t * S,) flat wideband
        raw_tail, chan_tail, step = state
        chans = st.to_demod_layout(st.channelize(samples, raw_tail))
        results, new_tail = demod_shards(spec, mesh, chans, chan_tail, K,
                                         equalizer)
        out = ShardedStreamOut(collect_results(mesh, results), step,
                               origin(samples.device))
        n = samples.shape[-1]
        new_state = (samples[n - C:].to(torch.complex64).clone(),
                     new_tail.to(chan_tail.device), step + 1)
        return new_state, out

    return Block(init, apply, f"sharded_wideband_stream({n_chan}ch)",
                 latency=H * n_chan)


def sharded_wideband_capture_fn(
    spec: OfdmSpec,
    mesh: Mesh,
    n_chan: int,
    per_chan_shard: int,
    taps: np.ndarray | None = None,
    max_frames_per_shard: int = 8,
    equalizer: str = "pilot_phase",
):
    """Build the config-5 capture: (n_chan * n_time * per_chan_shard,)
    wideband complex64 -> RxBlockResult with leading (n_chan, n_time * K)
    axes (with the dist communicator: this rank's shard; collect with
    shard.rx.collect_sharded_frames).  The stream starts here: shard 0's
    raw halo and every channel's demod halo are zeros.

    per_chan_shard is S, each time shard's per-channel sample count; frame
    ownership / abs_start are sharded_rx_capture_fn's."""
    st = _Stages(mesh, n_chan, taps)
    S = per_chan_shard
    check_shards(n_chan, mesh, S, history_len(spec))
    st.check_piece(S)
    K = max_frames_per_shard

    def fn(samples):  # (n_chan * n_t * S,) global wideband
        if samples.shape[-1] != n_chan * st.n_t * S:
            raise ValueError(f"capture of {samples.shape[-1]} samples, "
                             f"expected {n_chan * st.n_t * S}")
        chans = st.to_demod_layout(st.channelize(samples, None))
        results, _ = demod_shards(spec, mesh, chans, None, K, equalizer)
        return collect_results(mesh, results)

    return fn
