"""Device meshes for channel x time sharding, and their collectives
(counterpart of tpu_ofdm/shard/mesh.py).

A mesh is a (n_channel, n_time) grid of shards with two axes:

  * ``channel`` -- data parallelism over channelizer outputs / independent
    streams (each shard demodulates its own subset of channels);
  * ``time``    -- sequence parallelism over a long capture, with
    overlap-save halos passed between neighbours (shard.halo).

Each shard names a `torch.device`, and the grid MAY REPEAT A DEVICE:
``make_mesh(4, 2, devices=[torch.device("cuda", 0)] * 8)`` is eight logical
shards on one card, which runs them in turn.  This is the counterpart of the
JAX package's tests on virtual host devices
(``--xla_force_host_platform_device_count``): the halos, ownership edges and
all_to_all of a multi-shard mesh run, and are checked, on one card or on the
CPU (``devices=[torch.device("cpu")] * n``).

Where JAX traces one program per device under ``shard_map``, a process here
holds a LIST of its shards and every sharded function maps lists to lists
(SPMD over a list).  The mesh's communicator decides which shards that list
holds and moves data between them:

  * `LocalComm` holds every shard of the mesh in this process;
  * `DistComm` (built by shard.distributed.global_mesh) holds one shard,
    this rank's, of a `torch.distributed` group with one rank per shard.

The collectives -- `ppermute` ring shifts, `all_gather`, `psum` / `pmean`
and `all_to_all` -- take one tensor per held shard, in the order of
`comm.shards`, and return one per held shard, so each sharded function is
written once and runs unchanged on either communicator.  `psum` and
`all_gather` combine every member of a group in the same order on both
communicators, so their results agree bit for bit.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"
AXES = (CHANNEL_AXIS, TIME_AXIS)


def balanced_factors(n: int) -> tuple[int, int]:
    """n -> (a, b) with a*b == n and a >= b as balanced as possible."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def _axes(axis) -> tuple[str, ...]:
    """An axis name or a tuple of them, in mesh order."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if axes not in ((CHANNEL_AXIS,), (TIME_AXIS,), AXES):
        raise ValueError(f"axis {axis!r}: expected {CHANNEL_AXIS!r}, "
                         f"{TIME_AXIS!r} or {AXES!r}")
    return axes


class Communicator:
    """Collectives over the shards of an (n_channel, n_time) mesh.

    `shards` are the flat indices (c * n_time + t) of the shards this
    process holds, ascending; `devices` the device of every flat index.
    Subclasses provide the two primitives: `_exchange` (point to point) and
    `_gather` (every shard's tensor, in flat order)."""

    def __init__(self, n_channel: int, n_time: int,
                 devices: Sequence[torch.device], shards: Sequence[int]):
        self.n_channel = n_channel
        self.n_time = n_time
        self.devices = list(devices)
        self.shards = list(shards)

    # -- geometry ----------------------------------------------------------
    def coords(self, i: int) -> tuple[int, int]:
        """Flat shard index -> (channel, time) coordinates."""
        return divmod(i, self.n_time)

    def members(self, i: int, axis) -> list[int]:
        """The flat indices of shard i's group along `axis`, in axis order."""
        c, t = self.coords(i)
        axes = _axes(axis)
        if axes == (TIME_AXIS,):
            return [c * self.n_time + u for u in range(self.n_time)]
        if axes == (CHANNEL_AXIS,):
            return [u * self.n_time + t for u in range(self.n_channel)]
        return list(range(self.n_channel * self.n_time))

    def holds_all(self) -> bool:
        return len(self.shards) == self.n_channel * self.n_time

    # -- primitives ----------------------------------------------------------
    def _exchange(self, routes, sends: dict, like) -> dict:
        """Send sends[(s, d)] from held shard s to shard d for each route
        (s, d) (the same list on every process); returns {(s, d): tensor}
        for the routes whose d is held, each received tensor shaped like
        like(d) and on shard d's device."""
        raise NotImplementedError

    def _gather(self, xs: list) -> list:
        """Every shard's tensor, in flat order (all shards hold tensors of
        one shape and dtype)."""
        raise NotImplementedError

    # -- collectives -----------------------------------------------------------
    def ppermute(self, xs: list, axis, perm) -> list:
        """jax.lax.ppermute: along `axis`, the shard at axis index s sends
        its tensor to index d for each (s, d) in perm; a shard that no pair
        names as destination receives zeros."""
        routes = []
        for i in range(self.n_channel * self.n_time):
            group = self.members(i, axis)
            if group[0] != i:
                continue                     # one pass per group
            routes += [(group[s], group[d]) for s, d in perm]
        mine = dict(zip(self.shards, xs))
        got = self._exchange(
            routes, {r: mine[r[0]] for r in routes if r[0] in mine},
            lambda d: mine[d])
        to = {d: x for (_, d), x in got.items()}
        return [to[i] if i in to else torch.zeros_like(x)
                for i, x in zip(self.shards, xs)]

    def all_to_all(self, pieces: list, routes, like) -> list:
        """Route pieces between shards: pieces[k][d] is what held shard k
        sends to flat shard d, for every route (k's index, d) in `routes`
        (the same list on every process).  Returns, per held shard, {source
        flat index: tensor}; every piece has the shape and dtype of `like`
        (a tensor)."""
        sends = {}
        for i, p in zip(self.shards, pieces):
            sends.update({(i, d): x for d, x in p.items()})
        got = self._exchange(routes, sends, lambda d: like)
        out = {i: {} for i in self.shards}
        for (s, d), x in got.items():
            out[d][s] = x
        return [out[i] for i in self.shards]

    def all_gather(self, xs: list, axis, dim: int = 0) -> list:
        """jax.lax.all_gather(..., tiled=True): the group's tensors along
        `axis`, concatenated along `dim` in axis order."""
        every = self._gather(xs)
        return [torch.cat([every[j].to(self.devices[i])
                           for j in self.members(i, axis)], dim=dim)
                for i in self.shards]

    def psum(self, xs: list, axis) -> list:
        """jax.lax.psum: the sum over the group along `axis` (or axes), in
        axis order."""
        every = self._gather(xs)
        out = []
        for i in self.shards:
            group = self.members(i, axis)
            total = every[group[0]].to(self.devices[i])
            for j in group[1:]:
                total = total + every[j].to(self.devices[i])
            out.append(total)
        return out

    def pmean(self, xs: list, axis) -> list:
        n = len(self.members(self.shards[0], axis))
        return [s / n for s in self.psum(xs, axis)]

    # -- a sharded output, as this process sees it ----------------------------------
    def collect(self, xs: list, spec) -> torch.Tensor:
        """The global array (all shards held) or this process's own shard
        (one held) of per-shard outputs laid out by `spec` (see split)."""
        if self.holds_all():
            return join(xs, self, spec)
        (x,) = xs
        return x

    def origin(self, rows_per_shard: int) -> tuple[int, int, int]:
        """(first channel row, first time shard, time shards) of what
        `collect` returns for an output of `rows_per_shard` channel rows a
        shard and one block of slots a time shard."""
        if self.holds_all():
            return 0, 0, self.n_time
        c, t = self.coords(self.shards[0])
        return c * rows_per_shard, t, 1


class LocalComm(Communicator):
    """Every shard in this process: a collective is slicing, concatenation
    and copies between the shards' devices (none where a device repeats)."""

    def __init__(self, n_channel: int, n_time: int,
                 devices: Sequence[torch.device]):
        super().__init__(n_channel, n_time, devices,
                         range(n_channel * n_time))

    def _exchange(self, routes, sends, like):
        return {(s, d): sends[(s, d)].to(self.devices[d]) for s, d in routes}

    def _gather(self, xs):
        return list(xs)


class Mesh:
    """A (n_channel, n_time) grid of shard devices and its communicator.
    `shape[CHANNEL_AXIS]` / `shape[TIME_AXIS]` read as in the JAX package;
    `devices` is the (n_channel, n_time) object array of torch.devices."""

    def __init__(self, devices: np.ndarray, comm: Communicator | None = None):
        self.devices = devices
        n_c, n_t = devices.shape
        self.shape = {CHANNEL_AXIS: n_c, TIME_AXIS: n_t}
        self.size = n_c * n_t
        self.comm = comm if comm is not None else LocalComm(
            n_c, n_t, list(devices.ravel()))

    def __repr__(self):
        return (f"Mesh({self.shape[CHANNEL_AXIS]}x{self.shape[TIME_AXIS]}, "
                f"{type(self.comm).__name__}, "
                f"{sorted({str(d) for d in self.devices.ravel()})})")


def _grid(devices, n_channel: int, n_time: int) -> np.ndarray:
    grid = np.empty(n_channel * n_time, dtype=object)
    for i, d in enumerate(devices[: n_channel * n_time]):
        grid[i] = torch.device(d)
    return grid.reshape(n_channel, n_time)


def make_mesh(n_channel: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Build a (channel, time) mesh over `devices` (default: every CUDA
    device; a mesh on the CPU is asked for by naming it, e.g. devices=
    [torch.device("cpu")] * 8).  A device may repeat.

    If n_channel is None it absorbs all devices not used by the time axis.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; name the devices "
                               "(e.g. [torch.device('cpu')] * n) for a mesh "
                               "elsewhere")
    devices = list(devices)
    n = len(devices)
    if n_channel is None:
        if n % n_time:
            raise ValueError(f"{n} devices not divisible by n_time={n_time}")
        n_channel = n // n_time
    if n_channel * n_time > n:
        raise ValueError(
            f"mesh {n_channel}x{n_time} needs {n_channel * n_time} devices, "
            f"have {n}")
    return Mesh(_grid(devices, n_channel, n_time))


def single_device_mesh(device="cuda") -> Mesh:
    """1x1 mesh on one device (lets sharded code paths run anywhere)."""
    return Mesh(_grid([device], 1, 1))


# ---------------------------------------------------------------------------
# Laying a global array over the shards and back
# ---------------------------------------------------------------------------


def _blocks(comm: Communicator, spec, i: int) -> list[tuple[int, int]]:
    """Per dimension of `spec`, (block index, block count) of shard i.
    A spec entry is None (whole, replicated), an axis name or AXES (the
    flattened (channel, time) order)."""
    c, t = comm.coords(i)
    out = []
    for entry in spec:
        if entry is None:
            out.append((0, 1))
            continue
        axes = _axes(entry)
        if axes == (CHANNEL_AXIS,):
            out.append((c, comm.n_channel))
        elif axes == (TIME_AXIS,):
            out.append((t, comm.n_time))
        else:
            out.append((i, comm.n_channel * comm.n_time))
    return out


def split(x: torch.Tensor, comm: Communicator, spec) -> list[torch.Tensor]:
    """The held shards' blocks of x laid out by `spec` (one entry per
    leading dimension; see _blocks), each contiguous on its shard's
    device.  Every dimension a spec entry splits must divide evenly."""
    out = []
    for i in comm.shards:
        idx = []
        for dim, (b, n) in enumerate(_blocks(comm, spec, i)):
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not split into {n} shards")
            idx.append(slice(b * size // n, (b + 1) * size // n))
        out.append(x[tuple(idx)].to(comm.devices[i]).contiguous())
    return out


def join(xs: list, comm: Communicator, spec) -> torch.Tensor:
    """The inverse of split over every shard of the mesh, on the first
    shard's device; a block held by several shards (replicated over an
    axis the spec does not name) is taken from the first."""
    pieces = {}
    for i, x in zip(comm.shards, xs):
        key = tuple(b for b, _ in _blocks(comm, spec, i))
        pieces.setdefault(key, x.to(comm.devices[comm.shards[0]]))
    counts = [n for _, n in _blocks(comm, spec, comm.shards[0])]

    def cat(prefix):
        dim = len(prefix)
        if dim == len(counts):
            return pieces[prefix]
        return torch.cat([cat(prefix + (b,)) for b in range(counts[dim])],
                         dim=dim)

    return cat(())
