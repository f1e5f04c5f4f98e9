"""Multi-process runtime: process init, control plane, aggregation
(counterpart of tpu_ofdm/shard/distributed.py).

  * `initialize()` brings up `torch.distributed` (NCCL for tensors on the
    card, gloo for tensors on the CPU, and a gloo group for host control);
    `global_mesh()` then lays one shard on each rank, with a `DistComm`.
  * `broadcast_control()` carries the analyzer's control messages (retune /
    reset / gain): an io.pmt-serializable value broadcast from rank 0 in the
    JAX package's wire format (a 4-byte little-endian length, the pmt bytes,
    zero padding to `capacity`).
  * `LinkCounters` + `psum_tree()` aggregate link metrics over the whole
    mesh with one psum.
  * `all_gather_spectrum()` gives every shard the full-band PSD from
    channel-sharded rows.
  * `MeshHeartbeat` is the failure detector: every process publishes a
    monotonic progress count; one all_gather per beat lets every process see
    every other's progress.

Everything here also runs on a mesh whose shards are all in one process
(shard.mesh.LocalComm); the host-side helpers are then identities.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_ofdm_torch.shard.mesh import (AXES, CHANNEL_AXIS, TIME_AXIS,
                                       Communicator, Mesh, make_mesh, split)
from tpu_ofdm_torch.stream.executor import tree_map

# ---------------------------------------------------------------------------
# Process bring-up
# ---------------------------------------------------------------------------

# what initialize() set up: this rank's device and the gloo group for host
# control (None: the default group, when that is gloo itself)
_RUNTIME: dict = {}


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    **kw,
) -> None:
    """Bring up the multi-process runtime (torch.distributed).

    Call once per process.  With no arguments, initialization is attempted
    from the environment (MASTER_ADDR, WORLD_SIZE and RANK, as torchrun
    sets them); a single-process run without them is left alone, so apps
    may call this unconditionally.  `coordinator_address` is "host:port"
    (TCP) or a URL ("tcp://...", "file://...").  `device` is where this
    rank's shard lives: a CUDA device (the default; its index is LOCAL_RANK
    or the rank modulo the card count where none is given) selects NCCL
    for tensors, "cpu" gloo.  A failed NCCL initialization raises."""
    if dist.is_initialized():
        return
    has_env = all(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE",
                                            "RANK"))
    if coordinator_address is None and num_processes is None and not has_env:
        return  # single-process run, nothing to do
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = _rank_cuda_device(process_id if process_id is not None
                                    else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes if num_processes
                            is not None else -1,
                            rank=process_id if process_id is not None else -1,
                            **kw)
    _RUNTIME["device"] = dev
    # every rank creates the control group, in the same order
    _RUNTIME["ctrl"] = (dist.new_group(backend="gloo")
                        if backend == "nccl" else None)


def _rank_cuda_device(rank: int) -> torch.device:
    """A rank's card: LOCAL_RANK, else the rank modulo the card count;
    raises where there is no card."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device for this rank's shard; pass "
                           "device= (e.g. 'cpu') to name another")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % n)))


def _ctrl_group():
    return _RUNTIME.get("ctrl")


class DistComm(Communicator):
    """One shard per rank of the default torch.distributed group, the rank
    being the shard's flat index: point-to-point moves by paired
    batch_isend_irecv (every rank posts its sends and receives together, so
    none can deadlock), gathers by all_gather.  Tensors on the card go
    through the default (NCCL) group, tensors on the CPU through the gloo
    control group."""

    def __init__(self, n_channel: int, n_time: int, devices):
        super().__init__(n_channel, n_time, devices, [dist.get_rank()])

    @staticmethod
    def _group(t: torch.Tensor):
        return None if t.device.type == "cuda" else _ctrl_group()

    def _exchange(self, routes, sends, like):
        (me,) = self.shards
        ops, out = [], {}
        for s, d in routes:
            if s == me and d == me:
                out[(s, d)] = sends[(s, d)]
            elif s == me:
                x = sends[(s, d)].contiguous()
                ops.append(dist.P2POp(dist.isend, x, d, self._group(x)))
            elif d == me:
                buf = torch.empty_like(like(d), memory_format=
                                       torch.contiguous_format)
                ops.append(dist.P2POp(dist.irecv, buf, s, self._group(buf)))
                out[(s, d)] = buf
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out

    def _gather(self, xs):
        (x,) = xs
        x = x.contiguous()
        every = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(every, x, group=self._group(x))
        return every


def global_mesh(n_channel: int | None = None, n_time: int = 1,
                device=None) -> Mesh:
    """A (channel, time) mesh over every rank of the torch.distributed group
    (one shard a rank, DistComm); without torch.distributed, make_mesh over
    this process's CUDA devices.

    Each rank's shard lives on `device`, by default the card.  A card
    named without an index is the device initialize() chose or, where the
    group was brought up without initialize(), this rank's card
    (LOCAL_RANK, else the rank modulo the card count; no card raises).  A
    group brought up without initialize() on another backend than gloo
    gets its gloo control group here."""
    if not dist.is_initialized():
        return make_mesh(n_channel=n_channel, n_time=n_time)
    n = dist.get_world_size()
    if n_channel is None:
        n_channel = n // n_time
    if n_channel * n_time != n:
        raise ValueError(f"mesh {n_channel}x{n_time} over {n} ranks: one "
                         "shard a rank")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = _RUNTIME.get("device") or _rank_cuda_device(dist.get_rank())
    if "ctrl" not in _RUNTIME:
        # every rank builds the mesh, so every rank creates the group
        _RUNTIME["ctrl"] = (None if dist.get_backend() == "gloo"
                            else dist.new_group(backend="gloo"))
    names = [None] * n
    dist.all_gather_object(names, str(dev), group=_ctrl_group())
    grid = np.empty(n, dtype=object)
    for i, name in enumerate(names):
        grid[i] = torch.device(name)
    return Mesh(grid.reshape(n_channel, n_time),
                DistComm(n_channel, n_time, list(grid)))


# ---------------------------------------------------------------------------
# Host control plane (replaces the analyzer's UDP control channel)
# ---------------------------------------------------------------------------

_CTRL_CAPACITY = 4096


def broadcast_control(msg: Any = None, capacity: int = _CTRL_CAPACITY) -> Any:
    """Broadcast a control message (any pmt-serializable value: dict of
    retune/gain/config, etc.) from rank 0 to all ranks over the gloo
    control group.

    Other ranks pass msg=None and receive rank 0's value.  Without
    torch.distributed: returns msg unchanged.  The wire format is the io.pmt
    typed serialization behind a 4-byte little-endian length, padded to
    `capacity` bytes."""
    from tpu_ofdm_torch.io import pmt

    if not dist.is_initialized():
        return msg
    buf = np.zeros(capacity, dtype=np.uint8)
    if dist.get_rank() == 0:
        wire = pmt.dumps(msg)
        if len(wire) + 4 > capacity:
            raise ValueError(
                f"control message {len(wire)}B exceeds capacity {capacity}")
        buf[:4] = np.frombuffer(len(wire).to_bytes(4, "little"),
                                dtype=np.uint8)
        buf[4: 4 + len(wire)] = np.frombuffer(wire, dtype=np.uint8)
    t = torch.from_numpy(buf)
    dist.broadcast(t, src=0, group=_ctrl_group())
    out = t.numpy()
    n = int.from_bytes(out[:4].tobytes(), "little")
    return pmt.loads(out[4: 4 + n].tobytes())


def barrier(name: str = "tpu_ofdm") -> None:
    """Synchronize all ranks (start-of-capture alignment); `name` is kept
    for the JAX package's signature."""
    if dist.is_initialized():
        dist.barrier(group=_ctrl_group())


# ---------------------------------------------------------------------------
# Mesh-wide metric aggregation (psum)
# ---------------------------------------------------------------------------


class LinkCounters(NamedTuple):
    """Device-side link counters, psum-able over the mesh.  The on-device
    shadow of utils.metrics.LinkMetrics' additive fields."""

    frames_detected: torch.Tensor  # () f32
    frames_ok: torch.Tensor        # () f32
    frames_crc_fail: torch.Tensor  # () f32
    bytes_ok: torch.Tensor         # () f32
    evm_sum: torch.Tensor          # () f32 (over crc-ok frames)
    samples: torch.Tensor          # () f32

    @staticmethod
    def zeros(device="cuda") -> "LinkCounters":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return LinkCounters(z, z, z, z, z, z)


def counters_from_rx(res, n_samples: int) -> LinkCounters:
    """LinkCounters from an RxBlockResult (device-side, maskable)."""
    valid = res.valid
    ok = valid & res.frames.crc_ok

    def f32(x):
        return x.to(torch.float32).sum()

    return LinkCounters(
        frames_detected=f32(valid),
        frames_ok=f32(ok),
        frames_crc_fail=f32(valid & ~res.frames.crc_ok),
        bytes_ok=f32(torch.where(ok, res.frames.payload_len, 0)),
        evm_sum=f32(torch.where(ok, res.frames.evm, 0.0)),
        samples=torch.full((), float(n_samples), dtype=torch.float32,
                           device=valid.device),
    )


def psum_tree(tree: Any, mesh: Mesh) -> Any:
    """Sum a per-shard tree over the ENTIRE mesh with one psum per leaf.

    Each leaf has leading dim == mesh.size (one row per shard, e.g.
    stacked per-shard counters; every process passes the whole stack);
    returns the global totals on this process's first shard."""
    comm = mesh.comm

    def one(a):
        a = torch.as_tensor(a)
        a = a.reshape(mesh.size, *a.shape[1:])
        rows = [a[i].to(comm.devices[i]) for i in comm.shards]
        return comm.psum(rows, AXES)[0]

    return tree_map(one, tree)


def metrics_from_counters(c: LinkCounters) -> dict:
    """Host-side summary dict from (aggregated) LinkCounters."""
    def g(x):
        return float(torch.as_tensor(x))

    det, ok = g(c.frames_detected), g(c.frames_ok)
    return {
        "frames_detected": int(det),
        "frames_ok": int(ok),
        "frames_crc_fail": int(g(c.frames_crc_fail)),
        "frame_error_rate": round(g(c.frames_crc_fail) / max(det, 1), 4),
        "bytes_ok": int(g(c.bytes_ok)),
        "mean_evm": round(g(c.evm_sum) / max(ok, 1), 5),
        "samples": int(g(c.samples)),
    }


# ---------------------------------------------------------------------------
# Spectrum consensus (all_gather over the channel axis)
# ---------------------------------------------------------------------------


def gather_spectrum_shards(rows: list, mesh: Mesh) -> list:
    """Per held shard, its channel rows (c_local, nbins) -> the whole band
    (C, nbins): all_gather over the channel axis, then pmean over time
    shards (PSD segments of the same band over time)."""
    g = mesh.comm.all_gather(rows, CHANNEL_AXIS, dim=0)
    if mesh.shape[TIME_AXIS] > 1:
        g = mesh.comm.pmean(g, TIME_AXIS)
    return g


def all_gather_spectrum(psd, mesh: Mesh):
    """Channel-sharded PSD rows (C, nbins) -> the replicated (C, nbins), on
    this process's first shard.

    The multi-device analyzer's "full band view": each channel shard holds
    the PSD of its own channels; one all_gather along the channel axis
    gives every shard the whole band.  Time shards average."""
    rows = split(torch.as_tensor(psd), mesh.comm, (CHANNEL_AXIS, None))
    return gather_spectrum_shards(rows, mesh)[0]


# ---------------------------------------------------------------------------
# Failure detection (heartbeat)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshHeartbeat:
    """Every process publishes a monotonic progress count; each `beat()`
    all-gathers them (int64, over the gloo control group) so every process
    sees every other's progress.  A process whose count has not advanced
    between beats is reported stalled.

    Single process: watches the one local count (utils.faults.Watchdog can
    wrap progress() for wall-clock timeouts)."""

    mesh: Any = None
    _last: np.ndarray | None = None

    def beat(self, local_progress: int) -> np.ndarray:
        """Publish local progress; returns every process's count."""
        if not dist.is_initialized():
            counts = np.asarray([local_progress], dtype=np.int64)
        else:
            mine = torch.tensor([local_progress], dtype=torch.int64)
            every = [torch.empty_like(mine)
                     for _ in range(dist.get_world_size())]
            dist.all_gather(every, mine, group=_ctrl_group())
            counts = torch.cat(every).numpy()
        stalled = (
            np.nonzero(counts <= self._last)[0].tolist()
            if self._last is not None
            else []
        )
        self._last = counts.copy()
        self.stalled = stalled
        return counts


# ---------------------------------------------------------------------------
# Sharded placement
# ---------------------------------------------------------------------------


def shard_capture(samples, mesh: Mesh, spec=(CHANNEL_AXIS, TIME_AXIS)) -> list:
    """This process's shards of a host or device capture array, laid out
    by `spec` (one entry per leading dimension: None, an axis name, or
    AXES for the flattened (channel, time) order), each contiguous on its
    shard's device.  Every process passes the SAME global array."""
    x = samples if isinstance(samples, torch.Tensor) else torch.as_tensor(
        np.asarray(samples))
    return split(x, mesh.comm, spec)
