"""One rank of tests/test_torch_distributed.py's two-process gloo run of
the port's multi-device layer (tpu_ofdm_torch.shard with the dist
communicator).  Imports no JAX.

Each rank: initialize from a file:// rendezvous -> a 1x2 (channel x time)
global mesh, one shard a rank -> the ring halos, all_gather, psum,
broadcast_control, the heartbeat and a barrier, checked in place -> the
sharded RX stream over stream_chunks(), its frames written to
<out_dir>/frames_<rank>.json for the parent to hold against the local
communicator's.  Any failed check raises, and the exit code says so.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

STREAM_S, STREAM_C = 4096, 2
N_TIME = 2
CHUNK = N_TIME * STREAM_S


def stream_chunks():
    """Three (C, CHUNK) chunks of the headline spec: frames inside a shard,
    across the time-shard boundary, across the chunk boundary; the last
    chunk is zeros (the drain)."""
    import tests.golden.golden_ofdm as G

    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    rng = np.random.RandomState(21)
    x = np.zeros((STREAM_C, 3 * CHUNK), np.complex64)
    for c, pos, msg in [(0, 500, b"rank zero owns this"),
                        (1, STREAM_S - 700, b"across the time shards"),
                        (0, CHUNK - 900, b"across the chunks"),
                        (1, CHUNK + STREAM_S + 300, b"in chunk one")]:
        f = G.tx_frame(gp, msg, c).astype(np.complex64)
        x[c, pos:pos + len(f)] += f
    n = 2 * CHUNK
    x[:, :n] += ((rng.randn(STREAM_C, n) + 1j * rng.randn(STREAM_C, n))
                 * 0.01).astype(np.complex64)
    return [torch.as_tensor(x[:, k * CHUNK:(k + 1) * CHUNK].copy())
            for k in range(3)]


def run_stream(mesh):
    """Frames (as JSON-able dicts) of the sharded RX stream over
    stream_chunks() on `mesh`."""
    from tpu_ofdm_torch import config
    from tpu_ofdm_torch.shard import (collect_sharded_stream_frames,
                                      sharded_rx_stream_block)
    from tpu_ofdm_torch.stream.executor import StreamExecutor

    spec = config.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    block = sharded_rx_stream_block(spec, mesh, STREAM_C, STREAM_S,
                                    max_frames_per_shard=4)
    ex = StreamExecutor(block, CHUNK, device="cpu")
    outs = [ex.push(c) for c in stream_chunks()]
    frames = collect_sharded_stream_frames(outs, STREAM_S, spec, N_TIME)
    return [{**f, "payload": f["payload"].hex()} for f in frames]


def worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from tpu_ofdm_torch.shard import distributed as D
    from tpu_ofdm_torch.shard import halo_from_left, halo_from_right
    from tpu_ofdm_torch.shard.mesh import TIME_AXIS

    D.initialize(f"file://{init_file}", world, rank, device="cpu")
    mesh = D.global_mesh(n_channel=1, n_time=world)
    assert type(mesh.comm) is D.DistComm and mesh.comm.shards == [rank]

    # ring halos over the time axis: rank 0 gets zeros from the left, the
    # last rank zeros from the right
    x = torch.arange(2 * 16 * world, dtype=torch.float32).reshape(2, -1)
    (mine,) = D.shard_capture(x, mesh)
    (left,) = halo_from_left([mine], 4, mesh)
    (right,) = halo_from_right([mine], 4, mesh)
    want_left = (torch.zeros(2, 4) if rank == 0
                 else x[:, 16 * rank - 4:16 * rank])
    want_right = (torch.zeros(2, 4) if rank == world - 1
                  else x[:, 16 * (rank + 1):16 * (rank + 1) + 4])
    assert torch.equal(left, want_left) and torch.equal(right, want_right)

    # all_gather and psum over the time axis; psum_tree over the mesh
    (full,) = mesh.comm.all_gather([mine], TIME_AXIS, dim=1)
    assert torch.equal(full, x)
    (tot,) = mesh.comm.psum([mine], TIME_AXIS)
    assert torch.equal(tot, sum(x[:, 16 * r:16 * (r + 1)]
                                for r in range(world)))
    stacked = D.LinkCounters(*(torch.full((world,), float(i + 1))
                               for i in range(6)))
    m = D.metrics_from_counters(D.psum_tree(stacked, mesh))
    assert m["frames_detected"] == world and m["samples"] == 6 * world

    # control plane, heartbeat, barrier
    msg = {"cmd": "retune", "freq": 146.52e6, "gain": 20} if rank == 0 else None
    assert D.broadcast_control(msg) == {"cmd": "retune", "freq": 146.52e6,
                                        "gain": 20}
    assert D.broadcast_control([] if rank == 0 else None) == []
    hb = D.MeshHeartbeat(mesh)
    assert hb.beat(1000 + rank).tolist() == [1000 + r for r in range(world)]
    hb.beat(2000 + rank)
    assert hb.stalled == []
    hb.beat(2000 + rank)
    assert hb.stalled == list(range(world))
    D.barrier("checks")

    frames = run_stream(mesh)
    with open(os.path.join(out_dir, f"frames_{rank}.json"), "w") as f:
        json.dump(frames, f)
    D.barrier("done")
    torch.distributed.destroy_process_group()
