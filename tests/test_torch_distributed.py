"""The port's multi-device runtime (tpu_ofdm_torch/shard/distributed.py and
the communicators' collectives) against the JAX package's.

  * one process, the JAX package's 8 virtual CPU devices beside a port mesh
    over [cpu] * 8 (local communicator): psum_tree, counters_from_rx,
    metrics_from_counters, all_gather_spectrum and the collectives (ppermute,
    psum, pmean, all_gather, all_to_all) against shard_map on the same
    inputs; the single-process control plane and heartbeat;
  * two processes (torch.multiprocessing, a file:// rendezvous under
    tmp_path, gloo): tests/helpers/torch_dist_worker.py runs the ring halos,
    all_gather, psum, broadcast_control, the heartbeat and the sharded RX
    stream at 1x2 over the dist communicator; the stream's frames must
    equal the local communicator's.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from tests.helpers import torch_dist_worker as W
from tests.test_torch_shard import jax_mesh, port_mesh
from tpu_ofdm.shard import distributed as JD
from tpu_ofdm_torch.shard import distributed as D
from tpu_ofdm_torch.shard import mesh as tmesh

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def test_initialize_noop_single_process(monkeypatch):
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    D.initialize()  # no env, no args -> must not raise or spin
    assert not torch.distributed.is_initialized()


def test_broadcast_control_and_barrier_single_process():
    msg = {"cmd": "retune", "freq": 100e6}
    assert D.broadcast_control(msg) == JD.broadcast_control(msg) == msg
    D.barrier()


def test_psum_tree_totals_match_jax():
    rows = np.arange(1, 9, dtype=np.float32)
    jc = JD.LinkCounters(*(rows * k for k in range(1, 7)))
    tc = D.LinkCounters(*(torch.as_tensor(rows * k) for k in range(1, 7)))
    want = JD.metrics_from_counters(jax.tree.map(
        np.asarray, JD.psum_tree(jc, jax_mesh(4, 2))))
    tot = D.psum_tree(tc, port_mesh(4, 2))
    assert float(tot.frames_detected) == rows.sum()
    assert D.metrics_from_counters(tot) == want
    assert want["frame_error_rate"] == 3.0


def test_counters_from_rx_match_jax():
    """Link counters of the same capture demodulated by both packages."""
    from tests.test_torch_shard import _capture, _specs
    from tpu_ofdm.modem.rx import rx_block as j_rx
    from tpu_ofdm_torch.modem.rx import rx_block as t_rx

    spec, tspec = _specs()
    stream, _, _, _ = _capture(False)
    x = stream[0, :8192]
    jres = jax.jit(lambda a: j_rx(spec, a, max_frames=4))(x)
    jc = JD.counters_from_rx(jres, x.size)
    tc = D.counters_from_rx(t_rx(tspec, torch.as_tensor(x), 4), x.size)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert D.metrics_from_counters(tc) == JD.metrics_from_counters(jc)
    assert D.metrics_from_counters(tc)["frames_ok"] == 1
    zero = D.LinkCounters.zeros("cpu")
    assert D.metrics_from_counters(zero)["frames_detected"] == 0


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
def test_all_gather_spectrum_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    psd = rng.rand(8, 32).astype(np.float32)
    want = np.asarray(JD.all_gather_spectrum(psd, jax_mesh(*shape)))
    got = D.all_gather_spectrum(psd, port_mesh(*shape))
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_collective(body, mesh, x, in_spec, out_spec):
    return np.asarray(shard_map(body, mesh=mesh, in_specs=in_spec,
                                out_specs=out_spec, check_vma=False)(
        jnp.asarray(x)))


COLLECTIVES = ["psum_time", "psum_channel", "psum_all", "pmean_time",
               "all_gather_channel", "ppermute_flat", "all_to_all"]


@pytest.mark.parametrize("kind", COLLECTIVES)
def test_collectives_match_jax_shard_map(kind):
    """Each collective of the local communicator on a 4x2 mesh equals the
    JAX collective inside shard_map on the same blocks, bit for bit (the
    sums add the group in axis order on both sides)."""
    rng = np.random.RandomState(COLLECTIVES.index(kind))
    jm, tm = jax_mesh(4, 2), port_mesh(4, 2)
    comm = tm.comm
    flat = ("channel", "time")
    x = rng.randn(8 * 3, 5).astype(np.float32)
    spec = P(flat)                         # one (3, 5) block a shard
    xs = tmesh.split(torch.as_tensor(x), comm, (flat,))
    if kind.startswith(("psum", "pmean")):
        axis = {"time": "time", "channel": "channel",
                "all": flat}[kind.split("_")[1]]
        jfn = jax.lax.pmean if kind.startswith("pmean") else jax.lax.psum
        want = _jax_collective(lambda a: jfn(a, axis), jm, x, spec, spec)
        tfn = comm.pmean if kind.startswith("pmean") else comm.psum
        got = tfn(xs, axis)
    elif kind == "all_gather_channel":
        want = _jax_collective(
            lambda a: jax.lax.all_gather(a, "channel", axis=0, tiled=True),
            jm, x, spec, spec)
        got = comm.all_gather(xs, "channel", dim=0)
    elif kind == "ppermute_flat":
        perm = [(i, (i + 3) % 8) for i in range(8)]
        want = _jax_collective(lambda a: jax.lax.ppermute(a, flat, perm),
                               jm, x, spec, spec)
        got = comm.ppermute(xs, flat, perm)
    else:
        # every shard sends row block j of its (8, 5) block to shard j
        x = rng.randn(8 * 8, 5).astype(np.float32)
        xs = tmesh.split(torch.as_tensor(x), comm, (flat,))
        want = _jax_collective(
            lambda a: jax.lax.all_to_all(a, flat, 0, 0, tiled=True),
            jm, x, spec, spec)
        routes = [(i, j) for i in range(8) for j in range(8)]
        recv = comm.all_to_all([{j: s[j:j + 1] for j in range(8)}
                                for s in xs], routes, xs[0][:1])
        got = [torch.cat([r[j] for j in range(8)]) for r in recv]
    np.testing.assert_array_equal(
        tmesh.join(got, comm, (flat,)).numpy(), want)


def test_heartbeat_single_process():
    hb = D.MeshHeartbeat()
    assert hb.beat(5).tolist() == [5]
    hb.beat(6)
    assert hb.stalled == []
    hb.beat(6)  # no progress
    assert hb.stalled == [0]


def test_global_mesh_without_distributed_is_make_mesh():
    """Without initialize(), global_mesh is make_mesh over this process's
    CUDA devices: on a CPU-only torch it raises rather than fall back."""
    if torch.cuda.is_available():
        assert D.global_mesh().devices[0, 0].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            D.global_mesh()


def test_global_mesh_on_a_callers_group_names_its_device(tmp_path,
                                                         monkeypatch):
    """Over a group the caller brought up itself (gloo, one rank), without
    initialize(): a mesh on the CPU when the caller names it, one shard
    over the dist communicator, the gloo default group serving control."""
    monkeypatch.setattr(D, "_RUNTIME", {})
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdv", world_size=1, rank=0)
    try:
        mesh = D.global_mesh(1, 1, device="cpu")
        assert mesh.devices[0, 0] == torch.device("cpu")
        assert type(mesh.comm) is D.DistComm
        assert D._RUNTIME["ctrl"] is None
        assert D.broadcast_control({"cmd": "reset"}) == {"cmd": "reset"}
        x = torch.arange(4.0)
        assert torch.equal(mesh.comm.psum([x], "time")[0], x)
    finally:
        torch.distributed.destroy_process_group()


TWO_PROCESS_TIMEOUT_S = 120.0


def test_two_process_gloo(tmp_path):
    """Two ranks over gloo (file:// rendezvous under tmp_path), each with
    one shard of a 1x2 mesh: the worker's collective checks pass in both,
    and the sharded RX stream's frames, gathered from both ranks, equal
    the local communicator's on the same chunks."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.worker,
                         args=(r, 2, str(tmp_path / "rendezvous"),
                               str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TWO_PROCESS_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"ranks still running after {TWO_PROCESS_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    got = []
    for r in range(2):
        got += json.loads((tmp_path / f"frames_{r}.json").read_text())
    want = W.run_stream(port_mesh(1, 2))
    key = lambda f: (f["channel"], f["abs_start"])  # noqa: E731
    assert sorted(got, key=key) == sorted(want, key=key)
    ok = [f for f in want if f["crc_ok"]]
    assert len(ok) == 4
    assert {bytes.fromhex(f["payload"]) for f in ok} == {
        b"rank zero owns this", b"across the time shards",
        b"across the chunks", b"in chunk one"}
