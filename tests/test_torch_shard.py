"""The port's sharded RX (tpu_ofdm_torch/shard/: mesh, halo, rx) against
the JAX package's on its 8-device virtual CPU mesh (tests/conftest.py),
the port's meshes laid over [cpu] * n with the local communicator.  Both
packages take the same numpy inputs and the same mesh shapes.

Halos equal JAX's shard_map results bit for bit; frames equal exactly on
(channel, payload, frame_num, crc_ok, abs_start), EVM within rtol 1e-3
(tests/test_torch_wideband.py's bar).  Also: a 2x4 mesh equals a 1x1 mesh,
the stream carry crosses chunk boundaries and hands over from the JAX
carry mid-stream, and the preconditions the JAX package leaves to shape
errors raise ValueError."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import tests.golden.golden_ofdm as G
from tpu_ofdm import shard as jshard
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm.stream.executor import StreamExecutor as JaxExecutor
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch import shard as tshard
from tpu_ofdm_torch.modem.rx_stream import history_len
from tpu_ofdm_torch.shard import mesh as tmesh
from tpu_ofdm_torch.shard import rx as trx
from tpu_ofdm_torch.stream.executor import StreamExecutor

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

CPU = torch.device("cpu")


def port_mesh(n_c, n_t):
    return tshard.make_mesh(n_c, n_t, devices=[CPU] * (n_c * n_t))


def jax_mesh(n_c, n_t):
    return jshard.make_mesh(n_channel=n_c, n_time=n_t,
                            devices=jax.devices()[: n_c * n_t])


def _specs(modulation="qpsk"):
    return (OfdmConfig(fft_len=64, cp_len=16, modulation=modulation).spec,
            tconfig.OfdmConfig(fft_len=64, cp_len=16,
                               modulation=modulation).spec)


@functools.lru_cache(maxsize=None)
def _frame(modulation, payload: bytes, frame_num: int) -> np.ndarray:
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation=modulation)
    return G.tx_frame(gp, payload, frame_num).astype(np.complex64)


def assert_same_frames(port, ref):
    key = lambda f: (f["channel"], f["abs_start"])  # noqa: E731
    port, ref = sorted(port, key=key), sorted(ref, key=key)
    assert len(port) == len(ref), (port, ref)
    for a, b in zip(port, ref):
        for k in ("channel", "payload", "frame_num", "crc_ok", "abs_start"):
            assert a[k] == b[k], (k, a, b)
        np.testing.assert_allclose(a["evm"], b["evm"], rtol=1e-3)


# -- halos ---------------------------------------------------------------------


def _jax_halo(fn, mesh, x, spec):
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                                check_vma=False)(jnp.asarray(x)))


HALO_CASES = {
    "left_1x8": (1, 8, "left", 4),
    "left_2x4": (2, 4, "left", 8),
    "right_2x4": (2, 4, "right", 8),
    "extend_2x4": (2, 4, "extend", 8),
    "left_4x2_channel_axis": (4, 2, "left_channel", 3),
}


@pytest.mark.parametrize("case", HALO_CASES.values(), ids=HALO_CASES.keys())
def test_halos_equal_jax_shard_map(case):
    """halo_from_left / halo_from_right / extend_with_left_halo over the
    port's local communicator equal JAX's shard_map result bit for bit
    (shard 0 of the axis gets zeros from the left, the last from the
    right)."""
    n_c, n_t, kind, h = case
    rng = np.random.RandomState(n_c * 10 + n_t)
    x = rng.randn(2 * n_c, 16 * n_t).astype(np.float32)
    axis = jshard.CHANNEL_AXIS if kind == "left_channel" else jshard.TIME_AXIS
    spec = (P("channel", "time") if kind != "left_channel"
            else P("time", "channel"))
    jfn = {"left": jshard.halo_from_left, "right": jshard.halo_from_right,
           "extend": jshard.extend_with_left_halo,
           "left_channel": jshard.halo_from_left}[kind]
    tfn = {"left": tshard.halo_from_left, "right": tshard.halo_from_right,
           "extend": tshard.extend_with_left_halo,
           "left_channel": tshard.halo_from_left}[kind]
    if kind == "left_channel":
        x = rng.randn(2 * n_t, 16 * n_c).astype(np.float32)
    want = _jax_halo(lambda a: jfn(a, h, axis), jax_mesh(n_c, n_t), x, spec)
    mesh = port_mesh(n_c, n_t)
    tspec = tuple(spec)
    xs = tmesh.split(torch.as_tensor(x), mesh.comm, tspec)
    got = tmesh.join(tfn(xs, h, mesh, axis), mesh.comm, tspec)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_join_round_trip():
    """split then join restores the array for every spec the sharded paths
    use, and a replicated axis takes its first shard."""
    mesh = port_mesh(2, 4)
    x = torch.arange(8 * 24, dtype=torch.float32).reshape(8, 24)
    for spec in [("channel", "time"), ("channel", None), (None, "time"),
                 (("channel", "time"),)]:
        xs = tmesh.split(x, mesh.comm, spec)
        assert len(xs) == 8 and all(s.is_contiguous() for s in xs)
        torch.testing.assert_close(tmesh.join(xs, mesh.comm, spec), x,
                                   rtol=0, atol=0)
    flat = tmesh.split(x.reshape(-1), mesh.comm, (("channel", "time"),))
    assert [int(s[0]) for s in flat] == [24 * i for i in range(8)]


# -- sharded capture -----------------------------------------------------------


def _capture(boundary_straddle):
    S, C, T = 4096, 2, 4
    rng = np.random.RandomState(3)
    stream = np.zeros((C, T * S), np.complex64)
    f0 = _frame("qpsk", b"channel zero frame", 5)
    f1 = _frame("qpsk", b"channel one straddles", 9)
    pos0 = 1000
    pos1 = 2 * S - len(f1) // 2 if boundary_straddle else 5000
    stream[0, pos0:pos0 + len(f0)] = f0
    stream[1, pos1:pos1 + len(f1)] = f1
    stream += ((rng.randn(C, T * S) + 1j * rng.randn(C, T * S))
               * np.sqrt(10 ** (-28 / 10) / 2)).astype(np.complex64)
    return stream, S, T, (pos0, pos1)


@pytest.mark.parametrize("boundary_straddle", [False, True])
def test_sharded_rx_capture_matches_jax(boundary_straddle):
    """tests/test_shard.py:77 through both packages on a 2x4 mesh: the same
    frames, each reported once, the straddler by one shard."""
    spec, tspec = _specs()
    stream, S, T, (pos0, pos1) = _capture(boundary_straddle)
    jres = jax.tree.map(np.asarray, jax.jit(jshard.sharded_rx_capture_fn(
        spec, jax_mesh(2, 4), S, max_frames_per_shard=4))(stream))
    ref = jshard.collect_sharded_frames(jres, S, spec, n_time=T)
    res = tshard.sharded_rx_capture_fn(tspec, port_mesh(2, 4), S,
                                       max_frames_per_shard=4)(
        torch.as_tensor(stream))
    assert res.valid.shape == (2, T * 4)
    got = tshard.collect_sharded_frames(res, S, tspec, n_time=T)
    assert_same_frames(got, ref)
    ok = {f["channel"]: f for f in got if f["crc_ok"]}
    assert len([f for f in got if f["crc_ok"]]) == 2
    assert ok[0]["payload"] == b"channel zero frame" and ok[0]["frame_num"] == 5
    assert ok[1]["payload"] == b"channel one straddles"
    assert abs(ok[0]["abs_start"] - pos0) < 16
    assert abs(ok[1]["abs_start"] - pos1) < 16


def test_sharded_matches_single_device():
    """tests/test_shard.py:110: the 2x4 mesh and a 1x1 mesh give the same
    frames, in the port as in the JAX package, and the two packages
    agree."""
    spec, tspec = _specs("bpsk")
    S, T = 4096, 4
    rng = np.random.RandomState(7)
    stream = np.zeros((2, T * S), np.complex64)
    fr = _frame("bpsk", b"determinism check", 1)
    stream[0, 3000:3000 + len(fr)] = fr
    stream[1, 9000:9000 + len(fr)] = fr
    stream += ((rng.randn(*stream.shape) + 1j * rng.randn(*stream.shape))
               * 0.01).astype(np.complex64)
    x = torch.as_tensor(stream)
    f8 = tshard.collect_sharded_frames(
        tshard.sharded_rx_capture_fn(tspec, port_mesh(2, 4), S, 4)(x),
        S, tspec, n_time=T)
    f1 = tshard.collect_sharded_frames(
        tshard.sharded_rx_capture_fn(tspec, tshard.single_device_mesh(CPU),
                                     T * S, 16)(x), T * S, tspec, n_time=1)
    assert_same_frames(f8, f1)
    assert len([f for f in f8 if f["crc_ok"]]) == 2
    jres = jax.tree.map(np.asarray, jax.jit(jshard.sharded_rx_capture_fn(
        spec, jax_mesh(2, 4), S, 4))(stream))
    assert_same_frames(f8, jshard.collect_sharded_frames(jres, S, spec, T))


# -- the resumable stream --------------------------------------------------------


STREAM_S, STREAM_C, STREAM_T = 4096, 2, 4
STREAM_CHUNK = STREAM_T * STREAM_S


@functools.lru_cache(maxsize=None)
def _stream():
    """tests/test_shard.py:141's capture: a frame inside chunk 0, one
    straddling the chunk boundary, one inside chunk 1; plus a zero chunk
    to drain."""
    chunk = STREAM_CHUNK
    rng = np.random.RandomState(11)
    stream = np.zeros((STREAM_C, 3 * chunk), np.complex64)
    f0 = _frame("qpsk", b"inside chunk zero", 1)
    f1 = _frame("qpsk", b"straddles the chunk boundary", 2)
    f2 = _frame("qpsk", b"inside chunk one", 3)
    pos = {0: 2500, 1: chunk - len(f1) // 2, 2: chunk + 7000}
    stream[0, pos[0]:pos[0] + len(f0)] = f0
    stream[1, pos[1]:pos[1] + len(f1)] = f1
    stream[1, pos[2]:pos[2] + len(f2)] = f2
    stream[:, :2 * chunk] += ((rng.randn(STREAM_C, 2 * chunk)
                               + 1j * rng.randn(STREAM_C, 2 * chunk))
                              * 0.01).astype(np.complex64)
    return stream, pos


def _chunks():
    stream, _ = _stream()
    return [stream[:, k * STREAM_CHUNK:(k + 1) * STREAM_CHUNK]
            for k in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_stream():
    """(JAX frames over the three chunks, the JAX carry after chunk 0)."""
    spec, _ = _specs()
    block = jshard.sharded_rx_stream_block(spec, jax_mesh(2, 4), STREAM_C,
                                           STREAM_S, max_frames_per_shard=4)
    ex = JaxExecutor(block, STREAM_CHUNK, donate=False)
    outs = [ex.push(_chunks()[0])]
    carry = jax.tree.map(np.asarray, ex.state)
    outs += [ex.push(c) for c in _chunks()[1:]]
    outs = [jax.tree.map(np.asarray, o) for o in outs]
    return (jshard.collect_sharded_stream_frames(outs, STREAM_S, spec,
                                                 n_time=STREAM_T), carry)


def _port_stream_block(tspec, mesh):
    return tshard.sharded_rx_stream_block(tspec, mesh, STREAM_C, STREAM_S,
                                          max_frames_per_shard=4)


def test_sharded_stream_carry_across_chunks():
    """tests/test_shard.py:141 through both packages: the frame straddling
    the CHUNK boundary comes back once, from the carried tail; every frame
    equal to the JAX package's."""
    _, tspec = _specs()
    _, pos = _stream()
    ex = StreamExecutor(_port_stream_block(tspec, port_mesh(2, 4)),
                        STREAM_CHUNK, device="cpu")
    outs = [ex.push(torch.as_tensor(c)) for c in _chunks()]
    got = tshard.collect_sharded_stream_frames(outs, STREAM_S, tspec,
                                               n_time=STREAM_T)
    ref, _ = _jax_stream()
    assert_same_frames(got, ref)
    ok = [f for f in got if f["crc_ok"]]
    assert {(f["channel"], f["payload"]) for f in ok} == {
        (0, b"inside chunk zero"), (1, b"straddles the chunk boundary"),
        (1, b"inside chunk one")}
    for f, p in zip(sorted(ok, key=lambda d: d["frame_num"]),
                    [pos[0], pos[1], pos[2]]):
        assert abs(f["abs_start"] - p) < 16
    assert outs[0].origin.tolist() == [0, 0, STREAM_T]
    assert [int(o.chunk_index) for o in outs] == [0, 1, 2]


def test_sharded_stream_resumes_from_jax_carry():
    """The JAX block runs chunk 0; the port continues from its carry
    (carry_from_jax) and reports the rest of the JAX package's frames,
    the chunk-boundary straddler included; carry_to_jax gives the JAX
    layout back."""
    _, tspec = _specs()
    ref, carry = _jax_stream()
    ex = StreamExecutor(_port_stream_block(tspec, port_mesh(2, 4)),
                        STREAM_CHUNK, device="cpu")
    ex.state = trx.carry_from_jax(carry, ex.device)
    assert int(ex.state[1]) == 1
    outs = [ex.push(torch.as_tensor(c)) for c in _chunks()[1:]]
    got = tshard.collect_sharded_stream_frames(outs, STREAM_S, tspec,
                                               n_time=STREAM_T)
    H = history_len(tspec)
    assert_same_frames(got, [f for f in ref
                             if f["abs_start"] >= STREAM_CHUNK - H])
    assert any(f["payload"] == b"straddles the chunk boundary" for f in got)
    tail, step = trx.carry_to_jax(ex.state)
    assert tail.shape == (STREAM_C, H) and tail.dtype == np.complex64
    assert step.dtype == np.int32 and int(step) == 3


def test_sharded_stream_1x1_equals_2x4():
    """The stream on a 1x1 mesh (one shard of the whole chunk) gives the
    2x4 mesh's frames."""
    _, tspec = _specs()
    frames = []
    for mesh, S, K in [(port_mesh(2, 4), STREAM_S, 4),
                       (tshard.single_device_mesh(CPU), STREAM_CHUNK, 16)]:
        block = tshard.sharded_rx_stream_block(tspec, mesh, STREAM_C, S, K)
        ex = StreamExecutor(block, STREAM_CHUNK, device="cpu")
        outs = [ex.push(torch.as_tensor(c)) for c in _chunks()]
        frames.append(tshard.collect_sharded_stream_frames(
            outs, S, tspec, n_time=mesh.shape["time"]))
    assert_same_frames(*frames)


# -- preconditions ------------------------------------------------------------------


PRECONDITIONS = {
    "shard_shorter_than_history": lambda tspec: tshard.sharded_rx_stream_block(
        tspec, port_mesh(2, 4), 2, 512),
    "channels_not_divisible": lambda tspec: tshard.sharded_rx_stream_block(
        tspec, port_mesh(2, 4), 3, 4096),
    "capture_channels_not_divisible": lambda tspec:
        tshard.sharded_rx_capture_fn(tspec, port_mesh(2, 4), 4096)(
            torch.zeros((3, 4 * 4096), dtype=torch.complex64)),
    "capture_shard_shorter_than_history": lambda tspec:
        tshard.sharded_rx_capture_fn(tspec, port_mesh(2, 4), 1024)(
            torch.zeros((2, 4 * 1024), dtype=torch.complex64)),
}


@pytest.mark.parametrize("make", PRECONDITIONS.values(),
                         ids=PRECONDITIONS.keys())
def test_preconditions_raise(make):
    """What the JAX package leaves to a shape error (S < H) or an assert
    raises ValueError."""
    _, tspec = _specs()
    assert history_len(tspec) == 3072
    with pytest.raises(ValueError):
        make(tspec)


def test_mesh_shapes_and_factors():
    for n in (1, 2, 4, 6, 8, 12):
        assert tshard.balanced_factors(n) == jshard.balanced_factors(n)
    mesh = port_mesh(4, 2)
    assert mesh.shape == {"channel": 4, "time": 2} and mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert tshard.make_mesh(n_time=2, devices=[CPU] * 8).shape["channel"] == 4
    with pytest.raises(ValueError):
        tshard.make_mesh(3, 3, devices=[CPU] * 8)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu(n, capsys):
    """python -m tpu_ofdm_torch.shard.dryrun N --device cpu: the capture's
    frames exactly once (one across a time-shard ownership edge where the
    mesh has two time shards), the config-5 stream's chunk straddler once,
    the aggregation paths."""
    from tpu_ofdm_torch.shard import dryrun
    assert dryrun.main([str(n), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n_c, n_t = tshard.balanced_factors(n)
    assert f"dryrun_multichip OK: mesh {n_c}x{n_t}" in out
    assert f"of {n} shards on cpu" in out
    assert (("1 straddling" in out) == (n_t > 1))
