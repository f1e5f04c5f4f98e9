"""The port's config 5 (tpu_ofdm_torch/shard/wideband.py: the sharded
channelizer -> all_to_all -> (channel x time) demod) against the JAX
package's on its 8-device virtual CPU mesh, at 32 channels on a 4x2 mesh
(2^14 samples a channel over two chunks and a drain chunk), through both
wideband entry points.  Frames must match exactly on (channel, payload,
frame_num, crc_ok, abs_start), EVM within rtol 1e-3; the distributed
analyzer's PSD consensus in linear power within 1e-4 * its max.  Also: the
4x2 mesh equals a 1x1 mesh and the unsharded wideband receiver, a
checkpoint resumes exactly, the port continues from the JAX carry, and the
preconditions raise ValueError."""

import functools

import numpy as np
import pytest
import torch

import jax

import tests.golden.golden_ofdm as G
from tests.test_torch_shard import CPU, assert_same_frames, jax_mesh, port_mesh
from tpu_ofdm import shard as jshard
from tpu_ofdm.config import OfdmConfig
from tpu_ofdm.shard import wideband as jwide
from tpu_ofdm.stream.executor import StreamExecutor as JaxExecutor
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch import shard as tshard
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.modem.rx_stream import history_len
from tpu_ofdm_torch.modem.wideband import (collect_wideband_frames,
                                           wideband_rx_block)
from tpu_ofdm_torch.shard import wideband as twide
from tpu_ofdm_torch.spectrum.channelizer import (lowpass_taps,
                                                 synthesize_bursts)
from tpu_ofdm_torch.stream.checkpoint import (load_state, resume_step,
                                              save_state)
from tpu_ofdm_torch.stream.executor import StreamExecutor

SPEC = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                  max_payload_bytes=64).spec
TSPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                           max_payload_bytes=64).spec
H = 1024
N_CHAN, N_C, N_T = 32, 4, 2
S = 4096                         # per channel, per time shard
M_C = N_T * S                    # per channel, per chunk
CHUNK = N_CHAN * M_C             # flat wideband samples per chunk
K = 4
TAPS = lowpass_taps(N_CHAN, taps_per_arm=8)
# (channel, per-channel position, payload): mid-shard, across the
# time-shard ownership edge S - H, across the chunk boundary, across the
# time-shard data edge, and mid-chunk one
TARGETS = [
    (1, 300, b"config5 mid shard"),
    (9, S - H - 200, b"config5 ownership edge"),
    (17, M_C - 400, b"config5 chunk boundary"),
    (25, M_C + S - 200, b"config5 shard data edge"),
    (30, M_C + 3000, b"config5 chunk one"),
]


@functools.lru_cache(maxsize=None)
def _wide() -> np.ndarray:
    """Three chunks: the targets through the synthesis filterbank (each
    frame times n_chan, as chip_smoke.py builds its captures) over 0.01-rms
    noise in the first two; the third is zeros (the drain)."""
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    bursts = [(k, pos, G.tx_frame(gp, msg, k).astype(np.complex64) * N_CHAN)
              for k, pos, msg in TARGETS]
    wide = synthesize_bursts(3 * CHUNK, N_CHAN, bursts, taps=TAPS)
    rng = np.random.RandomState(0)
    n = 2 * CHUNK
    wide[:n] += ((rng.randn(n) + 1j * rng.randn(n)) * 0.01).astype(
        np.complex64)
    return wide


def _chunks():
    return [_wide()[k * CHUNK:(k + 1) * CHUNK] for k in range(3)]


def _check_targets(frames, chunks=3):
    ok = [f for f in frames if f["crc_ok"]]
    want = [(k, msg) for k, pos, msg in TARGETS if pos < chunks * M_C - H]
    assert sorted((f["channel"], f["payload"]) for f in ok) == sorted(want)
    pos = {k: p for k, p, _ in TARGETS}
    for f in ok:
        assert abs(f["abs_start"] - pos[f["channel"]]) <= 40, f
        assert f["frame_num"] == f["channel"]


def _port_block(mesh=None, S_=S, K_=K):
    return tshard.sharded_wideband_stream_block(
        TSPEC, mesh or port_mesh(N_C, N_T), N_CHAN, S_, taps=TAPS,
        max_frames_per_shard=K_)


def _port_stream(block, chunks):
    ex = StreamExecutor(block, CHUNK, device="cpu")
    return [ex.push(torch.as_tensor(c)) for c in chunks]


@functools.lru_cache(maxsize=None)
def _jax_stream():
    """(JAX frames over the three chunks, the JAX carry after chunk 0)."""
    block = jshard.sharded_wideband_stream_block(
        SPEC, jax_mesh(N_C, N_T), N_CHAN, S, taps=TAPS,
        max_frames_per_shard=K)
    ex = JaxExecutor(block, CHUNK, donate=False)
    outs = [ex.push(_chunks()[0])]
    carry = jax.tree.map(np.asarray, ex.state)
    outs += [ex.push(c) for c in _chunks()[1:]]
    outs = [jax.tree.map(np.asarray, o) for o in outs]
    return jshard.collect_sharded_stream_frames(outs, S, SPEC, N_T), carry


@functools.lru_cache(maxsize=None)
def _port_frames():
    outs = _port_stream(_port_block(), _chunks())
    return tshard.collect_sharded_stream_frames(outs, S, TSPEC, N_T)


def test_capture_matches_jax():
    """sharded_wideband_capture_fn on chunks 0 and 1 as one capture (stream
    start; 2^14 samples a channel, time shards of 2 S): the JAX package's
    frames, every target owned inside the capture."""
    S2 = 2 * S
    capture = _wide()[:2 * CHUNK]
    jfn = jax.jit(jshard.sharded_wideband_capture_fn(
        SPEC, jax_mesh(N_C, N_T), N_CHAN, S2, taps=TAPS,
        max_frames_per_shard=K))
    ref = jshard.collect_sharded_frames(
        jax.tree.map(np.asarray, jfn(capture)), S2, SPEC, N_T)
    res = tshard.sharded_wideband_capture_fn(
        TSPEC, port_mesh(N_C, N_T), N_CHAN, S2, taps=TAPS,
        max_frames_per_shard=K)(torch.as_tensor(capture))
    assert res.valid.shape == (N_CHAN, N_T * K)
    got = tshard.collect_sharded_frames(res, S2, TSPEC, N_T)
    assert_same_frames(got, ref)
    _check_targets(got, chunks=2)


def test_stream_matches_jax():
    """sharded_wideband_stream_block over three chunks: the JAX package's
    frames, every target once, on its channel, within 40 samples (the two
    filterbanks' group delay, tests/test_wideband.py)."""
    assert_same_frames(_port_frames(), _jax_stream()[0])
    _check_targets(_port_frames())


def test_stream_equals_1x1_and_unsharded_receiver():
    """The 4x2 mesh, a 1x1 mesh and wideband_rx_block (config 4's
    receiver, one block a chunk) report the same frames."""
    one = _port_stream(_port_block(tshard.single_device_mesh(CPU), M_C, 8),
                       _chunks())
    assert_same_frames(_port_frames(), tshard.collect_sharded_stream_frames(
        one, M_C, TSPEC, 1))
    sc = StreamConfig(block_size=CHUNK, max_frames_per_block=8)
    ex = StreamExecutor(wideband_rx_block(TSPEC, N_CHAN, sc, taps=TAPS),
                        CHUNK, device="cpu")
    flat = collect_wideband_frames(
        [ex.push(torch.as_tensor(c)) for c in _chunks()], M_C, TSPEC)
    assert_same_frames(_port_frames(), flat)


def test_checkpoint_restart(tmp_path):
    """save_state after chunk 1 and load_state into a fresh executor: the
    resumed stream reports the uninterrupted run's frames, the
    chunk-boundary straddler once."""
    ex = StreamExecutor(_port_block(), CHUNK, device="cpu")
    outs = [ex.push(torch.as_tensor(_chunks()[0]))]
    save_state(str(tmp_path / "ckpt"), ex)
    ex2 = StreamExecutor(_port_block(), CHUNK, device="cpu")
    meta = load_state(str(tmp_path / "ckpt"), ex2)
    assert resume_step(meta) == 1
    outs += [ex2.push(torch.as_tensor(c)) for c in _chunks()[1:]]
    got = tshard.collect_sharded_stream_frames(outs, S, TSPEC, N_T)
    assert_same_frames(got, _port_frames())


def test_resume_from_jax_carry():
    """The JAX block runs chunk 0; the port continues from its carry
    (raw tail, channel tail, step): the JAX package's later frames."""
    ref, carry = _jax_stream()
    ex = StreamExecutor(_port_block(), CHUNK, device="cpu")
    ex.state = twide.carry_from_jax(carry, ex.device)
    outs = [ex.push(torch.as_tensor(c)) for c in _chunks()[1:]]
    got = tshard.collect_sharded_stream_frames(outs, S, TSPEC, N_T)
    assert_same_frames(got, [f for f in ref if f["abs_start"] >= M_C - H])
    raw, chan, step = twide.carry_to_jax(ex.state)
    j_raw, j_chan, j_step = carry
    assert raw.shape == j_raw.shape and chan.shape == j_chan.shape
    assert int(step) == 3


PSD_CHAN, PSD_BINS = 16, 32


def _psd_blocks(n_blocks, block):
    n = np.arange(n_blocks * block)
    rng = np.random.RandomState(5)
    x = (np.exp(2j * np.pi * 0.25 * n) + 0.3 * np.exp(2j * np.pi * 0.031 * n)
         + 0.05 * (rng.randn(len(n)) + 1j * rng.randn(len(n))))
    return x.astype(np.complex64).reshape(n_blocks, block)


@pytest.mark.parametrize("mesh_shape,block", [((4, 2), 4096), ((2, 2), 2048),
                                              ((1, 1), 1024)])
def test_mesh_psd_step_matches_jax(mesh_shape, block):
    """mesh_psd_step_fn over three steps with the carried raw tail: the
    consensus within 1e-4 * max in linear power of the JAX step (which
    averages linear power over every frame before dB, as the port does
    with its psum over time shards), the returned tail equal."""
    n_c, n_t = mesh_shape
    jstep, jC = jwide.mesh_psd_step_fn(jax_mesh(n_c, n_t), PSD_CHAN, PSD_BINS)
    tstep, tC = twide.mesh_psd_step_fn(port_mesh(n_c, n_t), PSD_CHAN,
                                       PSD_BINS)
    assert tC == jC
    jtail = np.zeros(jC, np.complex64)
    ttail = torch.zeros(tC, dtype=torch.complex64)
    for x in _psd_blocks(3, block):
        jfull, jtail = jax.jit(jstep)(jtail, x)
        tfull, ttail = tstep(ttail, torch.as_tensor(x))
        want = 10.0 ** (np.asarray(jfull, np.float64) / 10)
        got = 10.0 ** (tfull.double().numpy() / 10)
        assert got.shape == (PSD_CHAN, PSD_BINS)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * want.max())
        np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    flat = twide.flatten_band(tfull.numpy())
    np.testing.assert_array_equal(flat, jwide.flatten_band(tfull.numpy()))
    assert abs(int(np.argmax(flat)) - int(0.75 * PSD_CHAN * PSD_BINS)) <= 1


def _bin_ratio(got, want):
    """The worst bin's |got - want| over its bar 1e-4 * (want + the median
    of want): every bin held to its own size, the noise bins included."""
    return float(np.max(np.abs(got - want)
                        / (1e-4 * (want + np.median(want)))))


def _split_blocks(n_blocks, block):
    """Blocks whose halves (the two time shards of a 2x2 mesh) differ: a
    strong tone at 0.25 fs over 0.05 noise in the first half, a weak tone
    at 0.031 fs over 0.002 noise in the second."""
    rng = np.random.RandomState(6)
    half = block // 2
    out = []
    for k in range(n_blocks):
        n = np.arange(k * block, (k + 1) * block)
        noise = rng.randn(block) + 1j * rng.randn(block)
        x = np.where(n % block < half,
                     np.exp(2j * np.pi * 0.25 * n) + 0.05 * noise,
                     0.3 * np.exp(2j * np.pi * 0.031 * n) + 0.002 * noise)
        out.append(x.astype(np.complex64))
    return out


def test_mesh_psd_consensus_averages_linear_power_over_time_shards():
    """Time shards that see different spectra: the 2x2 consensus equals the
    JAX step bin by bin (1e-4 * (power + median floor)); so does the linear
    mean of the two halves' own spectra (a 2x1 mesh stepping through the
    halves with the raw tail carried), while the mean of the halves' dB --
    per-time-shard dB followed by a pmean -- misses the bar by far."""
    block = 4096
    jstep, jC = jwide.mesh_psd_step_fn(jax_mesh(2, 2), PSD_CHAN, PSD_BINS)
    tstep, _ = twide.mesh_psd_step_fn(port_mesh(2, 2), PSD_CHAN, PSD_BINS)
    hstep, _ = twide.mesh_psd_step_fn(port_mesh(2, 1), PSD_CHAN, PSD_BINS)
    jtail = np.zeros(jC, np.complex64)
    ttail = htail = torch.zeros(jC, dtype=torch.complex64)
    for x in _split_blocks(2, block):
        jfull, jtail = jax.jit(jstep)(jtail, x)
        tfull, ttail = tstep(ttail, torch.as_tensor(x))
        want = 10.0 ** (np.asarray(jfull, np.float64) / 10)
        halves = []
        for h in (x[:block // 2], x[block // 2:]):
            db, htail = hstep(htail, torch.as_tensor(h))
            halves.append(db.double().numpy())
        lin = np.mean([10.0 ** (d / 10) for d in halves], axis=0)
        db_mean = 10.0 ** (np.mean(halves, axis=0) / 10)
        assert _bin_ratio(10.0 ** (tfull.double().numpy() / 10), want) <= 1
        assert _bin_ratio(lin, want) <= 1
        assert _bin_ratio(db_mean, want) > 100


PRECONDITIONS = {
    "shard_not_whole_commutator_loads": lambda: _port_block(S_=4094),
    "shard_shorter_than_history": lambda: _port_block(S_=512),
    "channels_not_divisible": lambda: tshard.sharded_wideband_stream_block(
        TSPEC, port_mesh(3, 2), N_CHAN, S, taps=TAPS),
    # 64 taps an arm at 32 channels: a tail of 2048 raw samples, and a
    # stage-1 piece of 32 * 1024 / 32 = 1024
    "piece_shorter_than_channelizer_tail": lambda:
        tshard.sharded_wideband_capture_fn(
            TSPEC, port_mesh(32, 1), N_CHAN, 1024,
            taps=lowpass_taps(N_CHAN, taps_per_arm=64)),
    "psd_block_not_whole_frames": lambda: twide.mesh_psd_step_fn(
        port_mesh(4, 2), PSD_CHAN, PSD_BINS)[0](
            torch.zeros(128, dtype=torch.complex64),
            torch.zeros(3 * 512, dtype=torch.complex64)),
}


@pytest.mark.parametrize("make", PRECONDITIONS.values(),
                         ids=PRECONDITIONS.keys())
def test_preconditions_raise(make):
    """Each precondition the JAX package leaves to a shape error raises
    ValueError: S % mesh.channel, S >= H, n_chan % mesh.channel, a stage-1
    piece of at least stream_tail_len samples, and whole PSD frames a time
    shard."""
    assert history_len(TSPEC) == H
    with pytest.raises(ValueError):
        make()
