"""Checkpoint/resume of the port's streaming state
(tpu_ofdm_torch/stream/checkpoint.py) against the JAX package's: the JAX
test_resume_recovers_straddling_frame run in both packages on the same
stream gives the same frames; a JAX checkpoint, restored with Orbax and
put through rx_stream.carry_from_jax, continues in a port executor to the
same frames; a save reloads; a mismatched block size, leaf count, shape or
dtype raises."""

import functools
import json

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig, StreamConfig
from tpu_ofdm.modem import rx_stream as jrs
from tpu_ofdm.stream import checkpoint as jck
from tpu_ofdm.stream.executor import StreamExecutor as JaxExecutor
from tpu_ofdm.utils.device_io import to_host as jax_to_host
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.modem import rx_stream as trs
from tpu_ofdm_torch.modem import tx_stream as tts
from tpu_ofdm_torch.stream import block as tblock
from tpu_ofdm_torch.stream import checkpoint as tck
from tpu_ofdm_torch.stream.executor import StreamExecutor, tree_leaves

BS = 2048
CFG = OfdmConfig(modulation="qpsk", max_payload_bytes=64)
TSPEC = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
SC = StreamConfig(block_size=BS, max_frames_per_block=4)
TSC = tconfig.StreamConfig(block_size=BS, max_frames_per_block=4)
H = jrs.history_len(CFG.spec)
PAYLOADS = [b"before checkpoint", b"straddles the cut"]


def key(f):
    return (f["payload"], f["frame_num"], f["abs_start"], f["crc_ok"])


@functools.lru_cache(maxsize=None)
def _stream():
    """tests/test_checkpoint.py's stream, its frames from the golden model:
    gaps of 500 and 2950 zeros, so frame 1 straddles the boundary between
    block 1 and block 2; zero-padded to whole blocks."""
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    parts = []
    for i, (p, gap) in enumerate(zip(PAYLOADS, [500, 2950])):
        parts += [np.zeros(gap), G.tx_frame(gp, p, i)]
    stream = np.concatenate(parts + [np.zeros(400)]).astype(np.complex64)
    n_blocks = -(-len(stream) // BS)
    return np.concatenate([stream, np.zeros(n_blocks * BS - len(stream),
                                            np.complex64)])


def _port_ex():
    return StreamExecutor(trs.rx_stream_block(TSPEC, TSC), BS, device="cpu")


def _jax_ex():
    return JaxExecutor(jrs.rx_stream_block(CFG.spec, SC), BS, donate=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run: 2 blocks, save_state, a fresh executor
    load_state and drain (each JAX executor compiles its step once, so the
    tests share this run)."""
    pad = _stream()
    path = tmp_path_factory.mktemp("jax") / "ckpt"
    ex1 = _jax_ex()
    outs_a = [jax_to_host(ex1.push(pad[i * BS:(i + 1) * BS]))
              for i in range(2)]
    jck.save_state(str(path), ex1, meta={"note": "mid-capture"})
    ex2 = _jax_ex()
    meta = jck.load_state(str(path), ex2)
    assert jck.resume_step(meta) == 2
    outs_b = ex2.run(pad[2 * BS:], drain=True)
    return {"path": path, "outs_a": outs_a,
            "frames": sorted(map(key, jrs.collect_frames(
                outs_a + list(outs_b), BS, H)))}


def test_resume_recovers_straddling_frame_in_both_packages(tmp_path,
                                                           jax_run):
    """Checkpoint after 2 blocks, with a frame straddling the cut, in each
    package; each resumed executor decodes it, and both report the frames
    of the port's uninterrupted run."""
    pad = _stream()
    ex1 = _port_ex()
    outs_a = [ex1.push(pad[i * BS:(i + 1) * BS]) for i in range(2)]
    tck.save_state(str(tmp_path / "c"), ex1, meta={"note": "mid-capture"})
    ex2 = _port_ex()
    meta = tck.load_state(str(tmp_path / "c"), ex2)
    assert tck.resume_step(meta) == 2 and meta["note"] == "mid-capture"
    outs_b = ex2.run(pad[2 * BS:], drain=True)
    got = sorted(map(key, trs.collect_frames(outs_a + outs_b, BS, H)))
    want = sorted(map(key, trs.collect_frames(
        _port_ex().run(pad, drain=True), BS, H)))
    assert got == jax_run["frames"] == want
    assert [k[0] for k in got] == sorted(PAYLOADS)
    assert all(k[3] for k in got)


def test_meta_json_has_the_jax_keys(tmp_path, jax_run):
    pad = _stream()
    ex = _port_ex()
    for i in range(2):
        ex.push(pad[i * BS:(i + 1) * BS])
    tck.save_state(str(tmp_path / "t"), ex, meta={"note": "mid-capture"})
    got = json.loads((tmp_path / "t" / "meta.json").read_text())
    want = json.loads((jax_run["path"] / "meta.json").read_text())
    assert got == want
    assert got["block_name"] == "ofdm_rx_stream" and got["n_leaves"] == 2


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    """The JAX executor's checkpoint after 2 blocks: its leaves restored
    with Orbax and converted with carry_from_jax, a port executor
    continues the stream to the JAX package's frames."""
    import orbax.checkpoint as ocp

    path = jax_run["path"]
    meta = json.loads((path / "meta.json").read_text())
    leaves = ocp.PyTreeCheckpointer().restore(str(path / "state"))
    ex = _port_ex()
    ex.state = trs.carry_from_jax(
        [leaves[f"leaf_{i}"] for i in range(meta["n_leaves"])], ex.device)
    ex.samples_in = meta["samples_in"]
    outs_b = ex.run(_stream()[2 * BS:], drain=True)
    got = (jrs.collect_frames(jax_run["outs_a"], BS, H)
           + trs.collect_frames(outs_b, BS, H))
    assert sorted(map(key, got)) == jax_run["frames"]
    assert int(outs_b[0].block_index) == 2


@pytest.mark.parametrize("which", ["rx", "tx"])
def test_save_on_cpu_reloads(tmp_path, which):
    """Every leaf back with its dtype and values; the TX carry (a view of a
    larger buffer) is saved compact."""
    if which == "rx":
        ex = _port_ex()
        ex.push(torch.as_tensor(_stream()[:BS]))
        make = _port_ex
    else:
        def make():
            return StreamExecutor(tts.tx_stream_block(TSPEC, TSC), BS,
                                  device="cpu")
        ex = make()
        ti, _ = tts.queue_tx_in(TSPEC, 4, [b"hello", b"world"], device="cpu")
        ex.push(ti)
    tck.save_state(str(tmp_path / "c"), ex)
    size = (tmp_path / "c" / "state.pt").stat().st_size
    nbytes = sum(v.numel() * v.element_size() for v in tree_leaves(ex.state))
    assert size < nbytes + 4096
    ex2 = make()
    meta = tck.load_state(str(tmp_path / "c"), ex2)
    assert tck.resume_step(meta) == 1 and ex2.samples_in == BS
    for a, b in zip(tree_leaves(ex.state), tree_leaves(ex2.state)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_mismatched_block_size_rejected(tmp_path):
    tck.save_state(str(tmp_path / "c"), _port_ex())
    other = StreamExecutor(trs.rx_stream_block(TSPEC, TSC), 2 * BS,
                           device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        tck.load_state(str(tmp_path / "c"), other)


def test_mismatched_leaf_count_rejected(tmp_path):
    tck.save_state(str(tmp_path / "c"), _port_ex())
    stateless = StreamExecutor(tblock.multiply_const(2.0), BS, device="cpu")
    with pytest.raises(ValueError, match="2 leaves, block expects 0"):
        tck.load_state(str(tmp_path / "c"), stateless)


def test_mismatched_shape_rejected(tmp_path):
    tck.save_state(str(tmp_path / "c"), _port_ex())
    spec = tconfig.OfdmConfig(modulation="qpsk", max_payload_bytes=256).spec
    other = StreamExecutor(trs.rx_stream_block(spec, TSC), BS, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_state(str(tmp_path / "c"), other)


def test_mismatched_dtype_rejected(tmp_path):
    """A hand-edited checkpoint whose step counter became int64."""
    tck.save_state(str(tmp_path / "c"), _port_ex())
    state = tmp_path / "c" / "state.pt"
    saved = torch.load(state, weights_only=True)
    saved["leaf_1"] = saved["leaf_1"].to(torch.int64)
    torch.save(saved, state)
    with pytest.raises(ValueError, match="dtype mismatch"):
        tck.load_state(str(tmp_path / "c"), _port_ex())
