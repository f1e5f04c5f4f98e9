"""The port's streaming receiver against the JAX package's on the same
stream: block 2^14, K = 8, frames straddling block seams, CFO and noise,
through StreamExecutor.run(drain=True) and collect_frames.  Same
tolerances as tests/test_torch_rx.py.  Also: the port resumes mid-stream
from a JAX carry and reports the same frames."""

import functools

import numpy as np
import torch

import tests.golden.golden_ofdm as G
from tpu_ofdm.config import OfdmConfig, StreamConfig
from tpu_ofdm.modem import rx_stream as jrs
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.modem import rx_stream as trs
from tpu_ofdm_torch.stream import executor as tex

SPEC = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
S = 1 << 14
SC = StreamConfig(block_size=S, max_frames_per_block=8)
H = jrs.history_len(SPEC)
# frame starts straddling the seams at S, 2S and 4S, and one mid-block
POSITIONS = [S - 700, 2 * S - 1, 2 * S + 6000, 4 * S - 1500]


@functools.lru_cache(maxsize=None)
def _stream():
    rng = np.random.RandomState(11)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    n = 5 * S - 3000
    x = np.zeros(n, np.complex128)
    for i, p in enumerate(POSITIONS):
        msg = rng.randint(0, 256, 30 + 50 * i).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=i)
        x[p:p + len(f)] += f
    x *= np.exp(2j * np.pi * -0.37 * np.arange(n) / 64)
    x += 0.04 * (rng.randn(n) + 1j * rng.randn(n))
    return x.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _jax_outs():
    ex = jex.StreamExecutor(jrs.rx_stream_block(SPEC, SC), S)
    return ex.run(_stream(), drain=True)


def _port_frames(outs):
    return trs.collect_frames(outs, block_size=S, hist=trs.history_len(SPEC))


def _assert_same(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for k in ("payload", "payload_len", "frame_num", "crc_ok", "hdr_ok",
                  "int_cfo"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["abs_start"] - b["abs_start"]) <= 2, (a, b)
        np.testing.assert_allclose(a["fine_cfo"], b["fine_cfo"], atol=1e-3)
        np.testing.assert_allclose(a["evm"], b["evm"], rtol=1e-3)


def test_stream_matches_jax_across_seams():
    ref = jrs.collect_frames(_jax_outs(), block_size=S, hist=H)
    ex = tex.StreamExecutor(trs.rx_stream_block(SPEC, SC), S)
    port = _port_frames(ex.run(torch.as_tensor(_stream()), drain=True))
    _assert_same(port, ref)
    assert trs.history_len(SPEC) == H
    assert [f["frame_num"] for f in port] == list(range(len(POSITIONS)))
    assert all(f["crc_ok"] for f in port)
    for f, p in zip(port, POSITIONS):
        assert p <= f["abs_start"] <= p + SPEC.cp_len


def test_resume_from_jax_carry():
    """Two JAX steps, then the port continues from the JAX carry."""
    stream = _stream()
    blocks, _ = jex.pad_to_blocks(stream, S)
    jx = jex.StreamExecutor(jrs.rx_stream_block(SPEC, SC), S)
    for i in range(2):
        jx.push(blocks[i])
    ex = tex.StreamExecutor(trs.rx_stream_block(SPEC, SC), S)
    ex.state = trs.carry_from_jax(jx.state, ex.device)
    assert int(ex.state[1]) == 2
    outs = [ex.push(torch.as_tensor(b)) for b in blocks[2:]]
    outs.append(ex.push(torch.zeros(S, dtype=torch.complex64)))   # drain
    ref = [f for f in jrs.collect_frames(_jax_outs(), block_size=S, hist=H)
           if f["abs_start"] >= 2 * S - H]     # owned by steps >= 2
    assert len(ref) == 3
    _assert_same(_port_frames(outs), ref)
    hist, step = trs.carry_to_jax(ex.state)
    assert hist.dtype == np.complex64 and hist.shape == (H,)
    assert step.dtype == np.int32 and int(step) == len(blocks) + 1


def test_new_history_is_a_copy():
    blk = trs.rx_stream_block(SPEC, SC)
    state = blk.init(torch.device("cpu"))
    x = torch.as_tensor(_stream()[:S])
    (hist, step), out = blk.apply(state, x)
    want = x[S - H:].clone()
    x.zero_()                        # the caller recycles its block
    torch.testing.assert_close(hist, want, rtol=0, atol=0)
    assert int(step) == 1 and int(out.block_index) == 0


def test_pad_to_blocks_matches_jax():
    x = _stream()[:S + 123]
    got, n = tex.pad_to_blocks(torch.as_tensor(x), S)
    want, m = jex.pad_to_blocks(x, S)
    assert n == m == S + 123
    np.testing.assert_array_equal(got.numpy(), want)
