"""The port's channelizer (plain version of the CUDA pfb kernel, and the
streaming Block around it) against the JAX package: its XLA `channelize`
chain and its fused Pallas kernel run in TPU interpret mode, as
tests/test_kernels_pfb.py runs it.  Bar: atol 2e-4 * max|want|, the bar of
tests/test_kernels_pfb.py.  The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py, and its source on the CPU by
tests/test_torch_pfb_emulated.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tests.golden import golden_ofdm as G
from tpu_ofdm.kernels import pfb as jpfb
from tpu_ofdm.spectrum import channelizer as jch
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.kernels import pfb as tpfb
from tpu_ofdm_torch.spectrum import channelizer as tch
from tpu_ofdm_torch.stream import executor as tex


def _rand(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _poly(n_chan, taps=None):
    taps = tch.lowpass_taps(n_chan) if taps is None else taps
    return torch.as_tensor(tch.polyphase_decompose(taps, n_chan))


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("n_chan", [8, 64, 128, 256, 512])
def test_plain_matches_jax_xla_and_pallas(n_chan):
    taps = jch.lowpass_taps(n_chan)
    rows = 40 if n_chan > 128 else 300
    x = _rand(n_chan * rows, seed=n_chan)
    xla = np.asarray(jch.channelize(jnp.asarray(x), n_chan, taps))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jpfb.channelize_fused(jnp.asarray(x), n_chan,
                                                  taps))
    got = tpfb.channelize_fused(torch.as_tensor(x), _poly(n_chan, taps))
    assert got.dtype == torch.complex64 and got.shape == (rows, n_chan)
    _assert_close(got, xla)
    _assert_close(got, pallas)
    _assert_close(tch.channelize(torch.as_tensor(x), n_chan, taps), xla)


@pytest.mark.parametrize("n_chan", [64, 512])
def test_two_step_tail_carry_matches_oneshot(n_chan):
    """Two tail-carried steps == one pass, including the FIR lookback
    across the step boundary."""
    taps = tch.lowpass_taps(n_chan)
    C = tpfb.tail_len(n_chan, 8)
    n0, n1 = n_chan * 24, n_chan * 16
    x = torch.as_tensor(_rand(n0 + n1, seed=5))
    poly = _poly(n_chan, taps)
    want = np.asarray(jch.channelize(jnp.asarray(x.numpy()), n_chan, taps))
    a = tpfb.channelize_fused(x[:n0], poly, tail=torch.zeros(
        C, dtype=torch.complex64))
    b = tpfb.channelize_fused(x[n0:], poly, tail=x[n0 - C:n0])
    _assert_close(torch.cat([a, b]), want)
    np.testing.assert_array_equal(
        a.numpy(), tpfb.channelize_fused(x[:n0], poly).numpy())


def test_tail_len_and_supported_match_jax():
    for n_chan in (2, 8, 48, 64, 128, 192, 256, 384, 512, 1024):
        assert tpfb.supported(n_chan) == jpfb.supported(n_chan), n_chan
        for j in (1, 4, 8, 16):
            assert tpfb.tail_len(n_chan, j) == jpfb.tail_len(n_chan, j)
        taps = jch.lowpass_taps(n_chan)
        assert (tch.stream_tail_len(n_chan, taps)
                == jch.stream_tail_len(n_chan, taps))


def test_taps_and_polyphase_bit_exact():
    for n_chan, tpa in ((8, 8), (64, 8), (512, 8), (16, 12)):
        np.testing.assert_array_equal(tch.lowpass_taps(n_chan, tpa),
                                      jch.lowpass_taps(n_chan, tpa))
    taps = jch.lowpass_taps(48, 5)[:-7]          # a ragged last arm
    np.testing.assert_array_equal(tch.polyphase_decompose(taps, 48),
                                  jch.polyphase_decompose(taps, 48))


def test_tone_lands_in_right_channel():
    """A tone at k*fs/N appears (near-flat) in channel k (the port of
    tests/test_spectrum.py's test: an arm-order or twiddle slip mirrors the
    channels)."""
    n_chan, k = 16, 5
    t = np.arange(n_chan * 256)
    x = torch.as_tensor(
        np.exp(2j * np.pi * k / n_chan * t).astype(np.complex64))
    for y in (tch.channelize(x, n_chan, tch.lowpass_taps(n_chan)),
              tpfb.channelize_fused(x, _poly(n_chan))):
        pwr = (y.abs() ** 2).mean(0).numpy()
        assert np.argmax(pwr) == k
        assert pwr[k] > 50 * (np.sum(pwr) - pwr[k]) / (n_chan - 1)


def test_resume_from_jax_tail():
    """A tail saved by the JAX channelize_stream resumes in the port."""
    n_chan = 64
    taps = jch.lowpass_taps(n_chan)
    poly_j = jnp.asarray(jch.polyphase_decompose(taps, n_chan))
    C = jch.stream_tail_len(n_chan, taps)
    x = _rand(n_chan * 64, seed=8)
    half = n_chan * 40
    _, tail = jch.channelize_stream(jnp.asarray(x[:half]),
                                    jnp.zeros(C, jnp.complex64), n_chan,
                                    taps, poly_j)
    want, want_tail = jch.channelize_stream(jnp.asarray(x[half:]), tail,
                                            n_chan, taps, poly_j)
    got, got_tail = tch.channelize_stream(
        torch.as_tensor(x[half:]), torch.tensor(np.asarray(tail)), n_chan,
        _poly(n_chan, taps))
    _assert_close(got, want)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


@pytest.mark.parametrize("block", [8 * 128, 8 * 16])
def test_channelizer_block_matches_jax(block):
    """Through both executors with drain; block 8 * 16 is shorter than the
    tail, so the new tail comes from [tail | x]."""
    n_chan = 8
    taps = jch.lowpass_taps(n_chan)
    x = _rand(8 * 512, seed=6)
    jx = jex.StreamExecutor(jch.channelizer_block(n_chan, taps), block,
                            donate=False)
    want = np.concatenate([np.asarray(o) for o in jx.run(x, drain=True)])
    ex = tex.StreamExecutor(tch.channelizer_block(n_chan, taps), block,
                            device="cpu")
    got = torch.cat(ex.run(torch.as_tensor(x), drain=True))
    _assert_close(got, want)
    np.testing.assert_array_equal(ex.state.numpy(), np.asarray(jx.state))


def test_synthesis_matches_jax():
    n_chan = 8
    f = _rand(300, seed=2)
    bursts = [(1, 10, f), (5, 100, f[:120] * 2), (1, 400, f[:50])]
    got = tch.synthesize_bursts(8 * 600, n_chan, bursts)
    np.testing.assert_array_equal(got, jch.synthesize_bursts(
        8 * 600, n_chan, bursts))
    chans = np.zeros((64, n_chan), np.complex64)
    chans[:, 3] = _rand(64, seed=4)
    np.testing.assert_array_equal(tch.synthesize_wideband(chans),
                                  jch.synthesize_wideband(chans))


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.as_tensor(_rand(64 * 20, seed=1))
    poly = _poly(64)
    before = tpfb.channelize_fused.launches
    got = tpfb.channelize_fused(x, poly)
    torch.testing.assert_close(got, tpfb.channelize_fused_plain(x, poly),
                               rtol=0, atol=0)
    assert tpfb.channelize_fused.launches == before


@pytest.mark.parametrize("bad", ["x_dtype", "ragged", "n_chan", "short_tail",
                                 "poly_dtype", "layout"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(64 * 8, dtype=torch.complex64)
    poly = _poly(64)
    tail = None
    if bad == "x_dtype":
        x = x.to(torch.complex128)
    elif bad == "ragged":
        x = x[:-3]
    elif bad == "n_chan":
        x, poly = torch.zeros(48 * 8, dtype=torch.complex64), _poly(48)
    elif bad == "short_tail":
        tail = torch.zeros(64, dtype=torch.complex64)
    elif bad == "poly_dtype":
        poly = poly.double()
    layout = "cols" if bad == "layout" else "row"
    with pytest.raises((TypeError, ValueError)):
        tpfb.channelize_fused(x, poly, tail=tail, layout=layout)


@pytest.mark.parametrize("layout", ["cols", "channel", None])
def test_stream_rejects_an_unknown_layout(layout):
    x = torch.zeros(64 * 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="layout"):
        tch.channelize_stream(x, torch.zeros(512, dtype=torch.complex64),
                              64, _poly(64), layout=layout)


COVERED = [n for n in range(1, 513) if tpfb.supported(n)]


@pytest.mark.parametrize("n_chan", COVERED)
def test_chan_layout_is_the_row_layout_transposed(n_chan):
    """At every channel count pfb covers, the channel-major output is the
    row output's `.t().contiguous()` bit for bit: channelize_fused with a
    zero tail, then channelize_stream's two steps joined by its carried
    tail (the wideband receiver's call)."""
    poly = _poly(n_chan)
    C = tpfb.tail_len(n_chan, poly.shape[0])
    rows = 12
    x = torch.as_tensor(_rand(2 * rows * n_chan, seed=n_chan + 3))
    a, b = x[:rows * n_chan], x[rows * n_chan:]
    got = tpfb.channelize_fused(a, poly, layout="chan")
    assert got.shape == (n_chan, rows) and got.is_contiguous()
    assert torch.equal(got, tpfb.channelize_fused(a, poly).t().contiguous())
    tail = torch.zeros(C, dtype=torch.complex64)
    for step in (a, b):
        row, row_tail = tch.channelize_stream(step, tail, n_chan, poly)
        chan, chan_tail = tch.channelize_stream(step, tail, n_chan, poly,
                                                layout="chan")
        assert chan.shape == (n_chan, rows) and chan.is_contiguous()
        assert torch.equal(chan, row.t().contiguous())
        assert torch.equal(chan_tail, row_tail)
        tail = row_tail
    assert tail.abs().sum() > 0


def test_chan_layout_of_a_batched_stream():
    """The torch route of a batched stream hands out each row's channels
    channel-major too: (B, N, rows), the row layout's last two axes
    swapped."""
    n_chan, rows = 16, 10
    x = torch.as_tensor(_rand(2 * rows * n_chan, seed=9)).reshape(2, -1)
    tail = torch.as_tensor(_rand(2 * 128, seed=10)).reshape(2, -1)
    row, _ = tch.channelize_stream(x, tail, n_chan, _poly(n_chan))
    chan, _ = tch.channelize_stream(x, tail, n_chan, _poly(n_chan),
                                    layout="chan")
    assert chan.shape == (2, n_chan, rows) and chan.is_contiguous()
    assert torch.equal(chan, row.transpose(-1, -2))


def _swizzle(nl: int, kl: int) -> int:
    """csrc/pfb.cu stage_swizzle<NL>."""
    return (kl >> 1) & 15 if nl >= 32 else (kl * (16 // nl)) & 15


def _bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


@pytest.mark.parametrize("n_chan", COVERED)
def test_chan_stage_is_free_of_bank_conflicts(n_chan):
    """A model of csrc/pfb.cu's channel-major stage: each frame's bins go
    to stage row k at column f ^ stage_swizzle(kl) (kl the lane's bin lane,
    bitrev of its lane in the frame), row stride R rounded up to 16.  Every
    half-warp's 8-byte stores of one p fall on 16 distinct bank pairs; a
    quarter-warp's 16-byte loads of a channel's run on 8 distinct 16-byte
    slots (where a channel's run is whole groups of 8 pairs: at every
    channel count but 384); and (k, f) -> stage slot is one to one inside
    the stage."""
    nl = min(n_chan, 32)
    P, fpw, log_nl = n_chan // nl, 32 // nl, nl.bit_length() - 1
    R = (4096 if n_chan <= 128 else 8192) // n_chan
    RS = (R + 15) & ~15
    slots = {}
    for g in range(-(-R // fpw)):
        for p in range(P):
            banks = [[], []]
            for lane in range(32):
                lp, f = lane % nl, g * fpw + lane // nl
                kl = _bitrev(lp, log_nl)
                k = p + P * kl
                slot = k * RS + (f ^ _swizzle(nl, kl))
                assert (f ^ _swizzle(nl, kl)) < RS
                if f < R:
                    slots[slot] = (k, f)
                banks[lane // 16].append(slot % 16)
            for half in banks:
                assert len(set(half)) == 16
    assert len(slots) == R * n_chan
    pairs = (R + 1) // 2
    for i0 in range(0, n_chan * pairs, 8):
        loads = []
        for i in range(i0, min(i0 + 8, n_chan * pairs)):
            k, t = i // pairs, 2 * (i % pairs)
            s = _swizzle(nl, k // P)
            loads.append((k * RS // 2 + ((t ^ s) >> 1)) % 8)
        if pairs % 8 == 0:
            assert len(set(loads)) == len(loads)


@pytest.mark.parametrize("n_chan", [8, 64, 512])
def test_channelize_fused_zero_tail_is_channelize(n_chan):
    """channelize on the card runs channelize_fused with a zero tail (the
    golden model's zero history): on the CPU that route equals the port's
    and the JAX package's channelize and the golden model, ragged tail
    dropped."""
    taps = jch.lowpass_taps(n_chan)
    rows = 24 if n_chan > 128 else 200
    x = _rand(n_chan * rows + 5, seed=n_chan + 1)
    n = rows * n_chan
    got = tpfb.channelize_fused(torch.as_tensor(x[:n]), _poly(n_chan, taps))
    _assert_close(got, jch.channelize(jnp.asarray(x), n_chan, taps))
    _assert_close(got, G.pfb_channelize(x.astype(np.complex128), n_chan,
                                        taps))
    _assert_close(tch.channelize(torch.as_tensor(x), n_chan, taps), got)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("n_chan", [8, 48, 64, 128, 384, 512, 640])
def test_channelize_route_for_every_case(device, ndim, n_chan):
    """CPU: the chain in torch ops ("torch"); the card: pfb for a 1-D
    stream at a channel count it covers, the same torch chain otherwise, as
    the JAX package takes its XLA chain there (never the kernel's plain
    version)."""
    route = tch.channelize_route(device, ndim, n_chan)
    if device == "cpu":
        assert route == "torch"
    else:
        assert route == ("kernel" if ndim == 1 and tpfb.supported(n_chan)
                         else "torch")


def test_channelize_refuses_an_uncovered_route():
    """The decision reaches the public functions: a batched x on a device
    that is not the CPU (here the meta device) takes the torch chain, not
    the kernel, and gives the JAX chain's shapes."""
    x = torch.zeros((2, 64 * 8), dtype=torch.complex64, device="meta")
    before = tpfb.channelize_fused.launches
    assert tch.channelize(x, 64, tch.lowpass_taps(64)).shape == (2, 8, 64)
    out, tail = tch.channelize_stream(
        x, torch.zeros((2, 512), dtype=torch.complex64, device="meta"), 64,
        _poly(64).to("meta"))
    assert out.shape == (2, 8, 64) and tail.shape == (2, 512)
    assert tpfb.channelize_fused.launches == before
