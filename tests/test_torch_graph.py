"""The port's flowgraph layer (tpu_ofdm_torch/stream/graph.py) and
declarative specs (tpu_ofdm_torch/grc.py) against the JAX package's: the
cases of tests/test_graph.py and tests/test_grc_registry.py run on the
port; the registry has the JAX registry's keys and parameter names; every
entry is built in both packages and stepped twice on the same input; the
four examples/*.json build and run in both with the same outputs; the
FlowgraphError cases raise with the JAX package's messages.

Tolerances, against max(1, max|want|): 1e-5 for elementwise math, the FFT
FIRs and the IIR scan; 1e-4 for moving_average (the JAX package's float32
prefix sum over a block of 4096, ulp 2.4e-4 there), the channelizer (a
matmul DFT in the JAX package, torch.fft here) and PSD frames compared as
linear power (the psd kernel's bar); 1e-3 for freq_xlating_fir, whose
float32 mixer phase reaches ~2600 rad in a block of 4096 (ulp 2.4e-4
rad).  RX outputs compare the detection mask exactly, and the frames in
the valid slots exactly; the channel's noise differs by construction
(torch.Generator against jax.random), so its cases compare the noiseless
channel and the realized SNR."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

import tests.golden.golden_ofdm as G
from tpu_ofdm import grc as jgrc
from tpu_ofdm.config import OfdmConfig as JOfdmConfig
from tpu_ofdm.modem import tx_stream as jtxs
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch import grc
from tpu_ofdm_torch.config import OfdmConfig
from tpu_ofdm_torch.modem.rx_stream import collect_frames, history_len
from tpu_ofdm_torch.modem.tx_stream import empty_tx_in, queue_tx_in
from tpu_ofdm_torch.ops import firdes
from tpu_ofdm_torch.stream.block import (Block, chain, complex_to_mag_squared,
                                         fir_filter, multiply_const, nlog10,
                                         single_pole_iir, stateless)
from tpu_ofdm_torch.stream.executor import (StreamExecutor, to_device,
                                            tree_leaves, tree_map)
from tpu_ofdm_torch.stream.graph import Flowgraph, FlowgraphError

EXAMPLES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                         "examples", "*.json")))


def _run(block, x, block_size=256):
    return StreamExecutor(block, block_size, device="cpu").run(x)


# --- tests/test_graph.py on the port ----------------------------------------

def test_linear_graph_matches_chain():
    taps = firdes.low_pass(1.0, 8.0, 1.5, 0.75, ntaps=21)
    rng = np.random.RandomState(0)
    x = (rng.randn(512) + 1j * rng.randn(512)).astype(np.complex64)
    fg = Flowgraph("lin")
    fg.add("lp", fir_filter(taps)).add("mag", complex_to_mag_squared())
    fg.add_input("lp").connect("lp", "mag").set_outputs("mag")
    got = torch.cat(_run(fg.build(), x))
    want = torch.cat(_run(chain(fir_filter(taps), complex_to_mag_squared()),
                          x))
    assert torch.equal(got, want)


def test_fan_out_and_multi_output():
    fg = Flowgraph()
    fg.add("src", multiply_const(2.0))
    fg.add("a", multiply_const(10.0))
    fg.add("b", multiply_const(100.0))
    fg.add_input("src")
    fg.connect("src", "a").connect("src", "b")
    fg.set_outputs("a", "b")
    x = np.arange(8, dtype=np.float32)
    ya, yb = _run(fg.build(), x, block_size=8)[0]
    np.testing.assert_allclose(ya.numpy(), x * 20.0)
    np.testing.assert_allclose(yb.numpy(), x * 200.0)


def test_fan_in_tuple_input():
    fg = Flowgraph()
    fg.add("a", multiply_const(2.0)).add("b", multiply_const(3.0))
    fg.add("sum", stateless(lambda xy: xy[0] + xy[1], "add2"))
    fg.add_input("a").add_input("b")
    fg.connect("a", ("sum", 0)).connect("b", ("sum", 1))
    fg.set_outputs("sum")
    ex = StreamExecutor(fg.build(), 8, device="cpu")
    y = ex.push((np.ones(8, np.float32), np.full(8, 2.0, np.float32)))
    np.testing.assert_allclose(y.numpy(), 2.0 + 6.0)
    with pytest.raises(FlowgraphError, match="tuple of 2 inputs"):
        ex.block.apply(ex.state, torch.ones(8))
    with pytest.raises(FlowgraphError, match="expects 2 inputs, got 3"):
        ex.block.apply(ex.state, (torch.ones(8),) * 3)


def test_multi_port_source_output():
    fg = Flowgraph()
    fg.add("split", stateless(lambda x: (x * 1.0, x * -1.0), "split"))
    fg.add("neg", multiply_const(5.0))
    fg.add_input("split")
    fg.connect(("split", 1), "neg")
    fg.set_outputs(("split", 0), "neg")
    x = np.arange(4, dtype=np.float32)
    pos, neg = StreamExecutor(fg.build(), 4, device="cpu").push(x)
    np.testing.assert_allclose(pos.numpy(), x)
    np.testing.assert_allclose(neg.numpy(), -5.0 * x)


def test_hierarchical_composition():
    """A built Flowgraph is a Block and nests as a node."""
    inner = Flowgraph("inner")
    inner.add("m", multiply_const(3.0)).add_input("m").set_outputs("m")
    outer = Flowgraph("outer")
    outer.add("pre", multiply_const(2.0)).add("h", inner.build())
    outer.add_input("pre").connect("pre", "h").set_outputs("h")
    ex = StreamExecutor(outer.build(), 4, device="cpu")
    np.testing.assert_allclose(ex.push(np.ones(4, np.float32)).numpy(), 6.0)


def test_stateful_nodes_carry_state():
    fg = Flowgraph()
    fg.add("iir", single_pole_iir(0.5))
    fg.add_input("iir").set_outputs("iir")
    x = np.random.RandomState(1).randn(64).astype(np.float32)
    got = torch.cat(_run(fg.build(), x, block_size=16))
    want = torch.cat(_run(single_pole_iir(0.5), x, block_size=16))
    assert torch.equal(got, want)


def test_latency_adds_along_paths_and_stream_input_inherits():
    """The drain flushes the longest input->output path; a graph fed
    through a non-stream input is one too (the reference's rules)."""
    def blk(lat, stream=True):
        return Block(lambda d: (), lambda s, x: (s, x), latency=lat,
                     stream_input=stream)
    fg = Flowgraph()
    fg.add("a", blk(100)).add("b", blk(20)).add("c", blk(7, stream=False))
    fg.add_input("c").connect("c", "a").connect("a", "b")
    fg.set_outputs("b", "c")
    built = fg.build()
    assert built.latency == 127 and built.stream_input is False
    assert built.name == "flowgraph"


@pytest.mark.parametrize("graph", ["port", "jax"])
def test_validation_errors(graph):
    """Each FlowgraphError case raises, with the JAX package's message."""
    from tpu_ofdm.stream import block as jb
    from tpu_ofdm.stream import graph as jg
    from tpu_ofdm_torch.stream import block as tb
    from tpu_ofdm_torch.stream import graph as tg
    Gm, B = (tg, tb) if graph == "port" else (jg, jb)
    fg = Gm.Flowgraph()
    fg.add("a", B.multiply_const(1.0))
    with pytest.raises(Gm.FlowgraphError, match="duplicate"):
        fg.add("a", B.multiply_const(1.0))
    with pytest.raises(Gm.FlowgraphError, match="expected a Block, got int"):
        fg.add("z", 3)
    with pytest.raises(Gm.FlowgraphError, match="unknown node"):
        fg.connect("a", "zzz")
    with pytest.raises(Gm.FlowgraphError, match="unknown node"):
        Gm.Flowgraph().add("a", B.multiply_const(1.0)).set_outputs("zzz")
    with pytest.raises(Gm.FlowgraphError, match="set_outputs"):
        fg.add_input("a")
        fg.build()
    with pytest.raises(Gm.FlowgraphError, match="empty flowgraph"):
        Gm.Flowgraph().build()
    fg2 = Gm.Flowgraph()
    fg2.add("x", B.multiply_const(1.0)).add("y", B.multiply_const(1.0))
    fg2.connect("x", "y").connect("y", "x")
    fg2.set_outputs("x")
    with pytest.raises(Gm.FlowgraphError, match="cycle"):
        fg2.build()
    fg3 = Gm.Flowgraph()
    fg3.add("s", B.multiply_const(1.0)).add("d", B.multiply_const(1.0))
    fg3.connect("s", ("d", 1)).add_input("s").set_outputs("d")
    with pytest.raises(Gm.FlowgraphError, match="not dense"):
        fg3.build()
    fg4 = Gm.Flowgraph()
    fg4.add("s", B.multiply_const(1.0)).add("d", B.multiply_const(1.0))
    fg4.connect("s", "d")
    with pytest.raises(Gm.FlowgraphError, match="already connected"):
        fg4.connect("s", "d")
    with pytest.raises(Gm.FlowgraphError, match="already connected"):
        fg4.add_input("d")
    with pytest.raises(Gm.FlowgraphError, match="named port.*destination"):
        fg4.connect("s", ("d", "samples"))
    with pytest.raises(Gm.FlowgraphError, match="named port.*destination"):
        fg4.add_input(("s", "samples"))


def test_output_port_errors():
    fg = Flowgraph()
    fg.add("m", multiply_const(2.0)).add_input("m").set_outputs(("m", 1))
    with pytest.raises(FlowgraphError, match="single output; port 1"):
        StreamExecutor(fg.build(), 4, device="cpu").push(np.ones(4))
    fg = Flowgraph()
    fg.add("m", multiply_const(2.0)).add_input("m")
    fg.set_outputs(("m", "samples"))
    with pytest.raises(FlowgraphError, match="not a NamedTuple"):
        StreamExecutor(fg.build(), 4, device="cpu").push(np.ones(4))


SPEC = {
    "name": "psd",
    "blocks": [
        {"id": "lp", "type": "fir_filter",
         "params": {"taps": {"design": "low_pass", "gain": 1.0, "fs": 1.0,
                             "cutoff": 0.2, "transition_width": 0.05}}},
        {"id": "probe", "type": "spectrum_probe", "params": {"fft_len": 64}},
    ],
    "connections": [["lp", "probe"]],
    "inputs": ["lp"],
    "outputs": ["probe"],
}


def test_grc_build_and_run():
    n = 1 << 12
    tone = np.exp(2j * np.pi * 0.125 * np.arange(n)).astype(np.complex64)
    out = _run(grc.build(SPEC), tone, block_size=1 << 11)[-1]
    assert int(out.avg_db.argmax()) == 8  # 0.125 * 64


def test_grc_load_file(tmp_path):
    p = tmp_path / "g.json"
    p.write_text(json.dumps(SPEC))
    blk = grc.load(str(p))
    assert isinstance(blk, Block) and blk.name == "psd"


@pytest.mark.parametrize("spec,match", [
    ({"blocks": [{"id": "x", "type": "nope"}], "outputs": ["x"]},
     "unknown block type"),
    ({"blocks": [{"id": "x", "type": "nlog10", "params": {"bogus": 1}}],
      "outputs": ["x"]}, "unknown params"),
    ({"blocks": [{"id": "x", "type": "fir_filter",
                  "params": {"taps": {"design": "zzz"}}}],
      "inputs": ["x"], "outputs": ["x"]}, "unknown tap design"),
    ({"blocks": [{"id": "x", "type": "ofdm_rx_stream",
                  "params": {"fft_lenn": 64}}],
      "inputs": ["x"], "outputs": ["x"]}, "bad params"),
], ids=["type", "params", "tap_design", "open_ended_params"])
def test_grc_errors_match_jax(spec, match):
    for g in (grc, jgrc):
        with pytest.raises(g.FlowgraphError, match=match):
            g.build(spec)


def test_grc_user_registration():
    @grc.register("times_seven")
    def make(k=7.0):
        return multiply_const(k)

    try:
        blk = grc.build({"blocks": [{"id": "t", "type": "times_seven"}],
                         "inputs": ["t"], "outputs": ["t"]})
        y = StreamExecutor(blk, 4, device="cpu").push(np.ones(4, np.float32))
        np.testing.assert_allclose(y.numpy(), 7.0)
    finally:
        grc.unregister("times_seven")
    assert "times_seven" not in grc.REGISTRY


# --- tests/test_grc_registry.py on the port, against the JAX package --------

BS = 4096
_OFDM = {"block_size": BS, "max_frames_per_block": 4,
         "modulation": "qpsk", "max_payload_bytes": 64}
_LP = {"design": "low_pass", "gain": 1.0, "fs": 1.0, "cutoff": 0.2,
       "transition_width": 0.1}
_SPEC64 = JOfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
_TSPEC64 = OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec


def _c64(seed=0, n=BS):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)


def _f32(seed=0, n=BS):
    return np.abs(np.random.RandomState(seed).randn(n)).astype(np.float32) + 0.1


def _rx_in():
    """Two frames of the golden model over weak noise."""
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    x = 0.01 * _c64(9)
    for pos, num in ((300, 3), (2200, 4)):
        f = G.tx_frame(gp, b"registry frame %d" % num, num)
        x[pos: pos + len(f)] += f.astype(np.complex64)
    return x


def _tx_in(pkg):
    msgs = [b"registry round trip"]
    if pkg == "jax":
        return jtxs.queue_tx_in(_SPEC64, 4, msgs)[0]
    return queue_tx_in(_TSPEC64, 4, msgs, device="cpu")[0]


def _same(i):
    return lambda pkg: i()


def _rx_pick(out):
    """valid mask, then each valid slot's frame fields and start."""
    res = out.result
    valid = np.asarray(res.valid.cpu() if hasattr(res.valid, "cpu")
                       else res.valid)
    f = res.frames
    picks = [valid]
    for a in (f.payload, f.payload_len, f.frame_num, f.crc_ok, res.starts):
        a = np.asarray(a.cpu() if hasattr(a, "cpu") else a)
        picks.append(a[valid])
    return picks


def _tx_pick(out):
    return [out.samples, out.accepted, out.n_pending]


# type -> (params, input(pkg), pick(out) -> leaves, tol)
CASES = {
    "multiply_const": ({"k": 2.0}, _same(_c64), None, 1e-5),
    "add_const": ({"k": 1.0 + 0j}, _same(_c64), None, 1e-5),
    "complex_to_mag_squared": ({}, _same(_c64), None, 1e-5),
    "nlog10": ({}, _same(_f32), None, 1e-5),
    "stream_to_vector": ({"vlen": 64}, _same(_c64), None, 1e-5),
    "vector_to_stream": ({}, lambda pkg: _c64().reshape(-1, 64), None, 1e-5),
    "delay": ({"n": 17}, _same(_c64), None, 1e-5),
    # the JAX package's float32 prefix over a block reaches ~4000 (ulp
    # 2.4e-4); the port's keeps float64 partials
    "moving_average": ({"n": 8}, _same(_f32), None, 1e-4),
    "single_pole_iir": ({"alpha": 0.1}, _same(_f32), None, 1e-5),
    "fir_filter": ({"taps": _LP}, _same(_c64), None, 1e-5),
    "freq_xlating_fir": ({"taps": _LP, "center_freq_rel": 0.1}, _same(_c64),
                         None, 1e-3),
    "interpolating_fir": ({"taps": _LP, "interp": 2}, _same(_c64), None,
                          1e-5),
    "rational_resampler": ({"taps": _LP, "interp": 2, "decim": 4},
                           _same(_c64), None, 1e-5),
    "head": ({"n": 100}, _same(_c64), None, 1e-5),
    "probe_rate": ({}, _same(_c64), None, 1e-5),
    "pfb_channelizer": ({"n_chan": 8}, _same(_c64), None, 1e-4),
    "log_pwr_fft": ({"fft_len": 64, "avg_alpha": 0.5}, _same(_c64), "db",
                    1e-4),
    "spectrum_probe": ({"fft_len": 64}, _same(_c64), "db", 1e-4),
    "waterfall": ({"fft_len": 64, "depth": 8}, _same(_c64), "db", 1e-4),
    "ofdm_rx_stream": (dict(_OFDM), _same(_rx_in), _rx_pick, 0.0),
    "ofdm_tx_stream": (dict(_OFDM), _tx_in, _tx_pick, 1e-5),
    "wideband_rx": (dict(_OFDM, n_chan=8, block_size=1 << 15),
                    lambda pkg: _c64(n=1 << 15),
                    lambda o: [o.result.valid, o.block_index], 0.0),
    # the noiseless channel: CFO, phase and multipath carried across steps
    "channel_model": ({"seed": 3, "snr_db": None, "cfo": 0.1,
                       "taps": [1.0, 0.1]}, _same(_c64), None, 1e-5),
    "ofdm_radio": (dict(_OFDM),
                   lambda pkg: (tuple(_tx_in(pkg)), _rx_in()),
                   lambda o: _tx_pick(o.tx) + _rx_pick(o.rx), 1e-5),
}


def test_registry_keys_equal_jax():
    assert set(grc.REGISTRY) == set(jgrc.REGISTRY) == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_registry_descriptors_match_jax(name):
    """The same parameter names and open-endedness (the GRC <param>
    analog), and a block named as the JAX package names it."""
    ours, theirs = grc.REGISTRY[name], jgrc.REGISTRY[name]
    assert list(ours.params) == list(theirs.params)
    assert ours.open_ended == theirs.open_ended
    params = CASES[name][0]
    assert ours.make(params).name == theirs.make(params).name


def _leaves(out, pick):
    leaves = pick(out) if callable(pick) else (
        tree_leaves(out) if isinstance(out, (tuple, torch.Tensor))
        else jax.tree.leaves(out))
    if not isinstance(leaves, list):
        leaves = [leaves]
    return [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in leaves]


@pytest.mark.parametrize("btype", sorted(CASES))
def test_registry_round_trip_matches_jax(btype):
    """spec dict -> grc.build in both packages -> two steps on the same
    input; every compared leaf within the case's tolerance."""
    params, make_in, pick, tol = CASES[btype]
    spec = {"name": f"rt_{btype}",
            "blocks": [{"id": "b", "type": btype, "params": params}],
            "connections": [], "inputs": ["b"], "outputs": ["b"]}
    jblk, tblk = jgrc.build(spec), grc.build(spec)
    js, ts = jblk.init(), tblk.init(torch.device("cpu"))
    step = jax.jit(jblk.apply)
    for i in (0, 1):
        js, jy = step(js, make_in("jax"))
        ts, ty = tblk.apply(ts, tree_map(lambda a: to_device(a, "cpu"),
                                         make_in("port")))
        want = _leaves(jy, pick)
        got = _leaves(ty, pick)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, (btype, i)
            if pick == "db":
                g, w = 10.0 ** (g / 10.0), 10.0 ** (w / 10.0)
            if np.issubdtype(w.dtype, np.inexact):
                assert np.isfinite(g).all()
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=tol * max(1.0, np.abs(w).max()),
                    err_msg=f"{btype} step {i}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=btype)


def test_rx_stream_case_detects_frames():
    """The RX registry case compares real detections, not empty slots."""
    blk = grc.build({"blocks": [{"id": "b", "type": "ofdm_rx_stream",
                                 "params": dict(_OFDM)}],
                     "inputs": ["b"], "outputs": ["b"]})
    outs = [StreamExecutor(blk, BS, device="cpu").push(_rx_in())]
    assert {f["frame_num"] for f in collect_frames(outs)} == {3, 4}


# --- the four examples ------------------------------------------------------

def _example_input(name, n):
    t = np.arange(n)
    if name == "psd_probe":
        return np.exp(2j * np.pi * 0.125 * t).astype(np.complex64)
    if name == "decimate_and_measure":
        return (np.exp(2j * np.pi * 0.25 * t) + 0.1 * _c64(2, n)).astype(
            np.complex64)
    return _c64(3, n)


@pytest.mark.parametrize("path", [p for p in EXAMPLES
                                  if "loopback" not in p],
                         ids=lambda p: os.path.basename(p))
def test_example_runs_as_in_jax(path):
    """Two pushes of 8192 samples through the example in both packages
    (the same stream on every input); the final outputs agree (dB outputs
    as linear power at 1e-4 * max, the DDC at 1e-3 for its mixer phase,
    the channelizer at 1e-4)."""
    name = os.path.splitext(os.path.basename(path))[0]
    with open(path) as f:
        spec = json.load(f)
    n_in = len(spec["inputs"])
    bs = 8192
    jex_ = jex.StreamExecutor(jgrc.build(spec), bs, donate=False)
    tex_ = StreamExecutor(grc.load(path), bs, device="cpu")
    for i in range(2):
        x = _example_input(name, 2 * bs)[i * bs:(i + 1) * bs]
        x = x if n_in == 1 else (x,) * n_in
        want, got = jex_.push(x), tex_.push(x)
    db = {"psd_probe": [0, 1, 2], "decimate_and_measure": [0],
          "channelizer_plus_waterfall": [1]}[spec["name"]]
    tol = 1e-3 if name == "decimate_and_measure" else 1e-4
    wl = [np.asarray(a) for a in jax.tree.leaves(want)]
    gl = [a.numpy() for a in tree_leaves(got)]
    assert len(wl) == len(gl)
    for k, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape
        if k in db:
            g, w = 10.0 ** (g / 10.0), 10.0 ** (w / 10.0)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=f"{name} leaf {k}")


def test_example_specs_compile():
    assert len(EXAMPLES) == 4
    for s in EXAMPLES:
        assert isinstance(grc.load(s), Block)


def test_loopback_example_end_to_end():
    """examples/ofdm_loopback.json: PDUs -> TX -> channel -> RX recovers
    every payload once, with the frames the JAX package recovers."""
    path = [p for p in EXAMPLES if "loopback" in p][0]
    radio = grc.load(path)
    assert radio.stream_input is False
    spec = OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
    msgs = [b"grc loopback pdu %d" % i for i in range(5)]
    b0, rest = queue_tx_in(spec, 4, msgs, frame_num0=0, device="cpu")
    b1, rest = queue_tx_in(spec, 4, rest, frame_num0=4, device="cpu")
    assert not rest
    ex = StreamExecutor(radio, 4096, device="cpu")
    outs, accepted = [], []
    for ti in [b0, b1] + [empty_tx_in(spec, 4, device="cpu")] * 6:
        rx_out, acc = ex.push(ti)
        outs.append(rx_out)
        accepted.append(acc.numpy())
    assert accepted[0].all() and accepted[1][0]
    frames = collect_frames(outs, 4096, history_len(spec))
    got = sorted((f["frame_num"], f["payload"], f["crc_ok"]) for f in frames)
    assert got == [(i, m, True) for i, m in enumerate(msgs)]


def test_loopback_example_channel_realizes_requested_snr():
    """The loopback example's channel realizes its snr_db within 0.2 dB on
    frame samples, as the JAX package's does."""
    path = [p for p in EXAMPLES if "loopback" in p][0]
    with open(path) as f:
        chan = next(b for b in json.load(f)["blocks"]
                    if b["id"] == "chan")["params"]
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    frame = G.tx_frame(gp, bytes(range(48))).astype(np.complex64)
    x = torch.as_tensor(np.tile(frame, max(1, (1 << 16) // len(frame))))

    def run(params):
        blk = grc.REGISTRY["channel_model"].make(params)
        return blk.apply(blk.init(torch.device("cpu")), x)[1].numpy()

    noisy, clean = run(chan), run({**chan, "snr_db": None})
    realized = 10.0 * np.log10(np.mean(np.abs(clean) ** 2)
                               / np.mean(np.abs(noisy - clean) ** 2))
    assert abs(realized - float(chan["snr_db"])) < 0.2, realized


def test_graph_block_is_callable_and_named():
    blk = grc.build(SPEC)
    state = blk.init(torch.device("cpu"))
    state, out = blk(state, torch.ones(128, dtype=torch.complex64))
    assert blk.name == "psd" and int(out.n_frames) == 2
    assert nlog10().name == "nlog10"
