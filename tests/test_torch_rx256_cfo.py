"""BASELINE config 2 (fft 256, cp 64, QPSK) with a CFO of its own on every
frame, on the CPU:

- the port's streaming receiver against the benchmark's float64 reference
  (portbench/reference/receiver.py), on frames whose CFOs give integer
  shifts of -2, 0 and +2, two of them within 0.05 of an odd offset, where
  the fine estimate wraps;
- the counters sc_detect.<form> and rx.int_cfo: off by default, and on,
  one detection a push under its kernel form and one count a frame
  reported with a nonzero integer shift, at configs 1 and 2;
- the benchmark cell rx256_cfo at the benchmark tests' small size through
  the harness: correct, and not correct with the integer shift forced to 0
  or with the reference in bfloat16 in the program's place;
- the demod_ms reader on a made-up device trace.
"""

import types

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness, tracing
from portbench import traffic as T
from portbench.reference import golden_ofdm as G
from portbench.reference import receiver as R
from portbench.tests.conftest import small
from tpu_ofdm_torch.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.stream.executor import StreamExecutor
from tpu_ofdm_torch.utils import metrics

S = 1 << 16
K = 8
NOISE = 0.063            # the cell's noise, per axis
CONFIG_CFO_TOL = 0.02    # chip_smoke.py's bar on int_cfo + fine_cfo
# |fine CFO - the float64 reference's|: rx64_dense's cfo_gap limit; the CPU
# path's float32 angle of a float64-summed P reads under 1e-7
FINE_TOL = 2e-6
SEED = 2**31 + 4242

CONFIGS = {
    "config1": dict(fft_len=64, cp_len=16, modulation="bpsk",
                    max_payload_bytes=64),
    "config2": dict(fft_len=256, cp_len=64, modulation="qpsk",
                    max_payload_bytes=256),
}
# absolute starts: one frame across the seam between blocks 0 and 1
POS = [300, 7000, 20000, S - 1200, S + 9000, S + 30000, S + 50000]
# CFO in subcarriers and the integer shift it leaves after the fine
# estimate, which wraps into (-1, 1]
CFO = [-2.3, -0.4, 0.2, 1.8, 2.6, -1.04, 1.03]
SHIFT = [-2, 0, 0, 2, 2, -2, 2]


def stream_of(name: str, cfos):
    """Two blocks of noise with one golden frame at each of POS, moved by
    its CFO through the reference's channel model: (x complex64, the
    reference's Spec, [(pos, payload, frame_num, cfo)])."""
    s = R.Spec(**CONFIGS[name])
    rng = np.random.default_rng(SEED)
    x = NOISE * (rng.standard_normal(2 * S) + 1j * rng.standard_normal(2 * S))
    cap = s.max_payload_bytes - 4
    sent = []
    for j, (pos, cfo) in enumerate(zip(POS, cfos)):
        pay = rng.integers(0, 256, 1 + (37 * j) % cap, np.uint8).tobytes()
        num = int(rng.integers(0, 4096))
        f = G.channel(T.golden(s, pay, num), cfo=cfo, fft_len=s.fft_len,
                      phase=rng.uniform(0, 2 * np.pi))
        x[pos:pos + len(f)] += f
        sent.append((pos, pay, num, cfo))
    return x.astype(np.complex64), s, sent


def receive(name: str, x: np.ndarray):
    """The port's streaming receiver over x, drained: (frames, pushes)."""
    spec = OfdmConfig(**CONFIGS[name]).spec
    ex = StreamExecutor(rx_stream_block(spec, StreamConfig(S, K)), S,
                        device="cpu")
    outs = ex.run(torch.from_numpy(x), drain=True)
    return collect_frames(outs, block_size=S, hist=history_len(spec)), \
        len(outs)


def test_config2_stream_recovers_each_integer_and_fine_cfo():
    x, s, sent = stream_of("config2", CFO)
    frames, _ = receive("config2", x)
    assert len(frames) == len(sent)
    H = history_len(OfdmConfig(**CONFIGS["config2"]).spec)
    xr = x.astype(np.complex128)

    def stream(lo, hi):
        out = np.zeros(hi - lo, np.complex128)
        a, b = max(lo, 0), min(hi, len(xr))
        out[a - lo:b - lo] = xr[a:b]
        return out

    for g, (pos, pay, num, cfo), shift in zip(
            sorted(frames, key=lambda f: f["abs_start"]), sent, SHIFT):
        assert pos <= g["abs_start"] <= pos + s.cp_len
        assert (g["payload"], g["frame_num"]) == (pay, num)
        assert g["crc_ok"] and g["hdr_ok"]
        assert g["int_cfo"] == shift
        assert abs(g["int_cfo"] + g["fine_cfo"] - cfo) < CONFIG_CFO_TOL
        # the reference's fine CFO and demod at the program's start
        t_origin = (g["abs_start"] + H) // S * S - H
        det = R.detect(s, stream, pos, 48, t_origin)
        j = R.argmax_of(s, g["abs_start"])
        assert abs(g["fine_cfo"] - det.fine_cfo(j)) < FINE_TOL
        ref = R.demod(s, stream(g["abs_start"],
                                g["abs_start"] + s.max_frame_len),
                      det.fine_cfo(j))
        assert ref["crc_ok"] and ref["payload"] == pay
    # two fine estimates wrapped: within 0.05 of an odd offset
    assert sum(abs(abs(c) - 1) < 0.05 for c in CFO) == 2


@pytest.mark.parametrize("name,form,shifted", [("config1", "l32", 0),
                                               ("config2", "seg", 5)])
def test_detect_and_int_cfo_counters(name, form, shifted):
    cfos = CFO if name == "config2" else [0.0] * len(POS)
    x, _, sent = stream_of(name, cfos)
    metrics.drain()
    frames, _ = receive(name, x)
    assert len(frames) == len(sent)
    assert metrics.drain().counters == {}
    metrics.enable(True)
    try:
        frames, pushes = receive(name, x)
    finally:
        metrics.enable(False)
    got = metrics.drain().counters
    assert len(frames) == len(sent)
    assert {k: v for k, v in got.items() if k.startswith("sc_detect.")} \
        == {"sc_detect." + form: pushes}
    assert got["rx.frames"] == len(sent)
    assert got["rx.int_cfo"] == shifted == sum(f["int_cfo"] != 0
                                                for f in frames)


def run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu")


def test_rx256_cfo_cell_is_correct():
    r = run(small("rx256_cfo"))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_rx256_cfo_cell_needs_the_integer_shift(monkeypatch):
    def no_shift(spec, sync1_fd, max_shift=None):
        return torch.zeros(sync1_fd.shape[:-1], dtype=torch.int32,
                           device=sync1_fd.device)

    monkeypatch.setattr(trx, "coarse_int_cfo", no_shift)
    r = run(small("rx256_cfo"))
    assert not r["correct"], r["checks"]


def test_rx256_cfo_control_is_not_correct():
    cell = small("rx256_cfo")
    got = control.readings(cell, SEED, 0.3, "cpu")
    assert check.verdict(got["program"], cell.limits)
    numbers = {"pushes_wrong": 0, **got["control"]}
    assert not check.verdict(numbers, cell.limits), numbers


def test_demod_ms_spans_the_port_gather_to_the_next_detection():
    torch_gather = "void at::native::vectorized_gather_kernel<16, long>(char*)"
    port_gather = "void (anonymous namespace)::gather_kernel(float2 const*)"
    push = [("void (anonymous namespace)::sc_detect_seg_kernel<4>(int)",
             0.0, 250.0),
            (torch_gather, 260.0, 270.0),           # the selection's
            (port_gather, 300.0, 310.0),
            ("void fft_kernel()", 320.0, 420.0),
            (torch_gather, 430.0, 450.0),           # the integer-CFO roll
            ("Memcpy DtoD (Device -> Device)", 460.0, 470.0),
            ("Memcpy DtoH (Device -> Pageable)", 500.0, 505.0)]
    dev = [(n, a + 1000.0 * i, b + 1000.0 * i) for i in range(2)
           for n, a, b in push]
    read = cells.reader("metrics", "demod_ms")
    c = types.SimpleNamespace(trace=tracing.Trace(dev, [], pushes=2,
                                                  wall_s=0.002))
    # per push: the gather 10, the FFT 100, the roll 20, the copy 10 us
    assert read(c) == pytest.approx(0.140)
    no_port = [e for e in dev if e[0] != port_gather]
    c.trace = tracing.Trace(no_port, [], pushes=2, wall_s=0.002)
    assert read(c) is None
    c.trace = None
    assert read(c) is None
