"""BASELINE config 5 on one card (512 channels, fft 64, QPSK), on the CPU,
at 2^20 wideband samples a block (2048 a channel), K 4 a channel:

- the benchmark's bank generator (portbench/paths/wideband_bank.py) makes
  the signal that one traffic.burst a frame makes;
- the port's wideband_rx_block at 512 channels against the benchmark's
  float64 reference (portbench/reference/), frames on alternate channels
  across the wrap 511 -> 0: every frame once, as the reference decodes
  it, and no frame with a good CRC32 on an empty channel, where the
  neighbours' preambles leak;
- the cell scan512 through the harness on a subset of its channels:
  correct, and not correct with the reference in bfloat16 in the
  program's place;
- the wideband_demod_ms reader on a made-up device trace.
"""

import types

import numpy as np
import pytest
import torch

from portbench import cells, check, control, harness, tracing
from portbench import traffic as T
from portbench.paths.wideband_bank import synthesize
from portbench.reference import golden_ofdm as G
from portbench.reference import receiver as R

BLOCK = 1 << 20          # wideband samples a block, 2048 a channel
SEED = 2**31 + 5151
# alternate channels across the wrap: 511 lies between 510 and 0
CHANNELS = [504, 506, 508, 510, 0, 2, 4, 6]


def small_scan512():
    """The cell at the CPU's size: its configuration, traffic and limits,
    with 2^20-sample blocks and frames on CHANNELS alone."""
    c = cells.cell("scan512")
    c.config["stream"]["block_size"] = BLOCK
    c.traffic["channels"] = list(CHANNELS)
    return c


@pytest.mark.parametrize("n_chan,channels", [(16, [15, 0, 2, 9]),
                                             (512, [510, 0])])
def test_the_bank_makes_one_burst_a_frame(n_chan, channels):
    cell = cells.cell("scan512")
    spec = R.Spec(**cell.config["ofdm"])
    taps = G.lowpass_taps(n_chan, cell.config["taps_per_arm"])
    mix = {**cell.traffic, "channels": channels}
    row = T.wideband_frames(spec, np.random.default_rng(SEED), 1, mix)[0]
    segs = T.wideband_segments([row], n_chan, taps)
    start, x = synthesize(row, n_chan, taps)
    want = np.zeros(start + len(x), np.complex128)
    for _, s, seg in segs:
        want[s:s + len(seg)] += seg
    assert max(s + len(seg) for _, s, seg in segs) == len(want)
    got = np.zeros_like(want)
    got[start:] = x
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_wideband_rx_block_512_against_the_reference():
    cell = small_scan512()
    path = cells.path_class(cell.traffic["path"])(
        cell.config, cell.traffic, SEED, "cpu", tracing.Spans())
    path.setup()
    assert path.n_chan == 512 and path.Sc == 2048
    s = path.ref
    reported = 0
    for step in range(2):
        out = path.push(step)
        frames = path.for_check(out, path.collect(out))
        reported += len(frames)
        for ch, pos, f in path.expected(step):
            near = [g for g in frames if g["channel"] == ch
                    and abs(g["abs_start"] - pos) <= path.span + s.cp_len]
            assert len(near) == 1, (ch, near)
            g = near[0]

            def stream(lo, hi, ch=ch):
                return path.stream(ch, lo, hi)

            det = R.detect(s, stream, pos, path.span, path.t_origin(step))
            j = R.argmax_of(s, g["abs_start"])
            assert det.gap(j) < check.GHOST_PLATEAU
            ref = R.demod(s, stream(g["abs_start"],
                                    g["abs_start"] + s.max_frame_len),
                          det.fine_cfo(j))
            assert ref["hdr_ok"] and ref["crc_ok"]
            assert (g["payload"], g["frame_num"], g["crc_ok"], g["hdr_ok"]) \
                == (ref["payload"], ref["frame_num"], True, True) \
                == (f.payload, f.frame_num, True, True)
        empty = [g for g in frames if g["channel"] not in CHANNELS]
        assert not any(g["crc_ok"] for g in empty), empty
    assert reported >= 2 * len(CHANNELS)


def run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu")


def test_scan512_cell_is_correct():
    r = run(small_scan512())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["detect_gap"]["limit"] is not None


def test_scan512_control_is_not_correct():
    cell = small_scan512()
    got = control.readings(cell, SEED, 0.3, "cpu")
    assert check.verdict(got["program"], cell.limits)
    numbers = {"pushes_wrong": 0, **got["control"]}
    assert not check.verdict(numbers, cell.limits), numbers


def test_wideband_demod_ms_stops_at_the_next_push_pfb():
    pfb = "void (anonymous namespace)::pfb_kernel<512, true>(float2 const*)"
    push = [(pfb, 0.0, 500.0),
            ("void (anonymous namespace)::sc_detect_l32_kernel(int)",
             510.0, 760.0),
            ("void at::native::vectorized_gather_kernel<16, long>(char*)",
             770.0, 780.0),                         # the selection's
            ("void (anonymous namespace)::gather_kernel(float2 const*)",
             800.0, 820.0),
            ("void fft_kernel()", 830.0, 1030.0),
            ("Memcpy DtoD (Device -> Device)", 1040.0, 1060.0)]
    # no copy to the host between the pushes: the sink's comes later
    dev = [(n, a + 2000.0 * i, b + 2000.0 * i) for i in range(2)
           for n, a, b in push]
    dev.append(("Memcpy DtoH (Device -> Pageable)", 4100.0, 4110.0))
    c = types.SimpleNamespace(trace=tracing.Trace(dev, [], pushes=2,
                                                  wall_s=0.004))
    # per push: the gather 20, the FFT 200, the copy 20 us
    assert cells.reader("metrics", "wideband_demod_ms")(c) \
        == pytest.approx(0.240)
    # demod_ms runs on into the next push's pfb (500 us) where no copy to
    # the host comes between
    assert cells.reader("metrics", "demod_ms")(c) == pytest.approx(
        (240.0 + 500.0 + 240.0) / 2 / 1e3)
    no_port = [e for e in dev if "anonymous namespace)::gather" not in e[0]]
    c.trace = tracing.Trace(no_port, [], pushes=2, wall_s=0.004)
    assert cells.reader("metrics", "wideband_demod_ms")(c) is None
    c.trace = None
    assert cells.reader("metrics", "wideband_demod_ms")(c) is None
