"""The yardstick's arithmetic on made-up timelines and shapes."""

import numpy as np
import pytest

from portbench import cells, harness, roofline, tracing


def test_busy_union_and_gaps():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k3", 50.0, 60.0),
           ("k4", 100.0, 101.0)]
    assert tracing.busy_union((a, b) for _, a, b in dev) == 31.0
    assert tracing.merged([(0, 10), (5, 20), (50, 60)]) == [(0, 20),
                                                             (50, 60)]
    host = [("push", 15.0, 40.0), ("collect", 60.0, 99.0)]
    gaps = tracing.idle_gaps(dev, host)
    assert gaps == [["collect", 40e-6], ["push", 30e-6]]
    t = tracing.Trace(dev, host, pushes=2, wall_s=1e-4)
    assert t.busy_s == pytest.approx(31e-6)
    assert t.seconds(r"^k[12]$") == pytest.approx(25e-6)
    assert t.seconds("nothing") is None
    assert t.top_ops(2) == [["k2", 15e-6], ["k1", 10e-6]]


def test_stage_seconds_span_from_the_first_op_to_the_next_detection():
    dev = [("sc_detect_l32_kernel", -500.0, -300.0),
           ("pfb_kernel<64>", 0.0, 250.0), ("direct_copy", 260.0, 1370.0),
           ("clone", 1380.0, 1390.0), ("sc_detect_l32_kernel", 1400.0,
                                       1630.0),
           ("other", 1700.0, 1800.0), ("pfb_kernel<64>", 2000.0, 2250.0),
           ("direct_copy", 2260.0, 3370.0),
           ("sc_detect_l32_kernel", 3400.0, 3630.0),
           ("pfb_kernel<64>", 4000.0, 4250.0)]
    t = tracing.Trace(dev, [], pushes=2, wall_s=0.01)
    assert t.stage_seconds("pfb_kernel", r"sc_detect\w*kernel") == \
        pytest.approx(2730e-6)
    assert t.stage_seconds("pfb_kernel", "nothing") is None
    assert t.stage_seconds("nothing", "sc_detect") is None
    c = ctx(trace=t)
    assert cells.reader("metrics", "channelizer_ms")(c) == pytest.approx(
        1.365)


class _Path:
    samples_per_push = 1 << 25

    @staticmethod
    def work():
        return {"detect": {"buffers": 1, "samples": 3072 + (1 << 25),
                           "slots": 480},
                "pfb": {"samples": 1 << 25, "channels": 64,
                        "taps_per_arm": 8}}


def ctx(**kw):
    base = dict(path=_Path(), spans={"push": [0.004, 0.006]}, pushes=1000,
                wall_s=8.0, latencies=list(np.arange(1, 101) * 1e-3),
                setup_s=12.5)
    base.update(kw)
    return harness.Ctx(**base)


def test_end_to_end_readers():
    c = ctx()
    assert cells.reader("end_to_end", "input_msps")(c) == pytest.approx(
        1000 * 2**25 / 8.0 / 1e6)
    assert cells.reader("end_to_end", "block_p95_ms")(c) == pytest.approx(
        95.05)
    assert cells.reader("end_to_end", "setup_s")(c) == 12.5
    assert cells.reader("metrics", "enqueue_ms")(c) == pytest.approx(5.0)


def test_per_layer_readers_on_a_made_up_trace():
    dev = [("void (anonymous namespace)::sc_detect_l32_kernel(int)", 0.0,
            230.0), ("void (anonymous namespace)::pfb_kernel()", 300.0,
                     550.0), ("Memcpy HtoD (Pinned -> Device)", 600.0,
                              5600.0)]
    c = ctx(trace=tracing.Trace(dev, [], pushes=1, wall_s=0.01))
    want = (8 * (3072 + 2**25) + 13 * 480) / 3.35e12
    assert cells.reader("metrics", "detect_roofline")(c) == pytest.approx(
        100 * want / 230e-6)
    assert cells.reader("metrics", "pfb_roofline")(c) == pytest.approx(
        100 * (16 * 2**25 / 3.35e12) / 250e-6)
    assert cells.reader("metrics", "h2d_ms")(c) == pytest.approx(5.0)
    busy = 230e-6 + 250e-6 + 5000e-6
    assert cells.reader("metrics", "device_busy_ms")(c) == pytest.approx(
        busy * 1e3)
    assert cells.reader("metrics", "idle_share")(c) == pytest.approx(
        100 * (1 - busy / 8e-3))
    none = ctx(trace=tracing.Trace([], [], pushes=1, wall_s=0.01))
    for m in ("detect_roofline", "pfb_roofline", "h2d_ms", "idle_share",
              "channelizer_ms"):
        assert cells.reader("metrics", m)(none) is None


def test_rooflines_count_work_from_shapes():
    n = 3072 + 2**25
    assert roofline.detect_seconds(1, n, 480) == pytest.approx(
        (8 * n + 13 * 480) / 3.35e12)
    # bytes bind both stages at these shapes
    assert 25 * n / 67e12 < roofline.detect_seconds(1, n, 480)
    assert roofline.pfb_seconds(2**25, 64, 8) == pytest.approx(
        16 * 2**25 / 3.35e12)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for _ in range(2):
        r = harness.Reservoir(3, seed=2**31 + 5)
        for i in range(100):
            r.offer(i)
        picks.append(sorted(r.kept))
    assert picks[0] == picks[1] and len(set(picks[0])) == 3
    counts = np.zeros(20)
    for seed in range(2000):
        r = harness.Reservoir(2, seed)
        for i in range(20):
            r.offer(i)
        counts[r.kept] += 1
    assert counts.min() > 0.7 * counts.mean()
