"""The port's observability module (tpu_ofdm_torch/utils/metrics.py)
against the JAX package's: the EWMA, the per-stage counters and the link
metrics give the JAX module's numbers on the same inputs; `trace` writes a
Chrome trace of torch.profiler (on the CPU here; on the card chip_smoke.py
phase 11 finds the port's kernels in it)."""

import json
import time

import pytest
import torch

from tpu_ofdm.utils import metrics as jm
from tpu_ofdm_torch.utils import metrics as tm

FRAMES = [
    {"crc_ok": True, "payload_len": 10, "evm": 0.1, "fine_cfo": 0.05},
    {"crc_ok": True, "payload_len": 20, "evm": 0.3, "fine_cfo": 0.06},
    {"crc_ok": False, "payload_len": 0, "evm": 1.0},
]


@pytest.mark.parametrize("alpha,xs", [(0.5, [10, 20]), (0.1, [3.0, -1.0,
                                                              7.5, 2.25])])
def test_ewma_equals_jax(alpha, xs):
    a, b = tm.Ewma(alpha), jm.Ewma(alpha)
    for x in xs:
        assert a.update(x) == b.update(x)
    assert tm.Ewma(0.5).update(10) == 10


def test_perf_counters():
    pc = tm.PerfCounters()
    for _ in range(3):
        with pc.stage("work", items=1000):
            time.sleep(0.01)
    r = pc.report()
    assert r["work"]["calls"] == 3
    assert 5 < r["work"]["ewma_ms"] < 100
    assert r["work"]["ewma_items_per_s"] > 1000
    assert json.loads(pc.report_json()) == r
    with pc.stage("no_items"):
        pass
    assert pc.report()["no_items"]["ewma_items_per_s"] is None


def test_link_metrics_equal_jax():
    m, j = tm.LinkMetrics(), jm.LinkMetrics()
    for x in (m, j):
        x.update_from_frames(FRAMES)
        x.add_samples(100000)
    s, w = m.summary(), j.summary()
    assert s.pop("samples_per_sec") > 0
    w.pop("samples_per_sec")
    assert s == w
    assert s["frames_ok"] == 2 and s["frames_crc_fail"] == 1
    assert abs(s["frame_error_rate"] - 1 / 3) < 1e-3
    assert s["bytes_ok"] == 30
    assert abs(s["mean_evm"] - 0.2) < 1e-6
    assert s["cfo_last"] == 0.06


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(256, dtype=torch.complex64)
    with tm.trace(str(tmp_path / "trace")):
        torch.fft.fft(x)
    trace = json.loads((tmp_path / "trace" / tm.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("fft" in n for n in names), sorted(names)[:20]
