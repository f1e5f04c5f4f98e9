"""On the card: each cell's run as the check starts it, for a short
window, ends with a result line and `correct` true.  Skips without a
card:  python -m pytest portbench/tests -q -m card"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import cells


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_a_short_run_on_the_card_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
