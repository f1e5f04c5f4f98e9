"""Guards for the PyTorch port `tpu_ofdm_torch/`:

- it must import without JAX: the GPU machine has no JAX, so a stray
  import would break the port there while every CPU test still passed;
- the rule of tests/test_docs_drift.py, applied to the port: a rate or
  bandwidth figure in its source must carry a date and the card it was
  measured on (H100) within the 3 lines above it.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpu_ofdm_torch"

UNIT = re.compile(r"\d[\d.]*\s*x?\s*(?:G|M)samp(?:les)?/s|\d[\d.]*\s*[GT]B/s"
                  r"|\d[\d.]*\s*TFLOP")
DATE = re.compile(r"20\d\d-\d\d(-\d\d)?")
CONTEXT = 3


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_ofdm_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "tpu_ofdm_torch.__path__, 'tpu_ofdm_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m.startswith('jaxlib.'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 16, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|tpu_ofdm)\b", src, re.M)


def test_no_undated_perf_figures_in_port():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + sorted((PKG / "csrc").glob("*.cu*"))
    for path in files:
        lines = path.read_text().splitlines()
        for i, line in enumerate(lines):
            if not UNIT.search(line):
                continue
            window = lines[max(0, i - CONTEXT): i + 1]
            if not (any(DATE.search(w) for w in window)
                    and any("H100" in w for w in window)):
                offenders.append(f"{path.relative_to(ROOT)}:{i + 1}: "
                                 f"{line.strip()}")
    assert not offenders, (
        "perf figures in the port's source need a date and 'H100' within "
        f"{CONTEXT} lines (or belong in PERF.md):\n" + "\n".join(offenders))
