"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole: tpu_ofdm_torch begins with tpu_ofdm),
and the reference loads nothing of the program."""

import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(imports: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
        capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = top_level_modules(
        "import portbench.run as r\n"
        "from portbench import harness, check, control, cells\n"
        "for k in [w['name'] for w in cells.load_benchmark()['workloads']]:\n"
        "    c = cells.cell(k)\n"
        "    cells.path_class(c.traffic['path'])\n"
        "    [cells.reader('end_to_end', m['name']) for m in c.end_to_end]\n"
        "    [cells.reader('metrics', m['name']) for m in c.per_layer]")
    assert not mods & {"jax", "jaxlib", "flax", "tpu_ofdm"}
    assert "tpu_ofdm_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = top_level_modules(
        "from portbench.reference import receiver, golden_ofdm")
    assert not mods & {"jax", "jaxlib", "flax", "tpu_ofdm",
                       "tpu_ofdm_torch", "torch"}


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "tpu_ofdm.config", object())
    monkeypatch.setitem(sys.modules, "tpu_ofdm_torch_extra", object())
    assert run.forbidden_modules() == ["tpu_ofdm.config"]
