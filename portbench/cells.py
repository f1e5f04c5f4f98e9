"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix, its limits, and the readers of its metrics.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name BENCHMARK.json gives it:

    configs/<config>.json          the configuration as it is run
    traffic/<traffic>.json         the mix's parameters (traffic.py reads them)
    paths/<path>.py                the program's entry that the mix's "path"
                                   names, and the window over it (Path)
    limits/<workload>.json         each number the check compares, its limit
                                   ("limits"), and why any is not compared
    end_to_end/<metric>.py         read(ctx) -> float, from the window
    metrics/<metric>.py            read(ctx) -> float or None, from the
                                   traced run's spans, counters and trace
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         root: pathlib.Path = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text())[
            "limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(kind: str, metric: str):
    """The read(ctx) function of end_to_end/<metric>.py or
    metrics/<metric>.py (loaded by path: metric names may hold dots)."""
    path = HERE / kind / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def path_class(kind: str):
    """The Path class of paths/<kind>.py, the entry a traffic mix names."""
    return importlib.import_module(f"portbench.paths.{kind}").Path
