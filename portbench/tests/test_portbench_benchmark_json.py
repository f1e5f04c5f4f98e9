"""BENCHMARK.json against its format (keys, names, units, limits), and
every file it names."""

import json
import re

import pytest

from portbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell = cells.cell(w["name"], BENCH)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in got
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  cells.cell(w, BENCH).end_to_end}


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(w):
    cell = cells.cell(w, BENCH)
    assert (cells.HERE / "paths" / f"{cell.traffic['path']}.py").is_file()
    assert callable(cells.path_class(cell.traffic["path"]))
    assert set(cell.limits) >= {"pushes_wrong", "frames_wrong", "cfo_gap",
                                "evm_gap"}
    assert cell.limits["pushes_wrong"] == cell.limits["frames_wrong"] == 0
    for m in cell.end_to_end:
        assert callable(cells.reader("end_to_end", m["name"]))
    for m in cell.per_layer:
        assert callable(cells.reader("metrics", m["name"]))


@pytest.mark.parametrize("kind", sorted(
    f.stem for f in (cells.HERE / "paths").glob("*.py")
    if f.stem != "__init__"))
def test_every_path_file_is_found_by_its_name(kind):
    cls = cells.path_class(kind)
    for attr in ("setup", "push", "collect", "for_check", "close",
                 "expected", "stream", "t_origin", "work"):
        assert callable(getattr(cls, attr)), attr
