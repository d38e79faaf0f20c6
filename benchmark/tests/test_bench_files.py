"""Every file the harness finds by name loads, and every name, unit and
string of BENCHMARK.json keeps to the benchmark contract's alphabet."""

import json
import re

import pytest

import run

ROOT = run.ROOT
BENCH = run.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and PATH.match(b["paths"][0])
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_strings():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("benchmark/") and PATH.match(c["file"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(names) == len(set(names))
    for s in [c["source"] for c in b["configs"]] + [
            x["why"] for x in b["configs"] + b["workloads"]] + [
            m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files(cell):
    plan = run.cell_plan(cell)
    assert plan["traffic"]["kind"]
    assert run.traffic_kind(plan).Cell
    assert {"u_gap", "x_gap", "nonfinite_lanes",
            "settled_mu"} <= set(plan["limits"])
    assert plan["limits"]["nonfinite_lanes"] == 0
    names = {m["name"] for m in plan["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert plan["per_layer"]


@pytest.mark.parametrize("path", sorted(
    p.name for p in (BENCH / "metrics").glob("*.py")))
def test_each_metric_reader_loads(path):
    mod = run.load_module(BENCH / "metrics" / path, "m_" + path[:-3])
    assert callable(mod.read)
    assert path[:-3] in {m["name"] for m in bench()["per_layer"]}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in BENCH.glob("*/*.json")))
def test_each_data_file_loads(path):
    data = json.loads((BENCH / path).read_text())
    assert isinstance(data, dict)
    assert all(NAME.match(part) or part.endswith(".json")
               for part in path.split("/"))
