"""Runs of each cell on the CPU at a tiny size, with the port's plain
kernel versions: the result line, the discovery of a cell added as data,
the modules a run loads, an empty trace, and the comparison failing for
the control and for each fault a cell can have."""

import json
import shutil
import subprocess
import sys

import pytest

import control
import run

TINY = {
    "cf21_mc.hover_b32768": dict(lanes=6, warmup_ticks=3, compare_ticks=1),
    "cf21_swarm_certified.serve_b256": dict(
        vehicles=4, grid=dict(side=2, spacing_m=0.6, height_m=0.4),
        chunk_ticks=2, warmup_ticks=3, compare_ticks=1),
}
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_dry_run_prints_the_result_line(cell):
    out = run.run_cell(run.cell_plan(cell), 2**31 + 7, 0.5, False, "cpu",
                       overrides=TINY[cell])
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in run.cell_plan(cell)["end_to_end"]}
    assert set(out["metrics"]) == names
    assert json.loads(json.dumps(out)) == out


def test_a_cell_added_as_data_is_found(tmp_path):
    shutil.copytree(run.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(
        name="cf21_mc.hover_b16", config="cf21_mc", traffic="hover_b16",
        chips=1, why="a test cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cf21_mc.hover_b32768" in m.get("workloads", []):
            m["workloads"].append("cf21_mc.hover_b16")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((run.BENCH / "traffic" / "hover_b32768.json").read_text())
    mix.update(lanes=16)
    (tmp_path / "benchmark" / "traffic" / "hover_b16.json").write_text(
        json.dumps(mix))
    shutil.copy(run.BENCH / "workloads" / "cf21_mc.hover_b32768.json",
                tmp_path / "benchmark" / "workloads" /
                "cf21_mc.hover_b16.json")
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]; import run; "
        "p = run.cell_plan('cf21_mc.hover_b16'); "
        "print(json.dumps([p['traffic']['lanes'], "
        "[m['name'] for m in p['end_to_end']], run.traffic_kind(p).__file__]))"
        % (str(tmp_path / "benchmark"), str(run.ROOT)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    lanes, e2e, kind = json.loads(res.stdout.strip().splitlines()[-1])
    assert lanes == 16 and set(e2e) == {"solves_per_s", "setup_s"}
    assert kind.startswith(str(tmp_path))


def _loaded_after(code: str) -> set:
    res = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path[:0] = [%r, %r]; %s; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"
         % (str(run.BENCH), str(run.ROOT), code)],
        capture_output=True, text=True, check=True)
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _loaded_after(
        "import run, torch; torch.set_num_threads(1); "
        "run.run_cell(run.cell_plan('cf21_mc.hover_b32768'), 3, 0.2, False, "
        "'cpu', overrides=dict(lanes=2, warmup_ticks=2, compare_ticks=1))")
    assert not mods & set(run.FORBIDDEN)
    assert "crazyflie_nmpc_tpu_torch" in mods


def test_the_reference_imports_nothing_of_either_package():
    mods = _loaded_after("import reference.rti, judge, counts, fleet")
    assert not mods & (set(run.FORBIDDEN) | {"crazyflie_nmpc_tpu_torch"})


def test_the_command_without_a_card_gives_no_result():
    res = subprocess.run(
        [sys.executable, str(run.BENCH / "run.py"), "--workload",
         "cf21_mc.hover_b32768", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_traced_run_with_no_kernel_of_the_port_fails():
    # on the CPU the port launches no kernel: the trace holds none
    with pytest.raises(run.BenchError, match="no kernel of the port"):
        run.run_cell(run.cell_plan("cf21_mc.hover_b32768"), 5, 0.2, True, "cpu",
                     overrides=dict(TINY["cf21_mc.hover_b32768"],
                                    trace_ticks=1))


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("mode", ["control", "frozen", "half", "altered"])
def test_the_comparison_fails_the_control_and_each_fault(cell, mode):
    [(_, correct, checks)] = control.readings(
        run.cell_plan(cell), [11], 0.5, mode, "cpu",
        overrides=TINY[cell])
    assert correct is False, checks
