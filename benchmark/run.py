"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in the root `BENCHMARK.json`: its
configuration is `benchmark/configs/<config>.json`, its traffic mix
`benchmark/traffic/<traffic>.json` (whose `kind` names the generator
`benchmark/traffic/<kind>.py`), its correctness limits
`benchmark/workloads/<cell>.json`, and each per-layer metric the reader
`benchmark/metrics/<name>.py`.  A cell or a metric is added by adding
files and entries; no code here names one.

A run: set-up (imports, the kernels from the checkout's build cache,
the lanes made on the card from the seed, the cell's own shapes warmed
up through the entry the window drives), timed as `setup_s`; a window of
`--seconds` closed by one synchronize; with `--trace 1` a traced segment
of a fixed number of ticks after it; then, with the program's state
freed, the plain reference over ticks sampled from the seed.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key
of that object.  Without a CUDA device it exits 1 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names a run may not load (the JAX package is
# `crazyflie_nmpc_tpu`; the port, `crazyflie_nmpc_tpu_torch`, is another
# name)
FORBIDDEN = ("jax", "jaxlib", "flax", "crazyflie_nmpc_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_module(path: Path, name: str):
    """Import the file `path` as module `name` (metric readers and
    traffic kinds have dots in their names)."""
    if not path.is_file():
        raise BenchError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"no file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def cell_plan(cell: str, bench: dict | None = None) -> dict:
    """Everything the harness reads for `cell`, found by name: its
    BENCHMARK.json entry, configuration, traffic mix, limits, and the
    end-to-end and per-layer metrics it reports."""
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise BenchError(f"no workload {cell!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(metric):
        return cell in metric.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if reports(m) and m["moves"] in names]
    return dict(
        cell=cell, entry=entry, config=read_json(ROOT / config["file"]),
        traffic=read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH / "workloads" / f"{cell}.json"),
        end_to_end=e2e, per_layer=layer)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def traffic_kind(plan: dict):
    kind = plan["traffic"]["kind"]
    return load_module(BENCH / "traffic" / f"{kind}.py",
                       f"bench_traffic_{kind}")


def run_cell(plan: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of the cell `plan` on `device`; returns the result line
    as a dict (raises BenchError where a run gives no result).
    `overrides` replaces traffic parameters (the CPU tests' small
    sizes)."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    cuda = device == "cuda"
    chips = int(plan["entry"]["chips"])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    traffic = dict(plan["traffic"], **(overrides or {}))
    kind = traffic_kind(plan)
    cell = kind.Cell(plan["config"], traffic, plan["limits"], seed, device)
    cell.setup()
    sync()
    setup_s = time.perf_counter() - t_start

    window = cell.window(seconds)
    tr = None
    if trace:
        from tracing import record
        tr = record(cell.traced_segment, cell.trace_ticks, sync)
        import program
        if not program.port_kernel_events(tr):
            raise BenchError("the trace holds no kernel of the port")
    sync()
    found = forbidden_modules()
    if found:
        raise BenchError("modules the port may not load: " + ", ".join(found))
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = cell.counts(window)
    cell.release()

    t_check = time.perf_counter()
    checks = cell.check()
    print(f"comparison {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    if trace:
        ctx = dict(cell=cell, window=window, trace=tr, plan=plan)
        metrics = {}
        for m in plan["per_layer"]:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    else:
        values = dict(cell.end_to_end(window), setup_s=setup_s)
        metrics = {m["name"]: dict(value=float(values[m["name"]]),
                                   unit=m["unit"])
                   for m in plan["end_to_end"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=chips, memory_peak_bytes=int(memory_peak))
    out = dict(correct=bool(correct), attempted=int(attempted),
               failed=int(failed), metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a run inside the checkout, at fixed paths; one
    # host thread for the libraries' own pools
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(BENCH))
    try:
        plan = cell_plan(args.workload)
        import torch

        chips = int(plan["entry"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload}: needs {chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        torch.set_num_threads(1)
        out = run_cell(plan, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)
    except BenchError as exc:
        print(f"{args.workload}: {exc}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print("modules the port may not load: " + ", ".join(found),
              file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
