"""Readings for the limits of `correct`, and the check that the
comparison fails where it must.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 --mode sound|control|frozen|half|altered [--cpu]

runs the cell's set-up, a short window and the comparison once a seed,
in one process, with the batched step replaced underneath as `--mode`
says, and prints each seed's numbers compared, then the largest of each
over the seeds:

  * sound: the program as it is (the lower readings);
  * control: the plain reference put in the program's place, computed
    in float32 with the operands of every matrix product rounded to TF32
    (the configuration states float32 with TF32 off; the upper
    readings);
  * frozen: a step that returns its state unchanged;
  * half: the second half of the lanes left out (their state unchanged);
  * altered: one lane's answer altered where it is produced (its input
    plan moved by 0.1 kRPM).

Without `--cpu` it needs a CUDA device; with it, the plain versions of
the port's kernels run at whatever sizes `--set` gives
(`--set lanes=8,warmup_ticks=3`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run  # noqa: E402
from reference import rti as ref  # noqa: E402

ALTER_KRPM = 0.1


class _State(NamedTuple):
    x_traj: object
    u_traj: object


class _Out(NamedTuple):
    u0: object
    u1: object
    x_plan: object
    u_plan: object


def _result(x_bl, u_bl):
    """The step's return in the kernels' batch-last layout."""
    return _State(x_bl, u_bl), _Out(u_bl[0], u_bl[1], x_bl, u_bl)


def control_step(config: dict, prec: ref.Precision = ref.CONTROL_TF32):
    """The reference, as a drop-in for `rti_step_batched` on batch-last
    states, computed in `prec` and handed back in the program's dtype."""
    import program

    problem = program.reference_problem(config)
    solver = program.reference_solver(config)

    def step(spec, states, x0s, yref, yref_e, ipm_config=None, **kw):
        dtype = states.x_traj.dtype
        bf = lambda t: t.movedim(-1, 0)  # noqa: E731
        B = x0s.shape[0]
        yr = yref if yref.ndim == 3 else yref.expand(B, *yref.shape)
        ye = yref_e if yref_e.ndim == 2 else yref_e.expand(B, -1)
        x, u = ref.rti_tick(problem, solver, bf(states.x_traj),
                            bf(states.u_traj), x0s, yr, ye, prec)
        return _result(x.to(dtype).movedim(0, -1).contiguous(),
                       u.to(dtype).movedim(0, -1).contiguous())
    return step


def fault_step(real, mode: str):
    """The program's step with one fault planted in what it returns."""
    def step(spec, states, x0s, yref, yref_e, *args, **kw):
        new, _ = real(spec, states, x0s, yref, yref_e, *args, **kw)
        x, u = new.x_traj.clone(), new.u_traj.clone()
        if mode == "frozen":
            x, u = states.x_traj.clone(), states.u_traj.clone()
        elif mode == "half":
            h = x.shape[-1] // 2
            x[..., h:], u[..., h:] = states.x_traj[..., h:], \
                states.u_traj[..., h:]
        elif mode == "altered":
            u[:, :, 0] += ALTER_KRPM
        else:
            raise ValueError(mode)
        return _result(x, u)
    return step


@contextlib.contextmanager
def replaced_step(step):
    """`rti_step_batched` replaced by `step` where the cells' paths look
    it up: the solver module (the closed-loop kind imports it from
    there at set-up) and the serving loop's module."""
    from crazyflie_nmpc_tpu_torch.runtime import serving
    from crazyflie_nmpc_tpu_torch.solver import rti_batched

    saved = rti_batched.rti_step_batched, serving.rti_step_batched
    rti_batched.rti_step_batched = serving.rti_step_batched = step
    try:
        yield
    finally:
        rti_batched.rti_step_batched, serving.rti_step_batched = saved


def readings(plan: dict, seeds, seconds: float, mode: str, device: str,
             overrides: dict | None = None) -> list:
    """One run of the cell a seed with the step `mode` gives; returns
    each run's (seed, correct, checks)."""
    from crazyflie_nmpc_tpu_torch.solver import rti_batched

    real = rti_batched.rti_step_batched
    if mode == "sound":
        step = real
    elif mode == "control":
        step = control_step(plan["config"])
    else:
        step = fault_step(real, mode)
    out = []
    with replaced_step(step):
        for seed in seeds:
            res = run.run_cell(plan, seed, seconds, False, device,
                               overrides=overrides)
            out.append((seed, res["correct"], res["checks"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "control", "frozen", "half",
                             "altered"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--set", default="",
                    help="traffic overrides, k=v,... (JSON values)")
    args = ap.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    overrides = {k: json.loads(v) for k, v in
                 (kv.split("=", 1) for kv in args.set.split(",") if kv)}
    plan = run.cell_plan(args.workload)
    t0 = time.perf_counter()
    rows = readings(plan, [int(s) for s in args.seeds.split(",")],
                    args.seconds, args.mode, "cpu" if args.cpu else "cuda",
                    overrides)
    worst: dict = {}
    for seed, correct, checks in rows:
        print(json.dumps(dict(mode=args.mode, seed=seed, correct=correct,
                              **{k: c["value"] for k, c in checks.items()})))
        for k, c in checks.items():
            worst[k] = max(worst.get(k, -1.0), c["value"])
    print(json.dumps(dict(mode=args.mode, workload=args.workload,
                          runs=len(rows), worst=worst,
                          all_correct=all(r[1] for r in rows),
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
