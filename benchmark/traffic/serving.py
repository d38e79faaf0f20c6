"""Traffic kind `serving`: a fleet served by the port's
`runtime.serving.ServingLoop` at a fixed rate, the state of each tick
arriving as a host array (as a motion-capture or estimator feed would)
and each tick's command leaving to the host, where the benchmark's own
float64 RK4 plant (numpy) advances the vehicles one period.  The
benchmark's clock reads each tick's latency at its own boundary: from
the state handed to the loop to the command received.

Parameters (the mix's JSON file): `vehicles`, a `grid` of set-points
({"side", "spacing_m", "height_m"}) or one `setpoint`, `pos_scale_m` (the
initial offsets, that times N(0, 1), drawn from the seed), `rate_hz`,
`pipeline_depth`, `chunk_ticks` (the window runs `ServingLoop.run` in
chunks of this many ticks until its seconds have passed; the warm state
carries across), `warmup_ticks`, `trace_ticks`, `compare_ticks` (ticks
of the window drawn from the seed for the comparison, besides its last
and the first tick of all).
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

import judge
import program
from fleet import Reservoir, compared, references, setpoints
from reference import rti as ref

# the port's command as it reaches the sink: pitch, roll (deg), thrust
# (PWM ticks), yaw rate (deg/s); thrust is compared in kRPM of the mean
# rotor speed (1 kRPM = 1000 / 0.2685 PWM ticks)
PWM_PER_KRPM = 1000.0 / ref.PWM_SCALE


class Cell:
    def __init__(self, config, traffic, limits, seed, device):
        program.check_params(config)
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.trace_ticks = traffic["trace_ticks"]
        self._stack = functools.partial(np.stack, axis=-1)

    def setup(self):
        from crazyflie_nmpc_tpu_torch.ops import ipm_fast
        from crazyflie_nmpc_tpu_torch.runtime.serving import (ServeConfig,
                                                              ServingLoop)

        t = self.traffic
        self._ipm_fast = ipm_fast
        self.spec = spec = program.port_spec(self.config, self.device)
        self.B, self.N = t["vehicles"], spec.N
        self.dt = self.config["ocp"]["tf"] / self.N
        pts = setpoints(t, self.B, torch.float64, "cpu")
        rng = np.random.default_rng(self.seed)
        x0 = np.zeros((self.B, 13))
        x0[:, 0:3] = pts.numpy() + t["pos_scale_m"] * rng.standard_normal(
            (self.B, 3))
        x0[:, 3] = 1.0
        self.x_init, self.x = x0, x0
        yref, yref_e = references(pts, self.N, spec.params.hover_speed())
        # the set-points live on the card, as a deployment sets them once:
        # a host array would be pinned and copied at every `run` call
        dtype = program.dtype_of(self.config)
        self.yref = yref.to(device=self.device, dtype=dtype)
        self.yref_e = yref_e.to(device=self.device, dtype=dtype)
        self.loop = ServingLoop(
            spec, program.port_ipm(self.config),
            ServeConfig(rate_hz=t["rate_hz"],
                        pipeline_depth=t["pipeline_depth"]),
            batch=self.B, device=self.device)
        self.loop.reset(x0)
        self.pending = None
        self.reservoir = Reservoir(t["compare_ticks"], self.seed)
        self._run(t["warmup_ticks"])
        self.first = self.records[0]
        self.last = self.records[-1]

    # -- the host boundary ------------------------------------------------
    def _source(self, k):
        """Tick k's state: the plant's, as a host array.  Keeps a
        reference to the program's warm start for the comparison."""
        with record_function("bench.state_in"):
            carry = self.loop._carry[0]
            if self.pending is not None:
                self.pending["post"] = carry
            rec = dict(pre=carry, x=self.x, post=None)
            self.records.append(rec)
            self.pending = rec
            rec["t_in"] = time.perf_counter()
            return self.x

    def _sink(self, k, cmd, u_apply):
        """Tick k's command at the host: recorded, then the plant takes
        one period under u_apply."""
        t_out = time.perf_counter()
        with record_function("bench.plant"):
            rec = self.records[k]
            rec["t_out"] = t_out
            rec["cmd"] = np.stack(cmd, axis=-1)
            rec["u_apply"] = u_apply
            self.x = ref.rk4(self.x, u_apply.astype(np.float64), self.dt,
                             self._stack)

    def _run(self, n):
        """`ServingLoop.run` over n ticks; returns its report."""
        self.records = []
        report = self.loop.run(n, self._source, self._sink, self.yref,
                               self.yref_e)
        if self.pending is not None:
            self.pending["post"] = self.loop._carry[0]
            self.pending = None
        return report

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> dict:
        self._ipm_fast.reset_escalation_counts()
        reports, recs, latency = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            reports.append(self._run(self.traffic["chunk_ticks"]))
            for r in self.records:
                self.reservoir.offer(r)
                if "t_out" in r:
                    latency.append(r["t_out"] - r["t_in"])
            recs = self.records
        elapsed = time.perf_counter() - t0
        self.last = recs[-1]
        esc = self._ipm_fast.escalation_counts()
        return dict(
            ticks=sum(r.ticks for r in reports), seconds=elapsed,
            latency_s=np.asarray(latency),
            issue_s=[float(v) for r in reports for v in r.issue_s],
            deadline_misses=sum(r.deadline_misses for r in reports),
            slips=sum(r.schedule_slips for r in reports),
            escalated_lanes=esc["lanes"])

    def traced_segment(self):
        self._run(self.trace_ticks)

    def end_to_end(self, window: dict) -> dict:
        """The median and the 95th percentile of the latency, over every
        tick of the window, ms (a late tick reads the newest state, so
        the latency does not grow with the schedule's backlog)."""
        lat = window["latency_s"]
        return dict(tick_latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
                    tick_latency_p95_ms=1e3 * float(np.percentile(lat, 95)))

    def counts(self, window: dict):
        """Lane-solves attempted in the window, and failed: lanes of
        ticks whose command never reached the host, or arrived not
        finite."""
        ticks, emitted = window["ticks"], len(window["latency_s"])
        bad = int((~np.isfinite(self.last["cmd"])).any(axis=1).sum())
        return ticks * self.B, (ticks - emitted) * self.B + bad

    def release(self):
        self.loop = None

    # -- correctness --------------------------------------------------------
    def check(self, prec: ref.Precision = ref.REFERENCE) -> dict:
        """The numbers compared, each with its limit: over the lanes of
        every compared tick (judge.settled), the worst gaps of the emitted
        u_apply and the carried input plan (kRPM), of the carried state
        plan, and of the emitted cmd_vel (degrees, deg/s, thrust in kRPM
        of mean rotor speed); a lane may give either answer where the
        escalation rule cannot be decided in float32 (judge.allowed)."""
        problem = program.reference_problem(self.config)
        solver = program.reference_solver(self.config)
        dev = self.device
        tally = judge.Tally()
        bf = lambda t: t.movedim(-1, 0)  # noqa: E731
        yref, yref_e = self.yref, self.yref_e
        for name, rec, from_start in compared(
                self.first, self.reservoir, self.last):
            x_host = torch.as_tensor(rec["x"], device=dev)
            if from_start:
                x_in, u_in = ref.init_iterate(
                    torch.as_tensor(self.x_init, device=dev).to(prec.dtype),
                    problem.N, problem.dt)
            else:
                x_in, u_in = bf(rec["pre"].x_traj), bf(rec["pre"].u_traj)
            ans = ref.tick_answers(problem, solver, x_in, u_in, x_host, yref,
                                   yref_e, prec)
            ok_plain, ok_esc = judge.allowed(ans["plain"][2], solver)
            print(f"compared tick {name}: "
                  f"{int((ans['plain'][2] > solver.escalate_mu_tol).sum())} "
                  "lanes above the escalation tolerance", file=sys.stderr)
            x_out, u_out = bf(rec["post"].x_traj), bf(rec["post"].u_traj)
            u_apply = torch.as_tensor(rec["u_apply"], device=dev)
            cmd = torch.as_tensor(rec["cmd"], device=dev).double()
            cmd[:, 2] /= PWM_PER_KRPM
            best = None
            for ok, branch in ((ok_plain, ans["plain"]),
                               (ok_esc, ans["escalated"])):
                if branch is None:
                    continue
                xr, ur, mu_b = branch
                cr = ref.cmd_vel(ur[:, 1], xr[:, 4])
                cr[:, 2] /= PWM_PER_KRPM
                g = dict(u=torch.maximum(judge.lane_max(u_out, ur),
                                         judge.lane_max(u_apply, ur[:, 0])),
                         x=judge.lane_max(x_out, xr),
                         cmd=judge.lane_max(cmd, cr))
                settled = ok & judge.settled(mu_b, self.limits)
                inf = torch.full_like(g["u"], torch.inf)
                g = {k: torch.where(settled, v, inf) for k, v in g.items()}
                best = g if best is None else {
                    k: torch.minimum(best[k], g[k]) for k in g}
            settled = torch.isfinite(best["u"])
            tally.add(best, settled,
                      judge.finite(x_out, u_out, u_apply, cmd))
        return tally.numbers(self.limits, ("u", "x", "cmd"))
