"""Traffic kind `closed_loop`: B vehicles regulated in lockstep on the
card, each tick one batched SQP-RTI step and the plant, as
`runtime.batch.swarm_hover` ticks them, with no host sync inside the
window.

Parameters (the mix's JSON file): `lanes`, `setpoint` (m) or a `grid`
of set-points ({"side", "spacing_m", "height_m"}), `pos_scale_m` (the
initial position offsets, that times N(0, 1) per lane, drawn on the card
from the seed), `plant_substeps`, `warmup_ticks`, `trace_ticks`,
`compare_ticks` (ticks of the window drawn from the seed for the
comparison, besides its last tick and the first tick of all).
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

import judge
import program
from fleet import Reservoir, compared, references, setpoints
from reference import rti as ref


class Cell:
    def __init__(self, config, traffic, limits, seed, device):
        program.check_params(config)
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed, self.device = seed, torch.device(device)
        self.trace_ticks = traffic["trace_ticks"]

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from crazyflie_nmpc_tpu_torch.models.quadrotor import dynamics
        from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
        from crazyflie_nmpc_tpu_torch.solver.rti import init_rti
        from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
            rti_step_batched, to_batch_last)

        self._step, self._integrate, self._dyn = (rti_step_batched,
                                                  integrate, dynamics)
        t, dev = self.traffic, self.device
        self.spec = spec = program.port_spec(self.config, dev)
        self.ipm = program.port_ipm(self.config)
        # the step's sweep forms (`fused_iter`, `windowed`), as the
        # configuration names them
        self.options = self.config.get("step_options", {})
        dtype = program.dtype_of(self.config)
        B, N = t["lanes"], spec.N
        self.B, self.N = B, N
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        pts = setpoints(t, B, dtype, dev)
        x0 = torch.zeros((B, 13), dtype=dtype, device=dev)
        x0[:, 0:3] = pts + t["pos_scale_m"] * torch.randn(
            (B, 3), generator=gen, dtype=dtype, device=dev)
        x0[:, 3] = 1.0
        self.x_init = x0
        self.yref, self.yref_e = references(pts, N,
                                            spec.params.hover_speed())
        self.states = to_batch_last(init_rti(spec, x0, device=dev))
        self.xs = x0
        self.issue = []
        self.reservoir = Reservoir(t["compare_ticks"], self.seed)
        # the first tick of all is compared from the reference's own
        # start; the warm-up's records are held until the window, so the
        # allocator has room for the sampled ticks' tensors
        warm = [self.tick() for _ in range(t["warmup_ticks"])]
        self.first = warm[0]
        self.last = warm[-1]
        del warm

    def tick(self) -> dict:
        """One closed-loop tick: the step (timed on the host: its issue)
        and the plant.  Returns the tick's record (references only)."""
        states, xs = self.states, self.xs
        with record_function("bench.step"):
            t0 = time.perf_counter()
            new, out = self._step(self.spec, states, xs, self.yref,
                                  self.yref_e, self.ipm,
                                  layout="batch_last", **self.options)
            self.issue.append(time.perf_counter() - t0)
        with record_function("bench.plant"):
            u0 = out.u0.T
            xs_next = self._integrate(self._dyn, self.spec.params, xs, u0,
                                      self.spec.dt,
                                      self.traffic["plant_substeps"])
        self.states, self.xs = new, xs_next
        return dict(x_in=states.x_traj, u_in=states.u_traj, xs_in=xs,
                    x_out=new.x_traj, u_out=new.u_traj, u0=u0,
                    xs_out=xs_next)

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> dict:
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        self.issue = []
        sync()
        t0 = time.perf_counter()
        ticks = 0
        while True:
            rec = self.tick()
            self.reservoir.offer(rec)
            self.last = rec
            ticks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        return dict(ticks=ticks, seconds=time.perf_counter() - t0,
                    issue_s=list(self.issue))

    def traced_segment(self):
        for _ in range(self.trace_ticks):
            self.tick()

    def end_to_end(self, window: dict) -> dict:
        return dict(solves_per_s=window["ticks"] * self.B
                    / window["seconds"])

    def counts(self, window: dict):
        """Lane-solves attempted in the window, and failed: lanes whose
        iterate or plant state is not finite at its close."""
        ok = judge.finite(self.states.x_traj.movedim(-1, 0),
                          self.states.u_traj.movedim(-1, 0), self.xs)
        return window["ticks"] * self.B, int((~ok).sum())

    def release(self):
        """Drop the program's state; keep the compared ticks' records."""
        self.states = self.xs = None

    # -- correctness --------------------------------------------------------
    def check(self, prec: ref.Precision = ref.REFERENCE) -> dict:
        """The numbers compared, each with its limit: the worst gaps of
        the new input plan (kRPM) and of the new state plan and the
        plant's next state, over the lanes of every compared tick that
        the reference settles (judge.settled)."""
        problem = program.reference_problem(self.config)
        solver = program.reference_solver(self.config)
        tally = judge.Tally()
        bf = lambda t: t.movedim(-1, 0)  # noqa: E731  batch-last -> first
        for _, rec, from_start in compared(self.first, self.reservoir,
                                                 self.last):
            if from_start:
                x_in, u_in = ref.init_iterate(
                    self.x_init.to(prec.dtype), problem.N, problem.dt)
            else:
                x_in, u_in = bf(rec["x_in"]), bf(rec["u_in"])
            ans = ref.tick_answers(problem, solver, x_in, u_in, rec["xs_in"],
                                   self.yref, self.yref_e, prec)
            x_ref, u_ref, mu = ans["plain"]
            plant = ref.plant_step(rec["xs_in"], rec["u0"], problem.dt,
                                   self.traffic["plant_substeps"], prec)
            x_out, u_out = bf(rec["x_out"]), bf(rec["u_out"])
            gaps = dict(
                u=judge.lane_max(u_out, u_ref),
                x=torch.maximum(judge.lane_max(x_out, x_ref),
                                judge.lane_max(rec["xs_out"], plant)))
            tally.add(gaps, judge.settled(mu, self.limits),
                      judge.finite(x_out, u_out, rec["xs_out"]))
        return tally.numbers(self.limits, ("u", "x"))
