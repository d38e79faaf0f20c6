"""Real-time NMPC serving: fixed-rate host loop with deadline accounting
(PyTorch counterpart of `runtime/serving.py`).

The reference's defining runtime property is a hard-rate feedback loop: a
66.6 Hz ros::Timer drives estimator + NMPC (acados_estimator.cpp:642),
giving each tick a 15 ms budget; round-trip actuation delay is absorbed by
commanding deeper stages of the open-loop plan (u1 / x4 = +60 ms,
acados_mpc.cpp:619-670).

State crosses the host boundary, the solve runs on the card, and the
cmd_vel command leaves, all under an absolute-time tick schedule with
per-tick accounting (feedback latency, deadline misses, schedule slips).

Two serving disciplines:

  * synchronous (pipeline_depth=0): the command for tick k is computed and
    emitted inside tick k;
  * pipelined (pipeline_depth=d>0): the solve for tick k is issued and its
    command emitted d ticks later, while newer solves are queued behind
    it.  The d ticks of actuation delay are compensated by predicting the
    anchor state through the gap under the d pending commands, which stay
    on the card (the acados sim-solver predictor,
    acados_estimator.cpp:573-593, under the actual pending buffer).

Only the (B, 4) command and the (B, nu) rotor command cross to the host a
tick, copied without blocking into pinned memory; the emit waits on that
copy's event alone.  The two intended waits on the card, the emit and the
batched solver's escalation check, go through `device.host_sync`, which
counts them and lets them through `torch.cuda.set_sync_debug_mode`.

`TickScheduler` is pure host logic with an injectable clock;
`ServingLoop` binds it to the solver: `use_fused=None` (or True) steps all
lanes at once with `rti_step_batched` (batch-last, the card's kernels K1-K4
on CUDA tensors, their plain versions on the CPU), `use_fused=False` steps
each lane with the single-instance `rti_step` in a loop (the JAX package
vmaps it; the port's `rti_step` waits on the card once a solve when
escalation is configured, so a batched form gains nothing there).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import (from_host, host_sync,
                                             resolve_device)
from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.outputs import BodyTwist, to_cmd_vel
from crazyflie_nmpc_tpu_torch.solver.rti import RTIState, init_rti, rti_step
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (rti_step_batched,
                                                         to_batch_last)

# The escalation sub-batch of the batched path: the JAX package's
# min(block_b, 256) at its block_b=128, capped at the lane count.
ESCALATION_CAPACITY = 128


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-rate contract (reference values: acados_estimator.cpp:642)."""

    rate_hz: float = 66.6
    #: per-tick deadline for the emitted command; None = one period (15 ms)
    budget_s: Optional[float] = None
    #: headline latency target (BASELINE.json: feedback < 10 ms)
    target_s: float = 0.010
    #: 0 = synchronous; d>0 = d solves in flight, commands d stages deeper
    pipeline_depth: int = 0

    @property
    def period_s(self) -> float:
        return 1.0 / self.rate_hz

    @property
    def budget(self) -> float:
        return self.period_s if self.budget_s is None else self.budget_s


@dataclasses.dataclass
class ServeReport:
    """Per-run accounting produced by the serving loop."""

    config: ServeConfig
    #: feedback latency per emitted command: emit instant - the instant the
    #: corresponding state crossed the host boundary (seconds)
    latency_s: np.ndarray
    #: service time per tick: emit instant - scheduled tick start
    service_s: np.ndarray
    #: scheduled tick starts that slipped by more than half a period
    schedule_slips: int
    ticks: int
    #: host time spent issuing each tick's solve (the port's addition)
    issue_s: Optional[np.ndarray] = None

    def percentile(self, q: float, which: str = "latency") -> float:
        arr = self.latency_s if which == "latency" else self.service_s
        return float(np.percentile(arr, q)) if arr.size else float("nan")

    @property
    def deadline_misses(self) -> int:
        """Commands emitted past their deadline.

        Synchronous: latency > budget.  Pipelined (depth d): the command
        for tick k is scheduled to leave within tick k+d, so its deadline
        is (d periods + budget) after its state instant.
        """
        d = self.config.pipeline_depth
        deadline = self.config.budget + d * self.config.period_s
        return int(np.sum(self.latency_s > deadline))

    def summary(self) -> dict:
        lat = self.latency_s
        out = dict(
            ticks=self.ticks,
            rate_hz=self.config.rate_hz,
            pipeline_depth=self.config.pipeline_depth,
            p50_ms=1e3 * self.percentile(50),
            p99_ms=1e3 * self.percentile(99),
            max_ms=1e3 * float(lat.max()) if lat.size else float("nan"),
            deadline_misses=self.deadline_misses,
            schedule_slips=self.schedule_slips,
            budget_ms=1e3 * self.config.budget,
            target_ms=1e3 * self.config.target_s,
        )
        if self.issue_s is not None and self.issue_s.size:
            out["issue_ms"] = 1e3 * float(np.mean(self.issue_s))
        return out


class TickScheduler:
    """Absolute-time tick schedule with slip accounting.

    Ticks are anchored to t0 + k*period (never to the previous tick's end),
    so a slow tick does not shift the whole schedule, the same discipline
    as a ros::Timer.  `clock`/`sleep` are injectable for tests.
    """

    def __init__(self, period_s: float,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.period = period_s
        self.clock = clock
        self._sleep = sleep
        self.t0 = None
        self.slips = 0

    def start(self):
        self.t0 = self.clock()
        self.slips = 0
        return self.t0

    def tick_start(self, k: int) -> float:
        """Scheduled start instant of tick k."""
        return self.t0 + k * self.period

    def wait_for_tick(self, k: int) -> float:
        """Sleep until tick k's scheduled start; count slips > period/2.

        Returns the actual start instant.
        """
        target = self.tick_start(k)
        while True:
            now = self.clock()
            remaining = target - now
            if remaining <= 0:
                break
            # coarse sleep, then spin the last millisecond for precision
            if remaining > 1.5e-3:
                self._sleep(remaining - 1e-3)
            else:
                self._sleep(0)
        now = self.clock()
        if now - target > 0.5 * self.period:
            self.slips += 1
        return now


class _Fetch:
    """A tick's (B, k) host-bound result: copied without blocking into
    pinned memory on the card, with an event to wait on; on the CPU the
    tensor itself."""

    def __init__(self, packed: torch.Tensor):
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            with host_sync("emit"):
                self.event.synchronize()
        return self.host.numpy()


class ServingLoop:
    """Host-in-the-loop NMPC serving at a fixed rate.

        state_source(k) -> (B, nx) array or tensor  [the host boundary, in]
        ... solve (+ plan-depth command extraction, on the device) ...
        command_sink(k, cmd, u_apply)               [the host boundary, out]

    cmd is a BodyTwist of (B,) numpy arrays (the reference's cmd_vel
    contract, acados_mpc.cpp:644-670); u_apply is the (B, nu) rotor-speed
    command aligned to the emission instant (u_plan[0] of the tick's
    solve, the acados_motvel loopback, acados_mpc.cpp:628-642).

    `device` (None: the card) is where the solve runs; the spec must live
    there.  A state the source returns as a tensor on that device is used
    as it is; a host array is copied there without blocking.
    """

    def __init__(self, spec: OCPSpec,
                 ipm_config: Optional[IPMConfig] = None,
                 serve: ServeConfig = ServeConfig(), batch: int = 1,
                 use_fused: Optional[bool] = None,
                 predict_gap: bool = True, device=None):
        """predict_gap=False disables the pipeline-gap anchor prediction
        (solves run from the raw, depth-stale state): the ablation arm of
        the delay-compensation claim, which diverges at depth > 0 on the
        rotor-level plant.  No effect at depth 0."""
        self.device = resolve_device(device)
        if spec.lbu.device.type != self.device.type:
            raise ValueError(f"the spec lives on {spec.lbu.device}, the "
                             f"loop serves on {self.device}")
        self.spec = spec
        self.serve = serve
        self.batch = batch
        self.predict_gap = predict_gap
        self._d = serve.pipeline_depth if predict_gap else 0
        if spec.N < 5:
            raise ValueError("the reference command extraction (u1, x4 = "
                             "+60 ms, acados_mpc.cpp:619-625) needs N >= 5")
        self.use_fused = use_fused is not False
        if ipm_config is None:
            # the certified operating point: escalation re-solves at most
            # ESCALATION_CAPACITY unconverged lanes a tick on the batched
            # path; each lane's rti_step escalates on its own
            ipm_config = certified_config(
                capacity=min(ESCALATION_CAPACITY, batch)
                if self.use_fused else 0)
        self.ipm_config = ipm_config
        self.dtype = spec.lbu.dtype
        self._carry = None

    # -- the step -----------------------------------------------------------
    def _predict(self, x0s, pending):
        """Advance (B, nx) anchors through the pipeline gap under the d
        pending (issued, not yet acting) commands."""
        spec = self.spec
        for i in range(self._d):
            x0s = integrate(spec.ode(), spec.params, x0s, pending[i],
                            spec.dt, spec.sim_steps)
        return x0s

    def _step(self, x0s, yref, yref_e):
        """One tick on the device; its command and u_apply, packed
        (B, 4 + nu), on their way to the host (`_Fetch`)."""
        states, pending = self._carry
        x0s = self._predict(x0s, pending)
        if self.use_fused:
            states, out = rti_step_batched(self.spec, states, x0s, yref,
                                           yref_e, self.ipm_config,
                                           layout="batch_last")
            u_apply = out.u_plan[0].T                       # (B, nu)
            cmd = to_cmd_vel(out.u_plan[1].T, out.x_plan[4].T)
        else:
            outs = []
            for b, st in enumerate(states):
                states[b], out = rti_step(self.spec, st, x0s[b], yref,
                                          yref_e, self.ipm_config)
                outs.append(out)
            u_apply = torch.stack([o.u_plan[0] for o in outs])
            cmd = to_cmd_vel(torch.stack([o.u_plan[1] for o in outs]),
                             torch.stack([o.x_plan[4] for o in outs]))
        if self._d:
            pending = torch.cat([pending[1:], u_apply[None]], dim=0)
        self._carry = (states, pending)
        # (B, 4 + nu): the cmd_vel fields in BodyTwist order, then u_apply
        return _Fetch(torch.cat([torch.stack(tuple(cmd), dim=-1), u_apply],
                                dim=-1))

    # -- state management -------------------------------------------------
    def _input(self, x) -> torch.Tensor:
        return from_host(x, self.dtype, self.device)

    def reset(self, x0s):
        """(Re)initialize warm starts + pending-command buffer from (B, nx)
        states.  Pending commands start at the steady input (hover), the
        same neutral assumption the estimator predictor makes before the
        first command arrives."""
        x0s = self._input(x0s)
        st = init_rti(self.spec, x0s, device=self.device)
        if self.use_fused:
            states = to_batch_last(st)
        else:
            states = [RTIState(x_traj=st.x_traj[b], u_traj=st.u_traj[b])
                      for b in range(x0s.shape[0])]
        uss = self.spec.steady_input(self.dtype)
        pending = uss.expand((self.serve.pipeline_depth, x0s.shape[0])
                             + uss.shape).contiguous()
        self._carry = (states, pending)

    def _emit(self, handle):
        """A tick's command at the host: (BodyTwist of (B,), (B, nu))."""
        packed = handle.numpy()
        cmd = BodyTwist(*(packed[:, i].copy() for i in range(4)))
        return cmd, packed[:, 4:].copy()

    def warmup(self, x0s, yref, yref_e, iters: int = 3):
        """Run a few steps (the kernels' first launches load them) so
        `run` starts hot."""
        self.reset(x0s)
        yref, yref_e = self._input(yref), self._input(yref_e)
        for _ in range(iters):
            handle = self._step(self._input(x0s), yref, yref_e)
        self._emit(handle)

    # -- the serving loop ---------------------------------------------------
    def run(self, n_ticks: int, state_source, command_sink, yref, yref_e,
            clock: Callable[[], float] = time.perf_counter,
            sleep: Callable[[float], None] = time.sleep) -> ServeReport:
        """Serve `n_ticks` ticks at the configured rate.

        state_source(k) -> (B, nx) state at the host boundary (numpy, or a
        tensor on the loop's device).  command_sink(k, cmd, u_apply):
        receives tick k's command (for pipelined serving this is called d
        ticks after k; see the module docstring).
        """
        if self._carry is None:
            raise RuntimeError("call warmup()/reset() before run()")
        yref, yref_e = self._input(yref), self._input(yref_e)
        depth = self.serve.pipeline_depth
        sched = TickScheduler(self.serve.period_s, clock, sleep)
        inflight = collections.deque()   # (tick, state_instant, handle)
        latency, service, issue = [], [], []

        sched.start()
        total = n_ticks + depth
        for k in range(total):
            sched.wait_for_tick(k)
            if k < n_ticks:
                t_state = clock()
                dev = self._input(state_source(k))
                inflight.append((k, t_state, self._step(dev, yref,
                                                        yref_e)))
                issue.append(clock() - t_state)
            # tick j's command leaves in tick j + depth (the JAX
            # package's len(inflight) > depth or k >= n_ticks, which
            # pops an empty queue when n_ticks < depth)
            if inflight and inflight[0][0] + depth <= k:
                tick, t_state, handle = inflight.popleft()
                cmd, u_apply = self._emit(handle)   # waits for its copy
                t_emit = clock()
                command_sink(tick, cmd, u_apply)
                latency.append(t_emit - t_state)
                service.append(t_emit - sched.tick_start(tick + depth))

        return ServeReport(
            config=self.serve,
            latency_s=np.asarray(latency),
            service_s=np.asarray(service),
            schedule_slips=sched.slips,
            ticks=n_ticks,
            issue_s=np.asarray(issue),
        )


def measure_transport_floor(nx: int = 13, batch: int = 1, n: int = 200,
                            device=None) -> dict:
    """Per-tick host<->device transport cost, solver excluded.

    Times the minimal serving round trip on the resolved device (None: the
    card): put a (B, nx) state, run a trivial op, fetch the (B, 4)
    command.  `platform` is the device type, "cuda" or "cpu".
    """
    dev = resolve_device(device)

    def once(x):
        out = torch.from_numpy(x).to(dev)[:, :4] + 1.0
        return out.cpu().numpy()

    x = np.zeros((batch, nx), np.float32)
    once(x)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        once(x)
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return dict(platform=dev.type,
                p50_ms=1e3 * float(np.percentile(ts, 50)),
                p99_ms=1e3 * float(np.percentile(ts, 99)))
