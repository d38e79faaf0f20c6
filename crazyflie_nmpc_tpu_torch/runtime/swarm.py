"""Swarm serving: ONE batched solve fanned out to N wire vehicles
(PyTorch counterpart of `runtime/swarm.py`).

The reference's multi-drone hub runs one thread and one NMPC node per
Crazyflie (crazyflie_server.cpp:155,1108-1131; the multi_hover_* launch
files).  Here the batch axis is the vehicle axis: each tick every
vehicle's telemetry (mocap position, stabilizer Euler angles, gyro: the
acados_estimator.cpp:452-513 channel set) crosses the link into (B, 3)
arrays, one `rti_step_batched` call solves all B problems on the card,
and B cmd_vel commands fan back out through the native link server.

One tick on the device:

    telemetry (B,3)x3  ->  batched estimator fuse     (estimator.pipeline.
                           fuse over the lanes: Euler->quat, IIR-LPF
                           velocity differentiation, body-frame rotation)
                       ->  delay predictor            (d wire ticks through
                           the onboard cascade under each vehicle's last
                           cmd_vel, models.firmware.attitude_plant_step)
                       ->  rti_step_batched with per-vehicle (B, N, ny)
                           references (K1-K4 on the card)
                       ->  u1/x4 -> cmd_vel           (acados_mpc.cpp:
                           619-625,644-670)

Only the (B, 4) commands and the (B, nu) rotor commands cross back to the
host, through pinned memory (`serving._Fetch`).  On the card the fuse and
the predictor replay one CUDA graph, and so does each segment of the IPM
iteration's barrier algebra (`ops.ipm_fast.LoopGraphs`), the kernels
launching between them as always: a tick issues ~260 operations from the
host.  The interpreter is then free for the vehicles' threads, which
share it in a realtime loop (`roofline.realtime_tick`).

`SwarmNMPC` owns the step; `serve_swarm` binds it to a `LinkServer` and N
`CascadeFirmwareSim` endpoints with per-vehicle deadline accounting
(`SwarmReport`).  Two time disciplines:

  * lockstep (default): vehicle physics advance exactly one tick period
    per host tick under manual `poll()`, deterministic and sleep-free, the
    wire still real UDP both ways.  A tick waits until all three
    telemetry blocks of every vehicle have crossed for it (the JAX
    package waits for the position block alone, `swarm.py:350-351`, so a
    tick may fuse the previous tick's attitude and rates);
  * realtime: the endpoints run their own serve threads and the host
    loop runs on a `TickScheduler` at the configured rate.

A telemetry row that was never updated counts as stale from the start
(the JAX package reads it as fresh, `swarm.py:295-297`), and a lockstep
tick drains each vehicle's socket before its setpoints go out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import time
from typing import Optional

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import (from_host, host_sync,
                                             resolve_device)
from crazyflie_nmpc_tpu_torch.estimator.lpf import VelocityLPFState
from crazyflie_nmpc_tpu_torch.estimator.pipeline import (EstimatorState,
                                                         fuse,
                                                         init_estimator)
from crazyflie_nmpc_tpu_torch.models import rotations
from crazyflie_nmpc_tpu_torch.models.firmware import (AttitudeGains,
                                                      attitude_plant_step)
from crazyflie_nmpc_tpu_torch.models.quadrotor import NX, NY
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu_torch.ops.ipm_fast import LoopGraphs
from crazyflie_nmpc_tpu_torch.runtime.serving import (ESCALATION_CAPACITY,
                                                      TickScheduler, _Fetch)
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.outputs import krpm2pwm, to_cmd_vel
from crazyflie_nmpc_tpu_torch.solver.rti import RTIState, init_rti, rti_step
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (rti_step_batched,
                                                         to_batch_last)


class SwarmNMPC:
    """The device side: one batched NMPC step for B vehicles.

    targets: (B, 3) formation hover positions; lane b's reference
    regulates vehicle b to targets[b] (the per-problem (B, N, ny)
    reference path of rti_step_batched).  `use_fused=None` (or True)
    solves with `rti_step_batched`, False with `rti_step` lane by lane.
    `device` (None: the card) is where the step runs; the spec lives
    there.
    """

    def __init__(self, spec: OCPSpec, targets,
                 ipm_config: Optional[IPMConfig] = None,
                 delay_steps: int = 1, use_fused: Optional[bool] = None,
                 gains: AttitudeGains = AttitudeGains(),
                 predict_substeps: int = 4,
                 tick_dt: Optional[float] = None, device=None):
        """tick_dt: the real interval between telemetry samples (the
        serving period).  The estimator's velocity differentiation and
        the delay predictor's integration step use it; None = spec.dt
        (the 66.6 Hz contract)."""
        self.device = resolve_device(device)
        if spec.lbu.device.type != self.device.type:
            raise ValueError(f"the spec lives on {spec.lbu.device}, the "
                             f"swarm serves on {self.device}")
        targets = np.asarray(targets, np.float64)
        self.spec = spec
        self.batch = self.lanes = B = targets.shape[0]
        self.targets = targets
        self.use_fused = use_fused is not False
        if ipm_config is None:
            ipm_config = certified_config(
                capacity=min(ESCALATION_CAPACITY, B)
                if self.use_fused else 0)
        self.ipm_config = ipm_config
        self.delay_steps = int(delay_steps)
        self.gains = gains
        self.dtype = spec.lbu.dtype

        # per-vehicle regulation references (hover_yref at each target),
        # built on the host and copied once
        y = np.zeros((B, NY))
        y[:, :3] = targets
        y[:, 3] = 1.0
        y[:, NX:] = spec.params.hover_speed()
        y = from_host(y, self.dtype, self.device)
        self._yref = y[:, None].expand(B, spec.N, NY)
        self._yref_e = y[:, :NX]

        self.tick_dt = dt = (float(tick_dt) if tick_dt is not None
                             else float(spec.dt))
        # keep the cascade-prediction substep near the 1.5 ms the
        # envelope study validated, whatever the tick period
        self.substeps = max(predict_substeps, int(round(dt / 0.004)))
        self._carry = None
        self._graph = None
        # the IPM iteration's barrier algebra replayed from CUDA graphs:
        # issued operation by operation it held the interpreter for most
        # of a tick, which a realtime loop shares with the link's threads
        self._loop_graphs = (LoopGraphs() if self.device.type == "cuda"
                             and self.use_fused else None)

    def _predict_plain(self, x, cmd_prev):
        """d wire ticks ahead through the onboard cascade holding each
        vehicle's last cmd_vel (the model-consistent single-last-command
        predictor of closed_loop.cmd_vel_loop)."""
        for _ in range(self.delay_steps):
            x = attitude_plant_step(self.spec.params, x, cmd_prev,
                                    self.tick_dt, substeps=self.substeps,
                                    gains=self.gains)[0]
        return x

    def _front_plain(self, p_prev, v_prev, v_prev2, elapsed, tele,
                     cmd_prev):
        """The estimator's fuse of the (B, 9) telemetry [mocap, Euler
        deg, gyro deg/s] on the filter state, then `_predict_plain`:
        (the filter's four new state tensors, x)."""
        lpf = VelocityLPFState(p_prev, v_prev, v_prev2, elapsed)
        est, x = fuse(EstimatorState(lpf=lpf, last_u=None), tele[:, 0:3],
                      rotations.deg2rad(tele[:, 3:6]),
                      rotations.deg2rad(tele[:, 6:9]), self.tick_dt)
        new = est.lpf
        return (new.p_prev, new.v_prev, new.v_prev2, new.elapsed,
                self._predict_plain(x, cmd_prev))

    def _front(self, est, tele, cmd_prev):
        """`_front_plain` -> (EstimatorState', x); on the card replayed
        from a CUDA graph captured at its first call.  The cascade is ~900
        small operations a substep (12 substeps a tick at 20 Hz) and the
        fuse ~110: issued one by one they cost the host more than a 50 ms
        period, while the graph is one launch."""
        lpf = est.lpf
        args = (lpf.p_prev, lpf.v_prev, lpf.v_prev2, lpf.elapsed, tele,
                cmd_prev)
        if tele.device.type != "cuda":
            out = self._front_plain(*args)
        else:
            if self._graph is None:
                self._graph = _capture(self._front_plain, *args)
            graph, static, out = self._graph
            for dst, src in zip(static, args):
                dst.copy_(src)
            graph.replay()
            # the next replay overwrites the outputs (p_prev is a view of
            # the static telemetry): the carry keeps copies
            out = tuple(o.clone() for o in out)
        return (EstimatorState(lpf=VelocityLPFState(*out[:4]),
                               last_u=est.last_u), out[4])

    def _step(self, tele):
        est, states, cmd_prev = self._carry
        est, x = self._front(est, tele, cmd_prev)
        if self.use_fused:
            states, out = rti_step_batched(self.spec, states, x, self._yref,
                                           self._yref_e, self.ipm_config,
                                           layout="batch_last",
                                           graphs=self._loop_graphs)
            u_apply = out.u_plan[0].T                       # (B, nu)
            tw = to_cmd_vel(out.u_plan[1].T, out.x_plan[4].T)
        else:
            outs = []
            for b, st in enumerate(states):
                states[b], out = rti_step(self.spec, st, x[b],
                                          self._yref[b], self._yref_e[b],
                                          self.ipm_config)
                outs.append(out)
            u_apply = torch.stack([o.u_plan[0] for o in outs])
            tw = to_cmd_vel(torch.stack([o.u_plan[1] for o in outs]),
                            torch.stack([o.x_plan[4] for o in outs]))
        cmd = torch.stack([tw.roll_deg, tw.pitch_deg, tw.yawrate_deg,
                           tw.thrust_pwm], dim=-1)
        self._carry = (est, states, cmd)
        return cmd, u_apply

    def reset(self, x0s):
        """(Re)initialize warm starts, estimator filters (one state
        broadcast over the lanes) and the held hover cmd_vel from (B, nx)
        vehicle states."""
        x0s = from_host(x0s, self.dtype, self.device)
        st = init_rti(self.spec, x0s, device=self.device)
        if self.use_fused:
            states = to_batch_last(st)
        else:
            states = [RTIState(x_traj=st.x_traj[b], u_traj=st.u_traj[b])
                      for b in range(self.lanes)]
        est = init_estimator(self.spec.params, x0s[:, :3])
        est = EstimatorState(lpf=est.lpf,
                             last_u=est.last_u.expand(self.lanes, -1))
        uss = self.spec.steady_input(self.dtype)
        cmd0 = torch.zeros((self.lanes, 4), dtype=self.dtype,
                           device=self.device)
        cmd0[:, 3] = krpm2pwm(uss.mean())
        self._carry = (est, states, cmd0)

    def step(self, mocap, euler_deg, gyro_deg):
        """One serving tick: (B,3) telemetry arrays -> (B,4) cmd_vel rows
        [roll deg, pitch deg, yawrate deg/s, thrust PWM] + (B,nu) rotor
        plan row 0 (the motvel loopback), numpy."""
        if self._carry is None:
            raise RuntimeError("call reset() before step()")
        tele = from_host(np.concatenate(
            [np.asarray(a, np.float64) for a in (mocap, euler_deg,
                                                  gyro_deg)], axis=1),
            self.dtype, self.device)
        # the first step on the card captures the estimator's and the
        # solve's graphs, and torch waits for the card to capture: one
        # intended wait, counted as a `host_sync("graph capture")`
        with (host_sync("graph capture") if self._graph is None
              and self.device.type == "cuda" else contextlib.nullcontext()):
            cmd, u_apply = self._step(tele)
        packed = _Fetch(torch.cat([cmd, u_apply], dim=-1)).numpy()
        return packed[:, :4].copy(), packed[:, 4:].copy()


def _capture(fn, *args):
    """fn(*args) captured as a CUDA graph on static copies of its tensor
    arguments: (graph, the static inputs, the static output)."""
    static = tuple(a.clone() for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)                            # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)
    return graph, static, out


@dataclasses.dataclass
class SwarmReport:
    """Per-vehicle serving evidence for a swarm run."""

    n_vehicles: int
    ticks: int
    period_s: float
    #: (ticks, B) per-vehicle emit latency: setpoint-on-the-wire instant
    #: minus that tick's telemetry-gather start
    latency_s: np.ndarray
    #: (ticks, B) telemetry freshness: ticks since each vehicle's rows
    #: (all three blocks) were last updated when the solve consumed them
    #: (0 = fresh; a row never updated counts from before tick 0)
    staleness: np.ndarray
    #: (B,) final |position - target| per vehicle [m]
    final_err_m: np.ndarray
    #: (ticks, B) per-vehicle positions (from telemetry)
    positions: np.ndarray
    schedule_slips: int = 0

    def deadline_misses(self, budget_s: float) -> np.ndarray:
        """(B,) count of ticks whose emit latency exceeded the budget."""
        return (self.latency_s > budget_s).sum(axis=0)

    def summary(self, budget_s: Optional[float] = None) -> dict:
        budget = self.period_s if budget_s is None else budget_s
        lat = self.latency_s
        return dict(
            n_vehicles=self.n_vehicles, ticks=self.ticks,
            rate_hz=1.0 / self.period_s,
            p50_ms=1e3 * float(np.percentile(lat, 50)),
            p99_ms=1e3 * float(np.percentile(lat, 99)),
            worst_vehicle_miss=int(self.deadline_misses(budget).max()),
            total_misses=int(self.deadline_misses(budget).sum()),
            stale_ticks=int((self.staleness > 0).sum()),
            final_err_max_m=float(self.final_err_m.max()),
            schedule_slips=self.schedule_slips,
        )


class _TelemetryPlane:
    """Per-vehicle log blocks -> (B,3) mocap/euler/gyro arrays.

    Creates the three 12-byte blocks the estimator consumes
    (stateEstimate.*, stabilizer.*, gyro.*: acados_estimator.cpp:
    452-513) on every vehicle at the 10 ms firmware granularity, and
    drains them into latest-value rows, each block's last update tick
    kept (-1: never).
    """

    BLOCKS = {1: ("stateEstimate.x", "stateEstimate.y", "stateEstimate.z"),
              2: ("stabilizer.roll", "stabilizer.pitch", "stabilizer.yaw"),
              3: ("gyro.x", "gyro.y", "gyro.z")}

    def __init__(self, server, vids, fws):
        self.server = server
        self.vids = list(vids)
        B = len(self.vids)
        self.mocap = np.zeros((B, 3), np.float64)
        self.euler = np.zeros((B, 3), np.float64)
        self.gyro = np.zeros((B, 3), np.float64)
        self.last_update = np.full((B, len(self.BLOCKS)), -1, np.int64)
        for b, (vid, fw) in enumerate(zip(self.vids, fws)):
            self.mocap[b] = fw.x[:3]
            for bid, names in self.BLOCKS.items():
                ids = [fw.log_vars[n][0] for n in names]
                server.log_create_block(vid, bid, [(7, i) for i in ids])
                server.log_start_block(vid, bid, 1)      # 10 ms period

    def drain(self, tick: int) -> None:
        """Ingest every pending log record into the latest-value rows."""
        arrays = {1: self.mocap, 2: self.euler, 3: self.gyro}
        for b, vid in enumerate(self.vids):
            while True:
                rec = self.server.poll_log(vid)
                if rec is None:
                    break
                arr = arrays.get(rec["block_id"])
                if arr is not None and len(rec["payload"]) >= 12:
                    arr[b] = struct.unpack("<fff", rec["payload"][:12])
                    self.last_update[b, rec["block_id"] - 1] = tick

    def fresh(self, tick: int) -> bool:
        """Every block of every vehicle updated at `tick` or later."""
        return bool((self.last_update >= tick).all())

    def staleness(self, tick: int) -> np.ndarray:
        """(B,) ticks since a vehicle's oldest block was updated; a block
        never updated counts from before tick 0 (tick + 1)."""
        return tick - self.last_update.min(axis=1)


def serve_swarm(spec: OCPSpec, server, vids, fws, swarm: SwarmNMPC,
                ticks: int, rate_hz: float = 66.6,
                lockstep: bool = True,
                wire_settle_s: float = 0.5) -> SwarmReport:
    """Fly B wire vehicles from ONE batched solve for `ticks`.

    server/vids/fws: a LinkServer with the B registered vehicles and
    their `CascadeFirmwareSim` endpoints (same order as swarm.targets).

    lockstep=True advances each vehicle's physics exactly one period per
    host tick via manual poll() (deterministic; the wire is still real
    UDP both ways).  Each tick waits until all three telemetry blocks of
    every vehicle have crossed the link for this tick (`wire_settle_s`
    bounds that wait).  lockstep=False expects the endpoints to be
    serving real time and paces the host loop with a TickScheduler.
    """
    period = 1.0 / rate_hz
    period_ms = max(1, int(round(period * 1e3)))
    B = len(vids)
    plane = _TelemetryPlane(server, vids, fws)

    swarm.reset(np.stack([fw.x for fw in fws]))
    # run one step OUTSIDE the accounted loop (the kernels' first
    # launches load them), then restore a fresh carry
    swarm.step(plane.mocap, plane.euler, plane.gyro)
    swarm.reset(np.stack([fw.x for fw in fws]))

    latency = np.zeros((ticks, B))
    staleness = np.zeros((ticks, B), np.int64)
    positions = np.zeros((ticks, B, 3))
    sched = None
    if not lockstep:
        sched = TickScheduler(period)
        sched.start()

    for k in range(ticks):
        if lockstep:
            # advance every vehicle one tick period (physics + stream),
            # then wait until THIS tick's rows have crossed the link
            for fw in fws:
                fw.poll(period_ms)
            deadline = time.perf_counter() + wire_settle_s
            while True:
                plane.drain(k)
                if plane.fresh(k):
                    break
                if time.perf_counter() >= deadline:
                    break
                time.sleep(0.0002)    # yield to the link threads
        else:
            sched.wait_for_tick(k)

        t_state = time.perf_counter()
        plane.drain(k)
        staleness[k] = plane.staleness(k)
        positions[k] = plane.mocap
        cmd, _u_apply = swarm.step(plane.mocap, plane.euler, plane.gyro)
        if lockstep:
            # drain the keep-alive pings the link sent during the solve
            # (time does not advance): behind a full receive buffer the
            # setpoints would be dropped on a host slower than ~0.3 s a
            # tick (the JAX package's lockstep drops them there)
            for fw in fws:
                fw.poll(0)
        for b, vid in enumerate(vids):
            server.send_setpoint(vid, float(cmd[b, 0]), float(cmd[b, 1]),
                                 float(cmd[b, 2]), int(cmd[b, 3]))
            latency[k, b] = time.perf_counter() - t_state

    # settle the wire so the last setpoints land before teardown
    # (lockstep only: in realtime mode the serve threads are pumping and
    # a concurrent manual poll would race them on the socket)
    if lockstep:
        for fw in fws:
            fw.poll(1)
    else:
        time.sleep(0.02)
    final_err = np.linalg.norm(
        np.stack([fw.x[:3] for fw in fws]) - swarm.targets, axis=1)
    return SwarmReport(
        n_vehicles=B, ticks=ticks, period_s=period,
        latency_s=latency, staleness=staleness,
        final_err_m=final_err, positions=positions,
        schedule_slips=sched.slips if sched else 0)


def grid_targets(n: int, spacing: float = 0.6, z: float = 0.4):
    """A square-ish formation grid at height z, centered on the origin."""
    cols = int(np.ceil(np.sqrt(n)))
    pts = []
    for i in range(n):
        r, c = divmod(i, cols)
        pts.append((c * spacing, r * spacing, z))
    pts = np.asarray(pts, np.float64)
    pts[:, :2] -= pts[:, :2].mean(axis=0)
    return pts
