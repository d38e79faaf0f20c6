"""High-level vehicle client: the reference's user API, re-designed
(PyTorch counterpart of `runtime/client.py`).

Mirrors the capability surface of crazyflie_demo/scripts/crazyflie.py:33-79
(takeoff / land / stop / goTo / uploadTrajectory / startTrajectory) and
the reference server's high-level services (crazyflie_server.cpp:920-992),
but instead of calling firmware trajectory primitives the client
generates reference trajectories (the differential-flatness tooling) and
hands them to the NMPC Tracking policy: every manoeuvre becomes an
optimal-control problem on the host.

The client owns the mission state (the policy and the trajectory table,
on the spec's device) and produces, per tick, the (yref, yref_e) pair for
`solver.rti.rti_step`; transport of the resulting commands is the
caller's choice.  A tick never waits on the card.  What reads the policy
on the host (`mode`, `done`, `go_to` without `from_pos`) and the spec's
tick length, read once at construction, each pass `device.host_sync`
with their reason, so they are counted.
"""

from __future__ import annotations

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import from_host, host_sync
from crazyflie_nmpc_tpu_torch.models.quadrotor import NU, NX
from crazyflie_nmpc_tpu_torch.solver import policies as pol
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.utils import trajectories as traj


class MissionClient:
    """Per-vehicle mission planner over the NMPC policy machine.

    Usage:
        client = MissionClient(spec)
        client.takeoff(height=0.5, duration=2.0, at=(0, 0, 0))
        ...
        yref, yref_e = client.tick()          # feed to rti_step each cycle
        client.go_to((1, 0, 0.5), duration=3.0)
    """

    def __init__(self, spec: OCPSpec):
        self.spec = spec
        self._dtype = spec.lbu.dtype
        self._device = spec.lbu.device
        with host_sync("client tick length"):
            self._dt = float(spec.dt)
        self._policy = pol.regulation_state((0.0, 0.0, 0.3),
                                            device=self._device)
        self._table = torch.zeros((1, NX + NU), dtype=self._dtype,
                                  device=self._device)
        self._uploaded: dict[int, tuple] = {}

    # ---- mission primitives (reference services) -----------------------

    def takeoff(self, height: float = 0.5, duration: float = 2.0,
                at=(0.0, 0.0, 0.0)):
        """Takeoff service (crazyflie_server.cpp:920-933): smooth climb
        from `at` to hover height."""
        self._start_table(traj.smooth_step_trajectory(
            self.spec.params, start=(at[0], at[1], max(at[2], 0.04)),
            end=(at[0], at[1], height), duration=duration, dt=self._dt,
            device=self._device))

    def land(self, from_pos, ground_z: float = 0.04,
             duration: float = 2.5):
        """Land service: smooth descent to ground_z, then hold."""
        self._start_table(traj.smooth_step_trajectory(
            self.spec.params, start=tuple(from_pos),
            end=(from_pos[0], from_pos[1], ground_z), duration=duration,
            dt=self._dt, device=self._device))

    def go_to(self, goal, from_pos=None, duration: float = 3.0):
        """GoTo service (crazyflie_server.cpp:947-960): min-jerk
        point-to-point move; from the current regulation set-point if
        `from_pos` is omitted (read on the host)."""
        if from_pos is None:
            with host_sync("client set-point"):
                from_pos = self._policy.setpoint.cpu().tolist()
        self._start_table(traj.smooth_step_trajectory(
            self.spec.params, start=tuple(from_pos), end=tuple(goal),
            duration=duration, dt=self._dt, device=self._device))

    def hover_at(self, setpoint):
        """Switch to pure Regulation at a set-point (the rqt panel's
        regulation mode, crazyflie_params.cfg:9-14)."""
        self._policy = pol.regulation_state(tuple(setpoint),
                                            device=self._device)

    def upload_trajectory(self, trajectory_id: int, durations, coeffs):
        """UploadTrajectory service (crazyflie_server.cpp:962-983): store a
        piecewise-polynomial trajectory (figure8.csv format pieces)."""
        self._uploaded[trajectory_id] = (np.asarray(durations),
                                         np.asarray(coeffs))

    def start_trajectory(self, trajectory_id: int, timescale: float = 1.0,
                         reversed: bool = False):
        """StartTrajectory service (crazyflie_server.cpp:985-997): sample
        the uploaded polynomial onto the NMPC grid and start tracking."""
        durations, coeffs = self._uploaded[trajectory_id]
        table = traj.sample_poly_trajectory(
            durations * timescale, coeffs, self.spec.params, dt=self._dt,
            device=self._device)
        if reversed:
            table = table.flip(0)
        self._start_table(table)

    def track_file(self, path: str):
        """Track a 17-column trajectory file (the ref_traj rosparam,
        acados_mpc.cpp:727-728), read as float32 as the JAX client does."""
        self._start_table(from_host(traj.load_traj_txt(path), torch.float32,
                                    self._device))

    def stop(self):
        """Stop/emergency: freeze at the current set-point (the radio-level
        kill lives in native.LinkServer.emergency)."""
        self._policy = pol.regulation_state(self._policy.setpoint,
                                            device=self._device)

    # ---- per-tick reference generation ---------------------------------

    def tick(self):
        """Produce (yref (N, 17), yref_e (13,)) and advance the playhead."""
        yref, yref_e, self._policy = pol.make_yref(self.spec, self._policy,
                                                   self._table)
        return yref, yref_e

    @property
    def mode(self) -> int:
        with host_sync("client mode"):
            return int(self._policy.mode)

    @property
    def done(self) -> bool:
        """True when a started trajectory has been consumed (policy latched
        to Position_Hold)."""
        with host_sync("client done"):
            return int(self._policy.mode) == pol.POSITION_HOLD

    def _start_table(self, table):
        self._table = table.to(self._dtype)
        # the hold point is the trajectory's end; the playhead starts at 0
        self._policy = pol.tracking_state(table[-1, 0:3],
                                          device=self._device)
