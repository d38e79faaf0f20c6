"""Flying firmware sim: a high-level-commander EXECUTOR behind the link
(PyTorch port's copy of the JAX package's `native/hl_executor.py`).

    CRTP HL command -> planner (min-jerk segments / uploaded poly4d
    pieces, uav_trajectory.py:54-84 math) -> geometric position
    controller -> cmd_vel attitude command -> onboard cascade -> rigid-body
    physics

`FlyingFirmwareSim` flies the high-level commands; `CascadeFirmwareSim`
flies raw cmd_vel setpoints (the endpoint `runtime.swarm` serves).

Vehicle physics runs on the host CPU, in plain Python floats: these are
simulated vehicles beside the solver, not the solver, so nothing here is
a fallback from the card.  One endpoint steps its plant once a control
period, in its own serve thread when it runs in real time; a per-call
tensor program costs ~25 ms a period there (22,690 aten ops, measured
on a CPU), against the 15 ms period it must keep.  `_CascadePlant` is
the float twin of one period of `models.firmware.attitude_plant_step`
(the cascade mixer, the optional motor lag, RK4 substeps of the
quadrotor dynamics), with its constants read once per endpoint;
tests/test_torch_native.py holds it against the port's
`attitude_plant_step` in float64 and the JAX package's plant.
"""

from __future__ import annotations

import math
import time

import numpy as np

from crazyflie_nmpc_tpu_torch.models.firmware import AttitudeGains, _nonzero
from crazyflie_nmpc_tpu_torch.models.quadrotor import (W_MAX_KRPM,
                                                       QuadrotorParams)
from crazyflie_nmpc_tpu_torch.native.firmware_sim import FirmwareSim

GRAVITY = 9.8066
# thrust map constants (solver.outputs, acados_mpc.cpp:421-425)
_PWM_SCALE = 0.2685
_PWM_OFFSET = 4070.3
_DEG = math.pi / 180.0


def _quat_to_euler_np(q):
    """numpy twin of models.rotations.quat_to_euler (same algebra as the
    reference's quatern2euler, acados_mpc.cpp:384-404)."""
    qw, qx, qy, qz = q
    r11 = 2 * (qw * qw + qx * qx) - 1
    r21 = 2 * (qx * qy - qw * qz)
    r31 = 2 * (qx * qz + qw * qy)
    r32 = 2 * (qy * qz - qw * qx)
    r33 = 2 * (qw * qw + qz * qz) - 1
    return np.array([math.atan2(r32, r33),
                     -math.asin(min(max(r31, -1.0), 1.0)),
                     math.atan2(r21, r11)])


def _rotmat_body_to_earth_np(q):
    """numpy twin of models.rotations.rotmat_body_to_earth."""
    qw, qx, qy, qz = q
    s = np.array([
        [2 * (qw * qw + qx * qx) - 1, 2 * (qx * qy + qw * qz),
         2 * (qx * qz - qw * qy)],
        [2 * (qx * qy - qw * qz), 2 * (qw * qw + qy * qy) - 1,
         2 * (qy * qz + qw * qx)],
        [2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx),
         2 * (qw * qw + qz * qz) - 1]])
    return s.T


class _CascadePlant:
    """One control period of the onboard cascade plant on Python floats:
    the twin of `models.firmware.attitude_plant_step(params, x, cmd, dt,
    substeps, gains, motor)` for one vehicle, term by term (mixer, motor
    lag, RK4 of `models.quadrotor.dynamics`).  The parameters and gains
    are read once, here; a gain given as a tensor is read as its value
    (and a tensor `tau_m` selects the lag branch, as `_nonzero` does)."""

    def __init__(self, params: QuadrotorParams, gains: AttitudeGains,
                 dt: float, substeps: int):
        self.p = tuple(float(getattr(params, k)) for k in (
            "g0", "mq", "Ixx", "Iyy", "Izz", "Cd", "Ct", "l"))
        self.kp_att = float(gains.kp_att)
        self.kp_rate = float(gains.kp_rate)
        self.kd_rate = float(gains.kd_rate)
        self.substeps = int(substeps)
        self.sub_dt = float(dt) / self.substeps
        self.with_lag = _nonzero(gains.tau_m)
        tau = float(gains.tau_m)
        self.lag = (0.0 if tau == 0.0 else math.exp(-self.sub_dt / tau))
        self.hover = math.sqrt(params.mq * params.g0 / (4.0 * params.Ct))

    def init_motor(self, x):
        """`init_motor_state`: (hover speeds, the current body rates)."""
        return [self.hover] * 4, [float(v) for v in x[10:13]]

    def _f(self, x, w):
        """models.quadrotor.dynamics on floats."""
        g0, mq, Ixx, Iyy, Izz, Cd, Ct, l = self.p
        q1, q2, q3, q4 = x[3], x[4], x[5], x[6]
        vbx, vby, vbz = x[7], x[8], x[9]
        wx, wy, wz = x[10], x[11], x[12]
        s1, s2, s3, s4 = w[0] ** 2, w[1] ** 2, w[2] ** 2, w[3] ** 2
        dxq = (vbx * (2 * q1**2 + 2 * q2**2 - 1)
               - vby * (2 * q1 * q4 - 2 * q2 * q3)
               + vbz * (2 * q1 * q3 + 2 * q2 * q4))
        dyq = (vby * (2 * q1**2 + 2 * q3**2 - 1)
               + vbx * (2 * q1 * q4 + 2 * q2 * q3)
               - vbz * (2 * q1 * q2 - 2 * q3 * q4))
        dzq = (vbz * (2 * q1**2 + 2 * q4**2 - 1)
               - vbx * (2 * q1 * q3 - 2 * q2 * q4)
               + vby * (2 * q1 * q2 + 2 * q3 * q4))
        dq1 = -(q2 * wx) / 2 - (q3 * wy) / 2 - (q4 * wz) / 2
        dq2 = (q1 * wx) / 2 - (q4 * wy) / 2 + (q3 * wz) / 2
        dq3 = (q4 * wx) / 2 + (q1 * wy) / 2 - (q2 * wz) / 2
        dq4 = (q2 * wy) / 2 - (q3 * wx) / 2 + (q1 * wz) / 2
        thrust_acc = (Ct * (s1 + s2 + s3 + s4)) / mq
        dvbx = vby * wz - vbz * wy + g0 * (2 * q1 * q3 - 2 * q2 * q4)
        dvby = vbz * wx - vbx * wz - g0 * (2 * q1 * q2 + 2 * q3 * q4)
        dvbz = (vbx * wy - vby * wx
                - g0 * (2 * q1**2 + 2 * q4**2 - 1) + thrust_acc)
        dwx = -(Ct * l * (s1 + s2 - s3 - s4)
                - Iyy * wy * wz + Izz * wy * wz) / Ixx
        dwy = -(Ct * l * (s1 - s2 - s3 + s4)
                + Ixx * wx * wz - Izz * wx * wz) / Iyy
        dwz = -(Cd * (s1 - s2 + s3 - s4)
                - Ixx * wx * wy + Iyy * wx * wy) / Izz
        return (dxq, dyq, dzq, dq1, dq2, dq3, dq4, dvbx, dvby, dvbz, dwx,
                dwy, dwz)

    def _mix(self, x, cmd, omega_dot):
        """models.firmware.mix_cmd_vel on floats."""
        g0, mq, Ixx, Iyy, Izz, Cd, Ct, l = self.p
        qw, qx, qy, qz = x[3], x[4], x[5], x[6]
        r31 = 2 * (qx * qz + qw * qy)
        r32 = 2 * (qy * qz - qw * qx)
        r33 = 2 * (qw * qw + qz * qz) - 1
        alpha = -math.atan2(r32, r33)
        beta = math.asin(min(max(r31, -1.0), 1.0))
        rate_x = self.kp_att * (cmd[0] * _DEG - alpha)
        rate_y = self.kp_att * (-(cmd[1] * _DEG) - beta)
        rate_z = cmd[2] * _DEG
        wdot_x = (self.kp_rate * (rate_x - x[10])
                  - self.kd_rate * omega_dot[0])
        wdot_y = (self.kp_rate * (rate_y - x[11])
                  - self.kd_rate * omega_dot[1])
        wdot_z = (self.kp_rate * (rate_z - x[12])
                  - self.kd_rate * omega_dot[2])
        Ctl = Ct * l
        mx = -Ixx * wdot_x / Ctl
        my = -Iyy * wdot_y / Ctl
        mz = -Izz * wdot_z / Cd
        base = (cmd[3] * _PWM_SCALE + _PWM_OFFSET) / 1000.0
        mt = 4.0 * base * base
        s = ((mt + mx + my + mz) / 4.0, (mt + mx - my - mz) / 4.0,
             (mt - mx - my + mz) / 4.0, (mt - mx + my - mz) / 4.0)
        return [min(max(math.sqrt(max(v, 0.0)), 0.0), W_MAX_KRPM)
                for v in s]

    def step(self, x, cmd, motor):
        """(x (13,), cmd (4,), motor) -> (x_next, last applied rotor
        speeds, motor'), each a list of floats."""
        x = [float(v) for v in x]
        cmd = [float(v) for v in cmd]
        w_act, omega_prev = motor
        h = self.sub_dt
        u_eff = w_act
        for _ in range(self.substeps):
            omega_dot = [(x[10 + i] - omega_prev[i]) / h for i in range(3)]
            u_cmd = self._mix(x, cmd, omega_dot)
            if self.with_lag:
                w_next = [u + (w - u) * self.lag
                          for u, w in zip(u_cmd, w_act)]
                u_eff = [min(max(0.5 * (w + n), 0.0), W_MAX_KRPM)
                         for w, n in zip(w_act, w_next)]
            else:
                w_next = u_eff = u_cmd
            k1 = self._f(x, u_eff)
            k2 = self._f([a + 0.5 * h * b for a, b in zip(x, k1)], u_eff)
            k3 = self._f([a + 0.5 * h * b for a, b in zip(x, k2)], u_eff)
            k4 = self._f([a + h * b for a, b in zip(x, k3)], u_eff)
            x_next = [a + (h / 6.0) * (b + 2.0 * c + 2.0 * d + e)
                      for a, b, c, d, e in zip(x, k1, k2, k3, k4)]
            w_act, omega_prev = w_next, x[10:13]
            x = x_next
        return x, list(u_eff), (list(w_act), list(omega_prev))


class _MinJerk:
    """Min-jerk point-to-point segment (quintic), per axis + yaw."""

    def __init__(self, p0, p1, yaw0, yaw1, duration):
        self.p0 = np.asarray(p0, np.float64)
        self.d = np.asarray(p1, np.float64) - self.p0
        self.yaw0 = float(yaw0)
        self.dyaw = float(yaw1) - self.yaw0
        self.T = max(float(duration), 1e-3)

    def __call__(self, t):
        s = min(max(t / self.T, 0.0), 1.0)
        b = 10 * s**3 - 15 * s**4 + 6 * s**5
        db = (30 * s**2 - 60 * s**3 + 30 * s**4) / self.T
        ddb = (60 * s - 180 * s**2 + 120 * s**3) / self.T**2
        return dict(pos=self.p0 + self.d * b, vel=self.d * db,
                    acc=self.d * ddb,
                    yaw=self.yaw0 + self.dyaw * b,
                    dyaw=self.dyaw * db)

    @property
    def duration(self):
        return self.T


class _Poly4D:
    """Uploaded piecewise polynomial, evaluated with the time-warp
    semantics of the firmware's timescale (f(t/ts): velocities scale by
    1/ts, accelerations by 1/ts^2)."""

    def __init__(self, durations, coeffs, shift, timescale, reversed_):
        self.durations = np.asarray(durations, np.float64)
        self.coeffs = np.asarray(coeffs, np.float64).copy()
        if reversed_:
            # time-reverse each piece about its duration and flip order
            self.coeffs = self.coeffs[::-1]
            self.durations = self.durations[::-1]
            rev = []
            for dur, c in zip(self.durations, self.coeffs):
                rev.append(np.stack([_shift_poly(c[a][::-1].copy(), dur)
                                     for a in range(4)]))
            self.coeffs = np.stack(rev)
        self.coeffs[:, 0, 0] += shift[0]
        self.coeffs[:, 1, 0] += shift[1]
        self.coeffs[:, 2, 0] += shift[2]
        self.ts = max(float(timescale), 1e-3)
        self.starts = np.concatenate([[0.0], np.cumsum(self.durations)[:-1]])
        self.total = float(self.durations.sum())

    def __call__(self, t):
        tau = min(max(t / self.ts, 0.0), self.total - 1e-9)
        i = int(np.clip(np.searchsorted(self.starts, tau, side="right") - 1,
                        0, len(self.durations) - 1))
        tt = tau - self.starts[i]
        c0 = self.coeffs[i]
        c1 = _polyder_np(c0)
        c2 = _polyder_np(c1)
        f0 = _polyval_np(c0, tt)
        f1 = _polyval_np(c1, tt) / self.ts
        f2 = _polyval_np(c2, tt) / self.ts**2
        return dict(pos=f0[:3], vel=f1[:3], acc=f2[:3],
                    yaw=f0[3], dyaw=f1[3])

    @property
    def duration(self):
        return self.total * self.ts


def _polyval_np(c, t):
    r = np.zeros(c.shape[0]) + c[:, -1]
    for i in range(c.shape[1] - 2, -1, -1):
        r = r * t + c[:, i]
    return r


def _polyder_np(c):
    return c[:, 1:] * np.arange(1, c.shape[1])


def _shift_poly(c_desc, dur):
    """Coefficients of p(dur - t) given p's lowest-first coeffs reversed
    (c_desc is highest-first); returns lowest-first."""
    # p(dur - t): expand via binomial; small (degree 7), do it numerically
    n = len(c_desc)
    c = c_desc[::-1]             # lowest-first original
    out = np.zeros(n)
    for k in range(n):           # term c[k] (dur - t)^k
        for j in range(k + 1):
            out[j] += c[k] * math.comb(k, j) * dur**(k - j) * (-1.0)**j
    return out


class FlyingFirmwareSim(FirmwareSim):
    """FirmwareSim + plant + high-level-commander executor.

    The vehicle sits on the ground (motors off) until a takeoff command;
    thereafter every HL command is flown through the position controller
    and the onboard attitude cascade (`_CascadePlant`).  Time advances
    with `poll(dt_ms)` (tests fast-forward by polling manually);
    `serve()` runs real time like the base class.  `port=0` binds a port
    the OS picks (`self.port`).  `plant_s` / `plant_periods` sum the host
    time of the plant's periods.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 x0=(0.0, 0.0, 0.03), plant_dt_ms: int = 15,
                 substeps: int = 10, gains=None,
                 kp_pos=(6.0, 6.0, 8.0), kv_pos=(4.0, 4.0, 5.0),
                 kp_yaw: float = 4.0):
        super().__init__(port, host, state_provider=self._log_value)
        self.quad_params = QuadrotorParams()
        self.gains = gains or AttitudeGains()
        self.kp_pos = np.asarray(kp_pos, np.float64)
        self.kv_pos = np.asarray(kv_pos, np.float64)
        self.kp_yaw = float(kp_yaw)
        self.plant_dt = plant_dt_ms / 1000.0
        self._plant_dt_ms = plant_dt_ms
        self._accum_ms = 0

        x = np.zeros(13)
        x[0:3] = x0
        x[3] = 1.0
        self.x = x                      # rigid-body state, numpy f64
        self.flying = False
        self.segment = None             # active planner segment
        self.seg_t0_ms = 0
        self.seg_is_landing = False
        self.flown = []                 # (t_s, x(13)) history while flying
        self._cmd_idx = 0
        # HL-commander group membership (the SetGroupMask service,
        # crazyflie_server.cpp:911-916): group 0 addresses everyone
        self.group_mask = 0

        # the plant's constants, read once for this endpoint
        self._plant = _CascadePlant(self.quad_params, self.gains,
                                    self.plant_dt, substeps)
        self._motor = self._plant.init_motor(x)
        self.plant_s = 0.0
        self.plant_periods = 0

    # ---- telemetry ------------------------------------------------------

    def _log_value(self, name: str) -> float:
        x = self.x
        if name.startswith("stateEstimate."):
            return float(x["xyz".index(name[-1])])
        if name.startswith("gyro."):
            return float(math.degrees(x[10 + "xyz".index(name[-1])]))
        if name.startswith("stabilizer."):
            eu = _quat_to_euler_np(x[3:7])
            return float(math.degrees(
                eu[["roll", "pitch", "yaw"].index(name.split(".")[1])]))
        if name.startswith("motor.m"):
            return float(self._motor[0][int(name[-1]) - 1])
        if name == "pm.vbat":
            return 3.9
        return 0.0

    # ---- planner --------------------------------------------------------

    def _consume_commands(self):
        cmds = self.hl_commands
        while self._cmd_idx < len(cmds):
            c = cmds[self._cmd_idx]
            self._cmd_idx += 1
            self._activate(c)

    def _activate(self, c):
        pos = self.x[0:3].copy()
        yaw = self._yaw()
        name = c["cmd"]
        if name == "set_group_mask":
            self.group_mask = int(c["group"])
            return
        # group filter (firmware semantics): group 0 = everyone; a
        # nonzero group executes only if this vehicle is a member
        g = int(c.get("group", 0))
        if g != 0 and not (g & self.group_mask):
            return
        if name == "takeoff":
            tgt = np.array([pos[0], pos[1], c["height"]])
            tyaw = yaw if c.get("use_current_yaw", True) else c.get("yaw",
                                                                    yaw)
            self.segment = _MinJerk(pos, tgt, yaw, tyaw, c["duration"])
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
            self.flying = True
        elif name == "land":
            tgt = np.array([pos[0], pos[1], max(c["height"], 0.03)])
            self.segment = _MinJerk(pos, tgt, yaw, yaw, c["duration"])
            self.seg_is_landing = True
            self.seg_t0_ms = self.time_ms
        elif name == "go_to" and self.flying:
            goal = np.array([c["x"], c["y"], c["z"]])
            if c.get("relative"):
                goal = pos + goal
            self.segment = _MinJerk(pos, goal, yaw, c["yaw"], c["duration"])
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
        elif name == "start_trajectory" and self.flying:
            tid = c["traj_id"]
            if tid not in self.trajectories:
                return
            off, n_pieces = self.trajectories[tid]
            from crazyflie_nmpc_tpu_torch.utils.trajectories import (
                decode_poly4d)
            durations, coeffs = decode_poly4d(
                bytes(self.trajectory_mem[off:off + 132 * n_pieces]),
                n_pieces)
            shift = (pos - np.array([coeffs[0, 0, 0], coeffs[0, 1, 0],
                                     coeffs[0, 2, 0]])
                     if c.get("relative") else np.zeros(3))
            self.segment = _Poly4D(durations, coeffs, shift,
                                   c.get("timescale", 1.0),
                                   c.get("reversed", False))
            self.seg_is_landing = False
            self.seg_t0_ms = self.time_ms
        elif name == "stop":
            self.segment = None
            self.flying = False

    def _yaw(self) -> float:
        return -float(_quat_to_euler_np(self.x[3:7])[2])  # body-axis yaw

    # ---- executor -------------------------------------------------------

    def poll(self, dt_ms: int = 1):
        super().poll(dt_ms)
        self._consume_commands()
        self._accum_ms += dt_ms
        while self._accum_ms >= self._plant_dt_ms:
            self._accum_ms -= self._plant_dt_ms
            self._physics_tick()

    def _physics_tick(self):
        if not self.flying:
            return
        t = (self.time_ms - self.seg_t0_ms) / 1000.0
        seg = self.segment
        if seg is None:
            return
        ref = seg(t)
        if t > seg.duration and self.seg_is_landing:
            # touchdown: motors off, firmware-style
            self.flying = False
            self.segment = None
            self.x[2] = min(self.x[2], 0.04)
            self.x[7:13] = 0.0
            return
        cmd = self._position_controller(ref)
        self.x = self._plant_period(cmd)
        self.flown.append((self.time_ms / 1000.0, self.x.copy()))

    def _plant_period(self, cmd) -> np.ndarray:
        """One plant period under the held cmd_vel `cmd`: the next
        state (the motor state is kept), its host time summed."""
        t0 = time.perf_counter()
        x_next, _, self._motor = self._plant.step(self.x, cmd, self._motor)
        self.plant_s += time.perf_counter() - t0
        self.plant_periods += 1
        return np.asarray(x_next, np.float64)

    def _position_controller(self, ref):
        """Geometric (Mellinger-style) position loop -> cmd_vel.

        acc_cmd = acc_ref + Kp e_p + Kv e_v + g zhat; desired attitude
        from the thrust axis + yaw (the uav_trajectory.py:70-84 frame
        construction); thrust = m acc_cmd . z_body through the
        krpm2pwm map the cascade inverts (solver.outputs)."""
        x = self.x
        R = _rotmat_body_to_earth_np(x[3:7])
        vel_world = R @ x[7:10]

        acc_cmd = (ref["acc"] + self.kp_pos * (ref["pos"] - x[0:3])
                   + self.kv_pos * (ref["vel"] - vel_world)
                   + np.array([0.0, 0.0, GRAVITY]))
        nrm = np.linalg.norm(acc_cmd)
        z_body_des = acc_cmd / max(nrm, 1e-6)
        x_world = np.array([math.cos(ref["yaw"]), math.sin(ref["yaw"]), 0.0])
        y_body = np.cross(z_body_des, x_world)
        y_body /= max(np.linalg.norm(y_body), 1e-9)
        x_body = np.cross(y_body, z_body_des)
        Rd = np.stack([x_body, y_body, z_body_des], axis=-1)
        qw = 0.5 * math.sqrt(max(1.0 + Rd[0, 0] + Rd[1, 1] + Rd[2, 2],
                                 1e-12))
        qd = np.array([qw, (Rd[2, 1] - Rd[1, 2]) / (4 * qw),
                       (Rd[0, 2] - Rd[2, 0]) / (4 * qw),
                       (Rd[1, 0] - Rd[0, 1]) / (4 * qw)])
        eu_d = _quat_to_euler_np(qd)
        alpha_des, beta_des = -eu_d[0], -eu_d[1]

        # thrust along the CURRENT body z (geometric-controller projection)
        f_acc = max(float(acc_cmd @ R[:, 2]), 0.5)
        w_cmd = math.sqrt(self.quad_params.mq * f_acc
                          / (4.0 * self.quad_params.Ct))
        pwm = (w_cmd * 1000.0 - _PWM_OFFSET) / _PWM_SCALE

        yaw_err = ref["yaw"] - self._yaw()
        yaw_err = (yaw_err + math.pi) % (2 * math.pi) - math.pi
        yawrate = math.degrees(self.kp_yaw * yaw_err + ref["dyaw"])

        return np.array([math.degrees(alpha_des), -math.degrees(beta_des),
                         yawrate, np.clip(pwm, 0.0, 60000.0)])


class CascadeFirmwareSim(FlyingFirmwareSim):
    """FirmwareSim + cascade plant flown by raw cmd_vel setpoints.

    The firmware's LOW-LEVEL mode: no onboard planner — each received
    attitude setpoint (roll/pitch deg, yaw rate deg/s, thrust PWM;
    the reference's cmd_vel contract, acados_mpc.cpp:644-670) is held
    and tracked by the onboard attitude/rate cascade
    (`_CascadePlant`) driving rigid-body physics.
    This is the vehicle endpoint `runtime.swarm` fans a batched NMPC
    solve out to: what a real Crazyflie does when the reference server
    forwards /crazyflie/cmd_vel over the radio
    (crazyflie_server.cpp:155,1108-1131 per-vehicle loops).

    Arming follows the firmware's thrust-lock discipline: the vehicle
    sits on the ground, motors off, until a setpoint with thrust above
    `arm_thrust_pwm` arrives (the unlock-after-zero sequence is the
    link server's job; this is the vehicle-side gate).
    """

    ARM_THRUST_PWM = 1000.0

    def _consume_commands(self):
        # low-level mode: the HL planner is inert; commands are recorded
        # (base-class behavior) but never flown
        pass

    def _physics_tick(self):
        sp = self.last_setpoint
        if sp is None:
            return
        if not self.flying:
            if sp[3] < self.ARM_THRUST_PWM:
                return
            self.flying = True
        x_next = self._plant_period(sp)
        if x_next[2] <= 0.0:           # ground: no tunneling below z=0
            x_next[2] = 0.0
            x_next[9] = max(x_next[9], 0.0)
        self.x = x_next
        self.flown.append((self.time_ms / 1000.0, self.x.copy()))


def plant_timing(periods: int = 20) -> dict:
    """Host ms a 15 ms period (10 substeps, one vehicle, default gains,
    mean of `periods`) of the endpoint's float twin and of the port's
    tensor plant `models.firmware.attitude_plant_step` (float32 on the
    CPU, under `torch.inference_mode`), from a tilted hover under a
    held setpoint.  `python -c "from crazyflie_nmpc_tpu_torch.native.
    hl_executor import plant_timing; print(plant_timing())"`."""
    import torch

    from crazyflie_nmpc_tpu_torch.models.firmware import attitude_plant_step

    params, gains = QuadrotorParams(), AttitudeGains()
    x = np.zeros(13)
    x[2], x[3], x[4] = 0.5, math.cos(0.05), math.sin(0.05)
    cmd = np.array([2.0, -1.0, 10.0, 42000.0])
    plant = _CascadePlant(params, gains, 0.015, 10)
    motor = plant.init_motor(x)
    t0 = time.perf_counter()
    xs = x
    for _ in range(periods):
        xs, _, motor = plant.step(xs, cmd, motor)
    twin = (time.perf_counter() - t0) / periods
    xt = torch.as_tensor(x, dtype=torch.float32)
    ct = torch.as_tensor(cmd, dtype=torch.float32)
    with torch.inference_mode():
        attitude_plant_step(params, xt, ct, 0.015, gains=gains)
        t0 = time.perf_counter()
        for _ in range(periods):
            xt = attitude_plant_step(params, xt, ct, 0.015, gains=gains)[0]
        tensor = (time.perf_counter() - t0) / periods
    return dict(twin_ms=1e3 * twin, tensor_ms=1e3 * tensor)
