"""Onboard attitude-loop plant: the cmd_vel actuation path in software
(PyTorch counterpart of `models/firmware.py`).

The reference NMPC does not drive rotors directly: it publishes a
`cmd_vel` attitude command (roll/pitch degrees, yaw rate deg/s, thrust
PWM, acados_mpc.cpp:644-670) that the radio forwards to the Crazyflie
firmware, whose onboard cascaded attitude/rate controller produces the
per-rotor commands.  This module models that inner loop:

    NMPC (rotor-level internal model) -> to_cmd_vel(u1, x4)
      -> [radio delay] -> attitude_plant_step (this module) -> physics

Cascade (firmware-style, continuous gains, run at the plant substep):
    attitude P:  rate_sp_xy = kp_att * (attitude_cmd - attitude)
    yaw rate:    rate_sp_z  = yawrate_cmd
    rate P:      omega_dot_sp = kp_rate * (rate_sp - omega)
    mixer:       exact torque allocation through the model's X-mixing
                 (dynamics' tau rows), s_i = w_i^2,
                   mx = -Ixx wdot_x / (Ct l), my = -Iyy wdot_y / (Ct l),
                   mz = -Izz wdot_z / Cd,  mt = 4 * pwm2krpm(thrust)^2
    limits:      s_i >= 0, w_i in [0, 22] kRPM (generate_c_code.py:133)

Every function works on the last axis (leading axes are batch axes) and
runs where its inputs are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crazyflie_nmpc_tpu_torch.models import rotations
from crazyflie_nmpc_tpu_torch.models.quadrotor import (
    NU,
    W_MAX_KRPM,
    QuadrotorParams,
    dynamics,
)
from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step


@dataclasses.dataclass(frozen=True)
class AttitudeGains:
    """Inner-loop gains [1/s].  Defaults give ~100 ms attitude / ~25 ms
    rate time constants, the regime of the stock firmware cascade.

      kd_rate [s]: rate-loop derivative term; the demanded angular
        acceleration becomes kp_rate*(rate_sp - omega) - kd_rate*omega_dot.
      tau_m [s]: first-order motor lag.  A Python 0.0 means instantaneous
        rotors; any tensor (even one holding 0.0) selects the lag branch,
        as any array does in the JAX package (`_nonzero`).
    """

    kp_att: Any = 10.0
    kp_rate: Any = 40.0
    kd_rate: Any = 0.0
    tau_m: Any = 0.0


def mix_cmd_vel(params: QuadrotorParams, gains: AttitudeGains,
                x: torch.Tensor, cmd: torch.Tensor,
                omega_dot=None) -> torch.Tensor:
    """One cascade evaluation: (state (..., 13), cmd_vel (..., 4)) -> rotor
    speeds (..., 4) [kRPM].

    cmd layout (the wire contract): cmd[0] = roll [deg], cmd[1] = pitch
    [deg], cmd[2] = yaw rate [deg/s], cmd[3] = thrust [PWM ticks].  The
    cascade tracks alpha_sp = +cmd[0], beta_sp = -cmd[1] against the
    body-axis feedback alpha = -phi_eu, beta = -theta_eu (the reference
    output path's sign conventions, acados_mpc.cpp:660-668).
    """
    from crazyflie_nmpc_tpu_torch.solver.outputs import pwm2krpm

    eu = rotations.quat_to_euler(x[..., 3:7])
    alpha, beta = -eu[..., 0], -eu[..., 1]
    wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]

    rate_sp_x = gains.kp_att * (rotations.deg2rad(cmd[..., 0]) - alpha)
    rate_sp_y = gains.kp_att * (-rotations.deg2rad(cmd[..., 1]) - beta)
    rate_sp_z = rotations.deg2rad(cmd[..., 2])

    dwx, dwy, dwz = ((0.0, 0.0, 0.0) if omega_dot is None
                     else (omega_dot[..., 0], omega_dot[..., 1],
                           omega_dot[..., 2]))
    wdot_x = gains.kp_rate * (rate_sp_x - wx) - gains.kd_rate * dwx
    wdot_y = gains.kp_rate * (rate_sp_y - wy) - gains.kd_rate * dwy
    wdot_z = gains.kp_rate * (rate_sp_z - wz) - gains.kd_rate * dwz

    Ctl = params.Ct * params.l
    mx = -params.Ixx * wdot_x / Ctl
    my = -params.Iyy * wdot_y / Ctl
    mz = -params.Izz * wdot_z / params.Cd
    base = pwm2krpm(cmd[..., 3])
    mt = 4.0 * base * base

    s = torch.stack([(mt + mx + my + mz) / 4.0,
                     (mt + mx - my - mz) / 4.0,
                     (mt - mx - my + mz) / 4.0,
                     (mt - mx + my - mz) / 4.0], dim=-1)
    w = torch.sqrt(torch.clamp(s, min=0.0))
    return torch.clamp(w, 0.0, W_MAX_KRPM)


def init_motor_state(params: QuadrotorParams, x: torch.Tensor,
                     u0: torch.Tensor | None = None):
    """Motor-lag plant state: (actual rotor speeds [kRPM], previous body
    rates), carried across control ticks by `attitude_plant_step`.  u0
    defaults to the hover speed."""
    if u0 is None:
        u0 = torch.full((NU,), params.hover_speed(), dtype=torch.float64,
                        device=x.device)
    u0 = torch.as_tensor(u0, device=x.device)
    return (u0.to(x.dtype).expand(x.shape[:-1] + (NU,)), x[..., 10:13])


def attitude_plant_step(params: QuadrotorParams, x: torch.Tensor,
                        cmd: torch.Tensor, dt, substeps: int = 10,
                        gains: AttitudeGains = AttitudeGains(),
                        motor=None):
    """Advance the attitude-loop plant one control period under a held
    cmd_vel command; the cascade re-evaluates every RK4 substep.

    motor: optional `init_motor_state` tuple (w_act, omega_prev).  With the
    lag branch (`_nonzero(gains.tau_m)`) the rotors respond first-order
    toward the mixer command (exact exponential update per substep) and
    the physics sees the midpoint of the segment; omega_prev supplies the
    rate-D term's angular-acceleration estimate.  None initializes both
    from (hover, current rates).

    Returns (x_next, last actual rotor speeds [kRPM], motor')."""
    sub_dt = dt / substeps
    if motor is None:
        motor = init_motor_state(params, x)

    with_lag = _nonzero(gains.tau_m)
    if with_lag:
        lag = _lag_factor(-sub_dt / gains.tau_m, x)

    xc, (w_act, omega_prev) = x, motor
    for _ in range(substeps):
        omega_dot = (xc[..., 10:13] - omega_prev) / sub_dt
        u_cmd = mix_cmd_vel(params, gains, xc, cmd, omega_dot=omega_dot)
        if with_lag:
            w_next = u_cmd + (w_act - u_cmd) * lag
            u_eff = torch.clamp(0.5 * (w_act + w_next), 0.0, W_MAX_KRPM)
        else:
            w_next = u_cmd
            u_eff = u_cmd
        x_next = rk4_step(dynamics, params, xc, u_eff, sub_dt)
        xc, w_act, omega_prev = x_next, w_next, xc[..., 10:13]
    return xc, u_eff, (w_act, omega_prev)


def _lag_factor(ratio, x: torch.Tensor) -> torch.Tensor:
    """exp(ratio) in x's dtype on x's device.  A Python number is filled
    there (a tensor of it would round to the default dtype, float32, and
    a copy from the host would wait for the card); a tensor keeps its
    own precision for the exponential, as in the JAX package."""
    if isinstance(ratio, torch.Tensor):
        return torch.exp(ratio).to(device=x.device, dtype=x.dtype)
    return torch.exp(torch.full((), ratio, dtype=x.dtype, device=x.device))


def _nonzero(v) -> bool:
    """Static check for the zero default: only a Python 0 counts as zero;
    a tensor, whatever it holds, does not (its value is never read)."""
    return not (isinstance(v, (int, float)) and v == 0.0)
