"""Solver-output post-processing: the Crazyflie command contract (PyTorch
counterpart of `solver/outputs.py`).

Pure functions reproducing the reference NMPC node's output path
(acados_mpc.cpp:644-670): the delay-compensating pair (u1, x4) becomes the
`cmd_vel` attitude/thrust command (roll/pitch in degrees, yaw rate in
deg/s, thrust as PWM ticks).  They run where their inputs are.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.models import rotations
from crazyflie_nmpc_tpu_torch.models.quadrotor import WZ

# Thrust map identified for the CF2.1 (acados_mpc.cpp:421-425) and the
# firmware-side clamp applied by the radio server (crazyflie_server.cpp:352).
PWM_SCALE = 0.2685
PWM_OFFSET = 4070.3
PWM_MAX = 60000.0


def krpm2pwm(krpm):
    """Rotor speed [kRPM] -> motor PWM ticks (acados_mpc.cpp:421-425)."""
    return (krpm * 1000.0 - PWM_OFFSET) / PWM_SCALE


def pwm2krpm(pwm):
    """Inverse thrust map (used by system-identification tooling)."""
    return (pwm * PWM_SCALE + PWM_OFFSET) / 1000.0


class BodyTwist(NamedTuple):
    """The cmd_vel contract (README.md:104-110): degrees / PWM units."""

    pitch_deg: Any   # linear.x
    roll_deg: Any    # linear.y
    thrust_pwm: Any  # linear.z in [0, 60000]
    yawrate_deg: Any  # angular.z


def to_cmd_vel(u1: torch.Tensor, x4: torch.Tensor,
               clamp: bool = True) -> BodyTwist:
    """(u1, x4) -> attitude command, the reference's feedback policy
    (acados_mpc.cpp:644-670): pitch = +theta(x4) [deg], roll = -phi(x4)
    [deg], thrust = krpm2pwm(mean(u1)), yawrate = x4.wz [deg/s]; x4's
    quaternion is normalized first."""
    q = rotations.quat_normalize(x4[..., 3:7])
    eu = rotations.quat_to_euler(q)
    thrust = krpm2pwm(u1.mean(dim=-1))
    if clamp:
        thrust = torch.clamp(thrust, 0.0, PWM_MAX)
    return BodyTwist(pitch_deg=rotations.rad2deg(eu[..., 1]),
                     roll_deg=-rotations.rad2deg(eu[..., 0]),
                     thrust_pwm=thrust,
                     yawrate_deg=rotations.rad2deg(x4[..., WZ]))
