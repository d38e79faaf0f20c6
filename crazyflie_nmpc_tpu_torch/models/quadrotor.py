"""Quaternion quadrotor dynamics for the Crazyflie 2.1 (PyTorch).

Counterpart of `crazyflie_nmpc_tpu/models/quadrotor.py`: the same 13
states (position, unit quaternion, body velocity, body rates), the same 4
rotor-speed inputs in kRPM, the same constants and equations of motion
(the reference ODE, export_ode_model.py:85-97).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device

XQ, YQ, ZQ = 0, 1, 2
QW, QX, QY, QZ = 3, 4, 5, 6
VBX, VBY, VBZ = 7, 8, 9
WX, WY, WZ = 10, 11, 12

NX = 13  # number of states
NU = 4   # number of controls
NY = NX + NU   # stage reference dim
NYN = NX       # terminal reference dim

# Input bound used by the reference OCP (generate_c_code.py:59,133-134).
W_MAX_KRPM = 22.0
W_MIN_KRPM = 0.0


@dataclasses.dataclass(frozen=True)
class QuadrotorParams:
    """Physical parameters of the Crazyflie 2.1 (export_ode_model.py:33-42).

    Plain Python floats: the batched path tiles them across the lanes
    itself (`solver.rti_batched`).
    """

    g0: float = 9.8066      # [m/s^2] gravity
    mq: float = 33e-3       # [kg] total mass
    Ixx: float = 1.395e-5   # [kg m^2]
    Iyy: float = 1.395e-5   # [kg m^2]
    Izz: float = 2.173e-5   # [kg m^2]
    Cd: float = 7.9379e-6   # [N/kRPM^2] drag (yaw) coefficient
    Ct: float = 3.25e-4     # [N/kRPM^2] thrust coefficient
    l: float = 32.5e-3      # [m] arm length

    def hover_speed(self) -> float:
        """Steady-state propeller speed [kRPM]: sqrt(m g / 4 Ct)."""
        return math.sqrt((self.mq * self.g0) / (4.0 * self.Ct))


def dynamics(params: QuadrotorParams, x: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """Continuous-time dynamics xdot = f(x, u); x (..., 13), u (..., 4)."""
    q1, q2, q3, q4 = x[..., QW], x[..., QX], x[..., QY], x[..., QZ]
    vbx, vby, vbz = x[..., VBX], x[..., VBY], x[..., VBZ]
    wx, wy, wz = x[..., WX], x[..., WY], x[..., WZ]
    w1, w2, w3, w4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]

    g0, mq = params.g0, params.mq
    Ixx, Iyy, Izz = params.Ixx, params.Iyy, params.Izz
    Ct, Cd, l = params.Ct, params.Cd, params.l

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

    thrust_acc = (Ct * (w1**2 + w2**2 + w3**2 + w4**2)) / mq
    dvbx = vby * wz - vbz * wy + g0 * (2 * q1 * q3 - 2 * q2 * q4)
    dvby = vbz * wx - vbx * wz - g0 * (2 * q1 * q2 + 2 * q3 * q4)
    dvbz = (vbx * wy - vby * wx
            - g0 * (2 * q1**2 + 2 * q4**2 - 1) + thrust_acc)

    dwx = -(Ct * l * (w1**2 + w2**2 - w3**2 - w4**2)
            - Iyy * wy * wz + Izz * wy * wz) / Ixx
    dwy = -(Ct * l * (w1**2 - w2**2 - w3**2 + w4**2)
            + Ixx * wx * wz - Izz * wx * wz) / Iyy
    dwz = -(Cd * (w1**2 - w2**2 + w3**2 - w4**2)
            - Ixx * wx * wy + Iyy * wx * wy) / Izz

    return torch.stack(
        [dxq, dyq, dzq, dq1, dq2, dq3, dq4, dvbx, dvby, dvbz, dwx, dwy, dwz],
        dim=-1)


def hover_state(params: QuadrotorParams, pos=(0.0, 0.0, 0.0),
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Equilibrium state: identity attitude, zero velocity, at `pos`."""
    x = torch.zeros(NX, dtype=dtype, device=resolve_device(device))
    x[XQ], x[YQ], x[ZQ] = pos[0], pos[1], pos[2]
    x[QW] = 1.0
    return x


def hover_control(params: QuadrotorParams, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Equilibrium control: all four rotors at hover speed [kRPM]."""
    return torch.full((NU,), params.hover_speed(), dtype=dtype,
                      device=resolve_device(device))
