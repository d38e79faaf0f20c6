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

from crazyflie_nmpc_tpu_torch.device import device_tensor, resolve_device

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
    """Continuous-time dynamics xdot = f(x, u); x (..., 13), u (..., 4).

    Each state is taken as a (..., 1) column, never a 0-dim tensor: under
    `torch.func.jacfwd` a 0-dim tensor times a Python float gets a float64
    tangent, which would turn a float32 Jacobian into float64."""
    q1, q2, q3, q4 = (x[..., i:i + 1] for i in (QW, QX, QY, QZ))
    vbx, vby, vbz = (x[..., i:i + 1] for i in (VBX, VBY, VBZ))
    wx, wy, wz = (x[..., i:i + 1] for i in (WX, WY, WZ))
    w1, w2, w3, w4 = (u[..., i:i + 1] for i in range(4))

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

    return torch.cat(
        [dxq, dyq, dzq, dq1, dq2, dq3, dq4, dvbx, dvby, dvbz, dwx, dwy, dwz],
        dim=-1)


def hover_state(params: QuadrotorParams, pos=(0.0, 0.0, 0.0),
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Equilibrium state: identity attitude, zero velocity, at `pos`.
    Made on the device without a host copy (`device_tensor`), so it does
    not wait for the card."""
    return device_tensor(tuple(pos[:3]) + (1.0,) + (0.0,) * (NX - 4), dtype,
                         resolve_device(device))


def hover_control(params: QuadrotorParams, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Equilibrium control: all four rotors at hover speed [kRPM]."""
    return torch.full((NU,), params.hover_speed(), dtype=dtype,
                      device=resolve_device(device))


def dynamics_jacobians(params: QuadrotorParams, x: torch.Tensor,
                       u: torch.Tensor):
    """Analytic Jacobians Jx = df/dx (..., 13, 13), Ju = df/du (..., 13, 4).

    Hand-derived from `dynamics` (the reference ODE, export_ode_model.py:
    85-97), entry for entry the JAX package's: the closed-form VDE of
    `ops.integrators.step_with_sensitivities_vde` propagates them.
    """
    q1, q2, q3, q4 = x[..., QW], x[..., QX], x[..., QY], x[..., QZ]
    vbx, vby, vbz = x[..., VBX], x[..., VBY], x[..., VBZ]
    wx, wy, wz = x[..., WX], x[..., WY], x[..., WZ]
    w1, w2, w3, w4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]

    g0, mq = params.g0, params.mq
    Ixx, Iyy, Izz = params.Ixx, params.Iyy, params.Izz
    Ct, Cd, l = params.Ct, params.Cd, params.l

    z = torch.zeros_like(q1)
    h = 0.5 * torch.ones_like(q1)

    def row(cols):
        """cols: {state index: (...) expression} -> (..., 13)."""
        return torch.stack([cols.get(i, z) for i in range(NX)], dim=-1)

    Jx = torch.stack([
        # dxq
        row({QW: 4 * q1 * vbx - 2 * q4 * vby + 2 * q3 * vbz,
             QX: 4 * q2 * vbx + 2 * q3 * vby + 2 * q4 * vbz,
             QY: 2 * q2 * vby + 2 * q1 * vbz,
             QZ: -2 * q1 * vby + 2 * q2 * vbz,
             VBX: 2 * q1 ** 2 + 2 * q2 ** 2 - 1,
             VBY: -(2 * q1 * q4 - 2 * q2 * q3),
             VBZ: 2 * q1 * q3 + 2 * q2 * q4}),
        # dyq
        row({QW: 4 * q1 * vby + 2 * q4 * vbx - 2 * q2 * vbz,
             QX: 2 * q3 * vbx - 2 * q1 * vbz,
             QY: 4 * q3 * vby + 2 * q2 * vbx + 2 * q4 * vbz,
             QZ: 2 * q1 * vbx + 2 * q3 * vbz,
             VBX: 2 * q1 * q4 + 2 * q2 * q3,
             VBY: 2 * q1 ** 2 + 2 * q3 ** 2 - 1,
             VBZ: -(2 * q1 * q2 - 2 * q3 * q4)}),
        # dzq
        row({QW: 4 * q1 * vbz - 2 * q3 * vbx + 2 * q2 * vby,
             QX: 2 * q4 * vbx + 2 * q1 * vby,
             QY: -2 * q1 * vbx + 2 * q4 * vby,
             QZ: 4 * q4 * vbz + 2 * q2 * vbx + 2 * q3 * vby,
             VBX: -(2 * q1 * q3 - 2 * q2 * q4),
             VBY: 2 * q1 * q2 + 2 * q3 * q4,
             VBZ: 2 * q1 ** 2 + 2 * q4 ** 2 - 1}),
        # dq1..dq4 (quaternion kinematics, linear in q and w)
        row({QX: -wx * h, QY: -wy * h, QZ: -wz * h,
             WX: -q2 * h, WY: -q3 * h, WZ: -q4 * h}),
        row({QW: wx * h, QY: wz * h, QZ: -wy * h,
             WX: q1 * h, WY: -q4 * h, WZ: q3 * h}),
        row({QW: wy * h, QX: -wz * h, QZ: wx * h,
             WX: q4 * h, WY: q1 * h, WZ: -q2 * h}),
        row({QW: wz * h, QX: wy * h, QY: -wx * h,
             WX: -q3 * h, WY: q2 * h, WZ: q1 * h}),
        # dvbx/dvby/dvbz (Coriolis + gravity tilt + thrust)
        row({QW: 2 * g0 * q3, QX: -2 * g0 * q4, QY: 2 * g0 * q1,
             QZ: -2 * g0 * q2,
             VBY: wz, VBZ: -wy, WY: -vbz, WZ: vby}),
        row({QW: -2 * g0 * q2, QX: -2 * g0 * q1, QY: -2 * g0 * q4,
             QZ: -2 * g0 * q3,
             VBX: -wz, VBZ: wx, WX: vbz, WZ: -vbx}),
        row({QW: -4 * g0 * q1, QZ: -4 * g0 * q4,
             VBX: wy, VBY: -wx, WX: -vby, WY: vbx}),
        # dwx/dwy/dwz (Euler rotational dynamics)
        row({WY: (Iyy - Izz) * wz / Ixx, WZ: (Iyy - Izz) * wy / Ixx}),
        row({WX: (Izz - Ixx) * wz / Iyy, WZ: (Izz - Ixx) * wx / Iyy}),
        row({WX: (Ixx - Iyy) * wy / Izz, WY: (Ixx - Iyy) * wx / Izz}),
    ], dim=-2)

    zu = torch.zeros_like(w1)
    zero_row = torch.stack([zu, zu, zu, zu], dim=-1)
    tcm = 2.0 * Ct / mq
    tlx = 2.0 * Ct * l / Ixx
    tly = 2.0 * Ct * l / Iyy
    tdz = 2.0 * Cd / Izz
    Ju = torch.stack([zero_row] * 9 + [
        torch.stack([tcm * w1, tcm * w2, tcm * w3, tcm * w4], dim=-1),
        torch.stack([-tlx * w1, -tlx * w2, tlx * w3, tlx * w4], dim=-1),
        torch.stack([-tly * w1, tly * w2, tly * w3, -tly * w4], dim=-1),
        torch.stack([-tdz * w1, tdz * w2, -tdz * w3, tdz * w4], dim=-1),
    ], dim=-2)
    return Jx, Ju
