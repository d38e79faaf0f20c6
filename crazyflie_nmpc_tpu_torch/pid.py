"""PID waypoint controller: the reference's non-NMPC fallback path
(PyTorch counterpart of `pid.py`).

Functional re-design of crazyflie_controller/src/pid.hpp:47-70 (PID with
clamped integrator and clamped output) and src/controller.cpp:135-213 (the
4-axis waypoint controller with its Idle/TakingOff/Automatic/Landing state
machine at 50 Hz).  Default gains are the reference's config/crazyflie2.yaml.

The error convention follows the reference: the goal pose is expressed in
the *body* frame (tf transform into the drone frame, controller.cpp:174-193)
and each PID drives value 0 toward that body-frame target coordinate.
Outputs are the cmd_vel contract (pitch/roll tilt commands, thrust PWM, yaw
rate).

Every quantity is a tensor on the state's device, the state machine's
`mode` too (a 0-d int32 tensor), so a tick never reads back from the card;
the mode switches are `torch.where` selections, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import device_tensor, resolve_device
from crazyflie_nmpc_tpu_torch.models import rotations

IDLE, AUTOMATIC, TAKING_OFF, LANDING = 0, 1, 2, 3

# config/crazyflie2.yaml, per axis (x, y, z, yaw)
DEFAULT_GAINS = dict(
    kp=(40.0, -40.0, 5000.0, -200.0),
    kd=(20.0, -20.0, 6000.0, -20.0),
    ki=(2.0, -2.0, 3500.0, 0.0),
    min_output=(-10.0, -10.0, 10000.0, -200.0),
    max_output=(10.0, 10.0, 60000.0, 200.0),
    integrator_min=(-0.1, -0.1, -1000.0, 0.0),
    integrator_max=(0.1, 0.1, 1000.0, 0.0),
)


@dataclasses.dataclass(frozen=True)
class PIDGains:
    """Per-axis gains/limits (pid.hpp ctor args).  Tensors of shape (4,)
    for the (x, y, z, yaw) axes; defaults = config/crazyflie2.yaml."""

    kp: Any
    kd: Any
    ki: Any
    min_output: Any
    max_output: Any
    integrator_min: Any
    integrator_max: Any


def default_gains(dtype=torch.float32, device=None) -> PIDGains:
    """The reference's gains, filled on `device` (None: the card)."""
    dev = resolve_device(device)
    return PIDGains(**{k: device_tensor(v, dtype, dev)
                       for k, v in DEFAULT_GAINS.items()})


@dataclasses.dataclass(frozen=True)
class PIDState:
    """Carried controller state (integrators, previous errors, mode)."""

    integral: Any        # (4,)
    prev_error: Any      # (4,)
    mode: Any            # 0-d int32 state-machine mode
    thrust: Any          # takeoff thrust ramp value
    start_z: Any         # ground altitude captured at takeoff request


def init_pid(dtype=torch.float32, device=None) -> PIDState:
    dev = resolve_device(device)
    z4 = torch.zeros((4,), dtype=dtype, device=dev)
    return PIDState(integral=z4, prev_error=z4,
                    mode=torch.full((), IDLE, dtype=torch.int32, device=dev),
                    thrust=torch.zeros((), dtype=dtype, device=dev),
                    start_z=torch.zeros((), dtype=dtype, device=dev))


class PIDCommand(NamedTuple):
    pitch: Any      # linear.x
    roll: Any       # linear.y
    thrust: Any     # linear.z (PWM)
    yawrate: Any    # angular.z


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """v (a Python number or a tensor) as a 0-d tensor in like's dtype on
    like's device, filled there (no host copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def pid_update(gains: PIDGains, integral, prev_error, error, dt):
    """Vector PID update over the 4 axes (pid.hpp:47-70 semantics:
    trapezoid-free integral with clamping, derivative on error, clamped
    output).  dt is a number (seconds).  The clamps take tensor bounds,
    so an axis whose bounds are both 0 (the yaw integrator) clamps to
    0."""
    integral = torch.clamp(integral + error * dt,
                           gains.integrator_min, gains.integrator_max)
    d = ((error - prev_error) / max(dt, 1e-9) if dt > 0
         else torch.zeros_like(error))
    out = gains.kp * error + gains.kd * d + gains.ki * integral
    out = torch.clamp(out, gains.min_output, gains.max_output)
    return integral, error, out


def body_frame_goal(x: torch.Tensor, goal_pos: torch.Tensor, goal_yaw):
    """Goal position/yaw expressed in the drone body frame (the tf
    transformPose in controller.cpp:180-193)."""
    q = x[3:7]
    rel = goal_pos - x[0:3]
    rel_body = rotations.rotate_earth_to_body(q, rel)
    yaw_err = goal_yaw - rotations.quat_to_euler(q)[2]
    # wrap to [-pi, pi]
    yaw_err = torch.atan2(torch.sin(yaw_err), torch.cos(yaw_err))
    return rel_body, yaw_err


def takeoff(state: PIDState, current_z) -> PIDState:
    """Latch TakingOff mode (the takeoff service, controller.cpp:100-111)."""
    return dataclasses.replace(state,
                               mode=torch.full_like(state.mode, TAKING_OFF),
                               start_z=_scalar(current_z, state.thrust))


def land(state: PIDState) -> PIDState:
    return dataclasses.replace(state,
                               mode=torch.full_like(state.mode, LANDING))


def pid_step(gains: PIDGains, state: PIDState, x: torch.Tensor,
             goal_pos: torch.Tensor, goal_yaw, dt):
    """One 50 Hz controller tick.  Returns (new_state, PIDCommand).

    Mirrors controller.cpp:135-213: TakingOff ramps thrust 10000/s until
    z > start_z + 0.05 (or 50000), then seeds the Z integrator with
    thrust/ki and switches to Automatic; Landing drives the goal to
    start_z + 0.05 and idles on touchdown; Automatic runs the 4 PIDs on the
    body-frame goal error.
    """
    zero = torch.zeros((), dtype=state.thrust.dtype, device=x.device)
    rel_body, yaw_err = body_frame_goal(x, goal_pos, goal_yaw)
    z = x[2]

    # ---- Automatic / Landing shared control law
    goal_pos_landing = torch.cat([
        rel_body[:2], (rel_body[2] + (state.start_z + 0.05
                                      - goal_pos[2])).reshape(1)])
    is_landing = state.mode == LANDING
    err = torch.cat([
        torch.where(is_landing, goal_pos_landing, rel_body),
        torch.where(is_landing, zero, yaw_err).reshape(1),
    ])
    integral, prev_error, out = pid_update(
        gains, state.integral, state.prev_error, err, dt)

    # ---- TakingOff ramp
    new_thrust = state.thrust + 10000.0 * dt
    took_off = (z > state.start_z + 0.05) | (new_thrust > 50000.0)

    # ---- Landing touchdown -> Idle
    landed = is_landing & (z <= state.start_z + 0.05)

    mode = state.mode
    mode = torch.where((mode == TAKING_OFF) & took_off,
                       torch.full_like(mode, AUTOMATIC), mode)
    mode = torch.where(landed, torch.full_like(mode, IDLE), mode)

    in_auto = (mode == AUTOMATIC) | (mode == LANDING)
    in_ramp = mode == TAKING_OFF

    # takeoff->automatic transition seeds the Z integrator (thrust/ki) and
    # resets the others (controller.cpp:143-150)
    seed = (state.mode == TAKING_OFF) & took_off
    ki_z = gains.ki[2]
    seeded_z = state.thrust / torch.where(ki_z != 0, ki_z,
                                          torch.ones_like(ki_z))
    seeded_integral = torch.cat([zero.expand(2), seeded_z.reshape(1),
                                 zero.reshape(1)])
    integral = torch.where(seed, seeded_integral, integral)
    prev_error = torch.where(seed, torch.zeros_like(prev_error), prev_error)

    cmd = PIDCommand(
        pitch=torch.where(in_auto, out[0], zero),
        roll=torch.where(in_auto, out[1], zero),
        thrust=torch.where(in_auto, out[2],
                           torch.where(in_ramp, new_thrust, zero)),
        yawrate=torch.where(in_auto, out[3], zero),
    )

    new_state = PIDState(
        integral=torch.where(in_auto, integral, state.integral),
        prev_error=torch.where(in_auto, prev_error, state.prev_error),
        mode=mode,
        thrust=torch.where(in_ramp & ~took_off, new_thrust, zero),
        start_z=state.start_z,
    )
    return new_state, cmd
