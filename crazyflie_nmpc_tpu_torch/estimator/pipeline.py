"""Delay-compensating state estimator: sensor fusion + forward prediction
(PyTorch counterpart of `estimator/pipeline.py`).

The functional form of the reference's 66.6 Hz estimator node
(acados_estimator.cpp:521-634 `predictor()`):

  1. position          <- motion capture
  2. attitude          <- onboard stabilizer Euler angles, converted via
                          euler2quatern with qw >= 0
  3. world velocity    <- IIR low-pass differentiation of mocap position
  4. body velocity     <- R_earth->body(q) * v_world
  5. body rates        <- onboard gyro
  6. delay prediction  <- one RK4 integration of length `delay` under the
                          last applied rotor command (:573-593)

Steps 1-5 are `fuse()`, step 6 is `predict()`; `estimate()` chains them.
Pure functions over an explicit EstimatorState; they run where their
inputs are.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crazyflie_nmpc_tpu_torch.estimator.lpf import (
    VelocityLPFState,
    init_lpf,
    lpf_step,
)
from crazyflie_nmpc_tpu_torch.models import rotations
from crazyflie_nmpc_tpu_torch.models.quadrotor import (
    NU,
    QuadrotorParams,
    dynamics,
)
from crazyflie_nmpc_tpu_torch.ops.integrators import integrate


@dataclasses.dataclass(frozen=True)
class EstimatorState:
    """Carried estimator state across ticks."""

    lpf: VelocityLPFState
    last_u: Any   # (nu,) last applied rotor command [kRPM] for prediction


def init_estimator(params: QuadrotorParams,
                   p0: torch.Tensor) -> EstimatorState:
    """Filter primed at p0; last command the hover speed (p0's device and
    dtype)."""
    last_u = torch.full((NU,), params.hover_speed(), dtype=torch.float64,
                        device=p0.device).to(p0.dtype)
    return EstimatorState(lpf=init_lpf(p0), last_u=last_u)


def fuse(state: EstimatorState, mocap_pos: torch.Tensor,
         euler_rpy: torch.Tensor, gyro: torch.Tensor, dt):
    """Assemble the 13-state vector from raw sensor channels.

    Args:
      mocap_pos: (..., 3) world position [m].
      euler_rpy: (..., 3) stabilizer roll/pitch/yaw [rad].
      gyro: (..., 3) body rates [rad/s].
    Returns (new_state, x (..., 13)).
    """
    q = rotations.euler_to_quat(euler_rpy)
    new_lpf, v_world = lpf_step(state.lpf, mocap_pos, dt)
    v_body = rotations.rotate_earth_to_body(q, v_world)
    x = torch.cat([mocap_pos, q, v_body, gyro], dim=-1)
    return EstimatorState(lpf=new_lpf, last_u=state.last_u), x


def predict(params: QuadrotorParams, x: torch.Tensor, u_last: torch.Tensor,
            delay, sim_steps: int = 1) -> torch.Tensor:
    """Propagate the fused state forward by the round-trip delay under the
    last applied control (acados_estimator.cpp:573-593)."""
    return integrate(dynamics, params, x, u_last, delay, sim_steps)


def estimate(params: QuadrotorParams, state: EstimatorState,
             mocap_pos, euler_rpy, gyro, dt, delay, sim_steps: int = 1):
    """Full estimator tick: fuse + delay-predict.

    Returns (new_state, x_hat (..., 13)), x_hat approximating the state at
    t + delay.
    """
    state, x = fuse(state, mocap_pos, euler_rpy, gyro, dt)
    x_hat = predict(params, x, state.last_u, delay, sim_steps)
    return state, x_hat


def notify_command(state: EstimatorState, u: torch.Tensor) -> EstimatorState:
    """Record the rotor command most recently sent to the vehicle (the
    /crazyflie/acados_motvel feedback loop, acados_estimator.cpp:245-258)."""
    return EstimatorState(lpf=state.lpf, last_u=u)
