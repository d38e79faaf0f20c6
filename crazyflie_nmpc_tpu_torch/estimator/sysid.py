"""System-identification tooling, the measurements_vector workflow
(PyTorch counterpart of `estimator/sysid.py`).

`assemble_measurements` runs the estimator's fusion chain (without the
delay predictor, measurements_vector.cpp:332-395) over whole logged
arrays; the fitting helpers recover the physical constants from flight
logs (numpy, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.estimator.lpf import init_lpf, lpf_step
from crazyflie_nmpc_tpu_torch.models import rotations
from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams


def assemble_measurements(positions, eulers, gyros, dt):
    """Batch meas-vector assembly: logged streams -> (T, 13) state stream.

    Args:
      positions (T, 3) mocap [m]; eulers (T, 3) roll/pitch/yaw [rad];
      gyros (T, 3) body rates [rad/s], tensors (numpy arrays go to the
      CPU).  The filter runs sample by sample, the rest over all samples.
    """
    positions, eulers, gyros = (torch.as_tensor(a)
                                for a in (positions, eulers, gyros))
    quats = rotations.euler_to_quat(eulers)
    lpf = init_lpf(positions[0])
    v_world = []
    for p in positions:
        lpf, v = lpf_step(lpf, p, dt)
        v_world.append(v)
    v_body = rotations.rotate_earth_to_body(quats, torch.stack(v_world))
    return torch.cat([positions, quats, v_body, gyros], dim=1)


def fit_thrust_map(krpm, pwm):
    """Fit pwm = (krpm*1000 - b) / a by least squares.

    Recovers the reference's identified map (a=0.2685, b=4070.3,
    acados_mpc.cpp:421-425) from logged (motor kRPM, PWM) pairs.
    Returns (a, b).
    """
    krpm = _f64(krpm)
    pwm = _f64(pwm)
    A = np.stack([pwm, np.ones_like(pwm)], axis=1)
    a, b = np.linalg.lstsq(A, krpm * 1000.0, rcond=None)[0]
    return float(a), float(b)


def fit_thrust_coefficient(params: QuadrotorParams, hover_krpm):
    """Ct from observed steady hover speed: Ct = m g / (4 w_ss^2)."""
    w = float(np.mean(_f64(hover_krpm)))
    return float(params.mq * params.g0 / (4.0 * w * w))


def fit_drag_coefficient(params: QuadrotorParams, u_traj, wz_dot_traj,
                         wx=0.0, wy=0.0):
    """Cd from yaw-acceleration data: dwz = -Cd (w1^2-w2^2+w3^2-w4^2)/Izz
    (export_ode_model.py:97), least squares over logged samples."""
    u = _f64(u_traj)
    mix = u[:, 0] ** 2 - u[:, 1] ** 2 + u[:, 2] ** 2 - u[:, 3] ** 2
    dwz = _f64(wz_dot_traj)
    denom = float(np.dot(mix, mix))
    if denom < 1e-12:
        raise ValueError("no yaw-torque excitation in the data")
    return float(-np.dot(mix, dwz) * float(params.Izz) / denom)


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)
