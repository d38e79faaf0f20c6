"""Reference-trajectory tooling: loaders, flatness evaluation, generators
(PyTorch counterpart of `utils/trajectories.py`).

Covers the reference's two trajectory formats:

  * 17-column whitespace text files, one row per 15 ms tick
    ([x(13); u(4)], loaded by readDataFromFile, acados_mpc.cpp:354-382);
  * 33-column polynomial CSVs (duration, x^0..7, y^0..7, z^0..7,
    yaw^0..7) evaluated through the differential-flatness map
    (uav_trajectory.py:54-95).

The flatness evaluation produces full 17-column (x, u) rows (quaternion
from the flat body frame, body-frame velocity, body rates, rotor speeds
from collective thrust), so any polynomial trajectory can feed the NMPC
Tracking policy.  The loaders and the poly4d codec are numpy (this
package's own copy); the evaluation and the generators are PyTorch,
vectorized over the sample times.  The generators make their table on
the card unless given a device.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.models.quadrotor import NU, NX, QuadrotorParams

TRAJ_COLS = NX + NU  # 17


def load_traj_txt(path: str) -> np.ndarray:
    """Load a 17-column whitespace trajectory file (15 ms grid)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    if data.shape[1] != TRAJ_COLS:
        raise ValueError(
            f"expected {TRAJ_COLS} columns, got {data.shape[1]} in {path}")
    return data


def save_traj_txt(path: str, table) -> None:
    """Write a 17-column trajectory in the reference's text format."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    np.savetxt(path, np.asarray(table), fmt="%.6f")


def load_poly_csv(path: str):
    """Load a 33-column polynomial CSV (figure8.csv format).

    Returns (durations (P,), coeffs (P, 4, 8)) with axis order x, y, z, yaw
    and coefficients lowest-power-first.
    """
    data = np.loadtxt(path, delimiter=",", skiprows=1, usecols=range(33))
    if data.ndim == 1:
        data = data[None, :]
    durations = data[:, 0]
    coeffs = data[:, 1:33].reshape(-1, 4, 8)
    return durations, coeffs


def encode_poly4d(durations, coeffs) -> bytes:
    """Pack pieces into the trajectory-memory wire blob (132 B/piece):
    little-endian float32 x^0..x^7, y^0..y^7, z^0..z^7, yaw^0..yaw^7,
    duration (the crazyflie_cpp poly4d upload format)."""
    durations = np.asarray(durations, np.float64)
    coeffs = np.asarray(coeffs, np.float64)
    out = b""
    for dur, c in zip(durations, coeffs):
        out += struct.pack("<33f", *c.reshape(32), float(dur))
    return out


def decode_poly4d(blob: bytes, n_pieces: int):
    """Inverse of `encode_poly4d`: blob -> (durations (P,), coeffs
    (P, 4, 8) lowest-power-first)."""
    if len(blob) < 132 * n_pieces:
        raise ValueError(f"poly4d blob too short: {len(blob)} B for "
                         f"{n_pieces} pieces")
    durations = np.zeros(n_pieces)
    coeffs = np.zeros((n_pieces, 4, 8))
    for i in range(n_pieces):
        vals = struct.unpack("<33f", blob[132 * i:132 * (i + 1)])
        coeffs[i] = np.asarray(vals[:32]).reshape(4, 8)
        durations[i] = vals[32]
    return durations, coeffs


def _polyval(c, t):
    """sum_i c[..., i] t^i (lowest-power-first) by Horner; t broadcasts
    against c[..., 0]."""
    r = torch.zeros_like(t) + c[..., -1]
    for i in range(c.shape[-1] - 2, -1, -1):
        r = r * t + c[..., i]
    return r


def _polyder(c):
    """Derivative coefficients, lowest-power-first."""
    n = c.shape[-1]
    return c[..., 1:] * torch.arange(1, n, dtype=c.dtype, device=c.device)


def eval_flat_outputs(durations, coeffs, t):
    """Evaluate the 4D piecewise polynomial and its first three derivatives
    at times t (any shape; clamped to the trajectory's span).

    Returns dict(pos (..., 3), vel, acc, jerk (..., 3), yaw, dyaw (...)),
    on t's device in the coefficients' dtype.
    """
    t = torch.as_tensor(t)
    durations = torch.as_tensor(durations, device=t.device)
    coeffs = torch.as_tensor(coeffs, device=t.device)
    starts = torch.cat([torch.zeros((1,), dtype=durations.dtype,
                                    device=t.device),
                        torch.cumsum(durations, 0)[:-1]])
    total = torch.sum(durations)
    t = torch.clamp(t.to(durations.dtype), min=0.0)
    t = torch.minimum(t, total - 1e-9)
    piece = torch.clamp(torch.searchsorted(starts, t, right=True) - 1,
                        0, durations.shape[0] - 1)
    tau = (t - starts[piece])[..., None]      # against (..., 4)
    c0 = coeffs[piece]                        # (..., 4, 8)
    c1 = _polyder(c0)
    c2 = _polyder(c1)
    c3 = _polyder(c2)
    f0 = _polyval(c0, tau)                    # (..., 4)
    f1 = _polyval(c1, tau)
    f2 = _polyval(c2, tau)
    f3 = _polyval(c3, tau)
    return dict(pos=f0[..., :3], vel=f1[..., :3], acc=f2[..., :3],
                jerk=f3[..., :3], yaw=f0[..., 3], dyaw=f1[..., 3])


def _dot(a, b):
    return (a * b).sum(dim=-1)


def flat_to_state(flat, params: QuadrotorParams, g: float = 9.8066):
    """Differential-flatness map: flat outputs -> (x (..., 13), u (..., 4)).

    Same construction as the reference's uav_trajectory.py:70-84 (thrust
    axis from acc+g, body frame from yaw, omega from the jerk projection),
    extended to a full state: quaternion from the body-frame DCM,
    body-frame linear velocity, and rotor speeds from collective thrust
    w_i = sqrt(m |a_thrust| / (4 Ct)).
    """
    acc = flat["acc"] + torch.tensor([0.0, 0.0, g], dtype=flat["acc"].dtype,
                                     device=flat["acc"].device)
    thrust_norm = torch.linalg.vector_norm(acc, dim=-1)
    z_body = acc / thrust_norm[..., None]
    yaw = flat["yaw"]
    x_world = torch.stack([torch.cos(yaw), torch.sin(yaw),
                           torch.zeros_like(yaw)], dim=-1)
    y_body_raw = torch.linalg.cross(z_body, x_world)
    y_body = y_body_raw / torch.linalg.vector_norm(y_body_raw, dim=-1,
                                                   keepdim=True)
    x_body = torch.linalg.cross(y_body, z_body)

    # body->earth DCM columns are the body axes
    R = torch.stack([x_body, y_body, z_body], dim=-1)

    # rotation matrix -> quaternion (w>0 branch; trajectories stay far from
    # the 180-degree singularity)
    qw = 0.5 * torch.sqrt(torch.clamp(
        1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], min=1e-12))
    qx = (R[..., 2, 1] - R[..., 1, 2]) / (4 * qw)
    qy = (R[..., 0, 2] - R[..., 2, 0]) / (4 * qw)
    qz = (R[..., 1, 0] - R[..., 0, 1]) / (4 * qw)
    q = torch.stack([qw, qx, qy, qz], dim=-1)

    # angular velocity from jerk (uav_trajectory.py:79-84)
    jerk = flat["jerk"]
    jerk_orth = jerk - _dot(jerk, z_body)[..., None] * z_body
    h_w = jerk_orth / thrust_norm[..., None]
    omega = torch.stack([-_dot(h_w, y_body), _dot(h_w, x_body),
                         z_body[..., 2] * flat["dyaw"]], dim=-1)

    v_body = torch.einsum("...ji,...j->...i", R, flat["vel"])

    w_rotor = torch.sqrt(params.mq * thrust_norm / (4.0 * params.Ct))
    u = w_rotor[..., None].expand(w_rotor.shape + (NU,))

    x = torch.cat([flat["pos"], q, v_body, omega], dim=-1)
    return x, u


def _table(flat, params, dtype):
    x, u = flat_to_state(flat, params)
    return torch.cat([x, u], dim=-1).to(dtype)


def _times(duration, dt, device):
    n = int(np.floor(duration / dt)) + 1
    return torch.arange(n, dtype=torch.float64, device=device) * dt


def sample_poly_trajectory(durations, coeffs, params: QuadrotorParams,
                           dt: float = 0.015, dtype=torch.float64,
                           device=None) -> torch.Tensor:
    """Sample a polynomial trajectory onto the 15 ms 17-column grid that
    the Tracking policy consumes: (T, 17)."""
    dev = resolve_device(device)
    total = float(np.sum(_np64(durations)))
    times = _times(total, dt, dev)
    flat = eval_flat_outputs(torch.as_tensor(_np64(durations)),
                             torch.as_tensor(_np64(coeffs)), times)
    return _table(flat, params, dtype)


def helix_trajectory(params: QuadrotorParams, radius=0.3, z0=0.04, z1=1.0,
                     turns=2.5, duration=15.75, dt=0.015,
                     center=(0.0, 0.0), dtype=torch.float64,
                     device=None) -> torch.Tensor:
    """Generate a helix climb reference analytically (the shape of the
    reference's traj/helix_traj.txt: rises while circling), (T, 17).

    The analytic flat outputs (sinusoids + linear climb) run through the
    same flatness map as polynomial trajectories, giving dynamically
    consistent (x, u) rows.
    """
    t = _times(duration, dt, resolve_device(device))
    w = 2.0 * math.pi * turns / duration
    cz = (z1 - z0) / duration
    cs, sn = torch.cos(w * t), torch.sin(w * t)
    zero = torch.zeros_like(t)
    flat = dict(
        pos=torch.stack([center[0] + radius * cs, center[1] + radius * sn,
                         z0 + cz * t], dim=-1),
        vel=torch.stack([-radius * w * sn, radius * w * cs,
                         torch.full_like(t, cz)], dim=-1),
        acc=torch.stack([-radius * w**2 * cs, -radius * w**2 * sn, zero],
                        dim=-1),
        jerk=torch.stack([radius * w**3 * sn, -radius * w**3 * cs, zero],
                         dim=-1),
        yaw=zero, dyaw=zero)
    return _table(flat, params, dtype)


def smooth_step_trajectory(params: QuadrotorParams, start=(0.3, 0.0, 0.4),
                           end=(0.3, 0.0, 0.8), duration=6.75, dt=0.015,
                           dtype=torch.float64,
                           device=None) -> torch.Tensor:
    """Generate a smooth point-to-point step (quintic min-jerk profile),
    the shape of the reference's traj/smooth_step.txt, (T, 17)."""
    t = _times(duration, dt, resolve_device(device))[:, None]
    p0 = torch.tensor(start, dtype=torch.float64, device=t.device)
    d = torch.tensor(end, dtype=torch.float64, device=t.device) - p0
    T = duration
    s = t / T
    # min-jerk: 10 s^3 - 15 s^4 + 6 s^5 and derivatives
    b = 10 * s**3 - 15 * s**4 + 6 * s**5
    db = (30 * s**2 - 60 * s**3 + 30 * s**4) / T
    ddb = (60 * s - 180 * s**2 + 120 * s**3) / T**2
    dddb = (60 - 360 * s + 360 * s**2) / T**3
    zero = torch.zeros_like(t[:, 0])
    flat = dict(pos=p0 + d * b, vel=d * db, acc=d * ddb, jerk=d * dddb,
                yaw=zero, dyaw=zero)
    return _table(flat, params, dtype)


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)
