"""Rotation/attitude conversions (quaternion <-> Euler ZYX <-> rotation
matrix), PyTorch counterpart of `crazyflie_nmpc_tpu/models/rotations.py`.

Behavioral parity with the reference's hand-rolled conversions:
  * `quat_to_euler`     — acados_mpc.cpp:384-404 (`quatern2euler`)
  * `euler_to_quat`     — acados_estimator.cpp:327-354 (`euler2quatern`,
    including its sign convention and the qw>0 canonicalization)
  * `rotmat_earth_to_body` — acados_estimator.cpp:414-440
    (`rotateLinearVeloE2B`)

All functions operate on the last axis and broadcast over leading batch
axes; they run where their inputs are.  Quaternion layout is
(qw, qx, qy, qz).
"""

from __future__ import annotations

import math

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize a quaternion to unit length along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def quat_canonicalize(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the scalar part is non-negative (reference convention,
    acados_estimator.cpp:347-351)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> ZYX Euler angles (phi=roll, theta=pitch, psi=yaw).

    Same algebra as the reference's quatern2euler (acados_mpc.cpp:384-404):
    built from rotation-matrix entries of the earth->body DCM.
    Returns (..., 3) = (phi, theta, psi) in radians.
    """
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r11 = 2 * (qw * qw + qx * qx) - 1
    r21 = 2 * (qx * qy - qw * qz)
    r31 = 2 * (qx * qz + qw * qy)
    r32 = 2 * (qy * qz - qw * qx)
    r33 = 2 * (qw * qw + qz * qz) - 1
    phi = torch.atan2(r32, r33)
    theta = -torch.asin(torch.clamp(r31, -1.0, 1.0))
    psi = torch.atan2(r21, r11)
    return torch.stack([phi, theta, psi], dim=-1)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """ZYX Euler angles (phi, theta, psi) [rad] -> unit quaternion.

    Replicates the reference estimator's euler2quatern
    (acados_estimator.cpp:327-354) including its negated vector part (the
    conjugate of the textbook ZYX composition) and the qw>=0
    canonicalization.  Returns (..., 4) = (qw, qx, qy, qz).
    """
    half = euler * 0.5
    cph, cth, cps = (torch.cos(half[..., 0]), torch.cos(half[..., 1]),
                     torch.cos(half[..., 2]))
    sph, sth, sps = (torch.sin(half[..., 0]), torch.sin(half[..., 1]),
                     torch.sin(half[..., 2]))

    qw = cph * cth * cps + sph * sth * sps
    qx = -(cps * cth * sph - sps * sth * cph)
    qy = -(cps * sth * cph + sps * cth * sph)
    qz = -(sps * cth * cph - cps * sth * sph)
    return quat_canonicalize(torch.stack([qw, qx, qy, qz], dim=-1))


def rotmat_earth_to_body(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> earth->body rotation matrix (ZYX convention).

    Same entries as the reference's rotateLinearVeloE2B
    (acados_estimator.cpp:414-440).  Returns (..., 3, 3).
    """
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s11 = 2 * (qw * qw + qx * qx) - 1
    s12 = 2 * (qx * qy + qw * qz)
    s13 = 2 * (qx * qz - qw * qy)
    s21 = 2 * (qx * qy - qw * qz)
    s22 = 2 * (qw * qw + qy * qy) - 1
    s23 = 2 * (qy * qz + qw * qx)
    s31 = 2 * (qx * qz + qw * qy)
    s32 = 2 * (qy * qz - qw * qx)
    s33 = 2 * (qw * qw + qz * qz) - 1
    row1 = torch.stack([s11, s12, s13], dim=-1)
    row2 = torch.stack([s21, s22, s23], dim=-1)
    row3 = torch.stack([s31, s32, s33], dim=-1)
    return torch.stack([row1, row2, row3], dim=-2)


def rotmat_body_to_earth(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> body->earth rotation (transpose of earth->body)."""
    return rotmat_earth_to_body(q).transpose(-1, -2)


def rotate_earth_to_body(q: torch.Tensor,
                         v_earth: torch.Tensor) -> torch.Tensor:
    """Rotate an earth-frame vector into the body frame (batched matvec)."""
    return torch.einsum("...ij,...j->...i", rotmat_earth_to_body(q), v_earth)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a (x) b, layout (qw, qx, qy, qz)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def deg2rad(deg):
    """Degrees -> radians (reference: acados_mpc.cpp:406-409)."""
    return deg * (math.pi / 180.0)


def rad2deg(rad):
    """Radians -> degrees (reference: acados_mpc.cpp:411-414)."""
    return rad * (180.0 / math.pi)
