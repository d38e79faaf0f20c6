"""Multistage (OCP-structured) QP data and Gauss-Newton builders (PyTorch
counterpart of `ops/qp.py`).

The QP solved at every RTI iteration:

  min   sum_k 1/2 [dx_k;du_k]' [Qxx_k S_k'; S_k Ruu_k] [dx_k;du_k]
                 + qx_k'dx_k + ru_k'du_k
        + 1/2 dx_N' P dx_N + p'dx_N
  s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,   k = 0..N-1
        dx_0     = dx0
        lb_k <= du_k <= ub_k                 (input box, relative to iterate)

All arrays are stage-stacked along axis 0 (one problem; the batched path
is `solver.rti_batched`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class QPData:
    """Stage-structured LQ problem data (shapes for horizon N, dims nx/nu)."""

    A: Any    # (N, nx, nx) discrete dynamics Jacobian dF/dx
    B: Any    # (N, nx, nu) discrete dynamics Jacobian dF/du
    c: Any    # (N, nx)     dynamics defect F(x_k,u_k) - x_{k+1}
    Qxx: Any  # (N, nx, nx) stage state Hessian
    qx: Any   # (N, nx)     stage state gradient
    Ruu: Any  # (N, nu, nu) stage input Hessian
    ru: Any   # (N, nu)     stage input gradient
    S: Any    # (N, nu, nx) stage cross Hessian (d^2/du dx)
    P: Any    # (nx, nx)    terminal Hessian
    p: Any    # (nx,)       terminal gradient
    lb: Any   # (N, nu)     lower input bound (relative to iterate)
    ub: Any   # (N, nu)     upper input bound (relative to iterate)
    dx0: Any  # (nx,)       fixed initial state deviation

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]


def gauss_newton_cost_blocks(W, Vx, Vu, W_e, Vx_e, x_traj, u_traj,
                             yref, yref_e):
    """Gauss-Newton Hessian/gradient blocks of the linear-least-squares
    cost sum_k 1/2 |Vx x_k + Vu u_k - yref_k|^2_W + 1/2 |Vx_e x_N -
    yref_e|^2_{W_e} (generate_c_code.py:62-129): Qxx = Vx'WVx, Ruu =
    Vu'WVu, S = Vu'WVx, P = Vx_e'W_e Vx_e, residual-weighted gradients.

    Args: x_traj (N+1, nx), u_traj (N, nu), yref (N, ny), yref_e (nx_e,).
    Returns dict of stage-stacked blocks (Qxx, qx, Ruu, ru, S, P, p).
    """
    N = u_traj.shape[0]
    WVx = W @ Vx
    WVu = W @ Vu
    Qxx = Vx.T @ WVx
    Ruu = Vu.T @ WVu
    S = Vu.T @ WVx

    e = x_traj[:-1] @ Vx.T + u_traj @ Vu.T - yref      # (N, ny)
    P = Vx_e.T @ W_e @ Vx_e
    e_N = x_traj[-1] @ Vx_e.T - yref_e
    return dict(
        Qxx=Qxx.expand((N,) + Qxx.shape),
        qx=e @ WVx,
        Ruu=Ruu.expand((N,) + Ruu.shape),
        ru=e @ WVu,
        S=S.expand((N,) + S.shape),
        P=P,
        p=Vx_e.T @ (W_e @ e_N),
    )


def build_qp(A, B, x_next_pred, x_traj, u_traj, x0, lbu, ubu, cost_blocks):
    """Assemble the RTI QP from the linearization (A, B, x_next_pred =
    F(x_k, u_k)), the iterate, the measured x0 (the lbx0=ubx0 equality,
    acados_mpc.cpp:581-582), the absolute input bounds (scalars, (nu,) or
    (N, nu)) and the cost blocks."""
    def box(v):
        v = torch.as_tensor(v, dtype=u_traj.dtype, device=u_traj.device)
        return v.expand(u_traj.shape) - u_traj

    return QPData(A=A, B=B, c=x_next_pred - x_traj[1:], lb=box(lbu),
                  ub=box(ubu), dx0=x0 - x_traj[0], **cost_blocks)
