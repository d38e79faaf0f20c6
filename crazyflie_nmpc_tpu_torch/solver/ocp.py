"""OCP specification: dims, cost, bounds (counterpart of `solver/ocp.py`).

`default_ocp()` is the exact reference problem: N=50, Tf=0.75 s (dt=15 ms),
W=blkdiag(Q,R) with the reference diagonals, W_e=50Q, input box [0, 22]
kRPM (generate_c_code.py:41-147).  Weights and bounds are tensors on the
spec's device; N and sim_steps shape the problem.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.models.quadrotor import (
    NU,
    NX,
    NY,
    QuadrotorParams,
    W_MAX_KRPM,
    W_MIN_KRPM,
)


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """Linear-least-squares tracking cost |Vx x + Vu u - yref|^2_W."""

    W: torch.Tensor     # (ny, ny)
    Vx: torch.Tensor    # (ny, nx)
    Vu: torch.Tensor    # (ny, nu)
    W_e: torch.Tensor   # (nx_e, nx_e)
    Vx_e: torch.Tensor  # (nx_e, nx)


@dataclasses.dataclass(frozen=True)
class OCPSpec:
    """Full optimal-control-problem spec for the RTI solver.

    `f` (a custom model ODE) is kept for parity with the JAX spec; the
    batched kernel path is quadrotor-specialized and rejects it.
    """

    params: QuadrotorParams
    cost: CostSpec
    lbu: torch.Tensor   # (nu,) absolute lower input bound [kRPM]
    ubu: torch.Tensor   # (nu,) absolute upper input bound [kRPM]
    tf: torch.Tensor    # horizon length [s], 0-dim
    N: int = 50
    sim_steps: int = 1
    f: Any = None
    u_ss: Any = None

    def ode(self):
        """The model ODE (f or the quadrotor default)."""
        if self.f is not None:
            return self.f
        from crazyflie_nmpc_tpu_torch.models.quadrotor import dynamics
        return dynamics

    def steady_input(self, dtype) -> torch.Tensor:
        """(nu,) warm-start input: u_ss, or hover speed on all rotors."""
        dev = self.lbu.device
        if self.u_ss is not None:
            return torch.as_tensor(self.u_ss, dtype=dtype, device=dev)
        return torch.full((self.lbu.shape[0],), self.params.hover_speed(),
                          dtype=torch.float64, device=dev).to(dtype)

    @property
    def dt(self) -> torch.Tensor:
        return self.tf / self.N


# Reference stage weight diagonals (generate_c_code.py:62-84).
Q_DIAG_REF = (120.0, 100.0, 100.0,          # position
              1e-3, 1e-3, 1e-3, 1e-3,        # quaternion
              7e-1, 1.0, 4.0,                # body velocity
              1e-5, 1e-5, 10.0)              # body rates
R_DIAG_REF = (0.06, 0.06, 0.06, 0.06)        # rotor speeds
WN_FACTOR_REF = 50.0                         # W_e = 50 Q (:109)


def diagonal_lls_cost(q_diag, r_diag, terminal_factor=WN_FACTOR_REF,
                      dtype=torch.float32, device=None) -> CostSpec:
    """W = blkdiag(Q, R), W_e = terminal_factor * Q, selector Vx/Vu."""
    dev = resolve_device(device)
    q = torch.as_tensor(q_diag, dtype=dtype, device=dev)
    r = torch.as_tensor(r_diag, dtype=dtype, device=dev)
    nx, nu = q.shape[0], r.shape[0]
    ny = nx + nu
    W = torch.diag(torch.cat([q, r]))
    Vx = torch.zeros((ny, nx), dtype=dtype, device=dev)
    Vx[:nx] = torch.eye(nx, dtype=dtype, device=dev)
    Vu = torch.zeros((ny, nu), dtype=dtype, device=dev)
    Vu[nx:] = torch.eye(nu, dtype=dtype, device=dev)
    W_e = torch.diag(terminal_factor * q)
    Vx_e = torch.eye(nx, dtype=dtype, device=dev)
    return CostSpec(W=W, Vx=Vx, Vu=Vu, W_e=W_e, Vx_e=Vx_e)


def default_cost(q_diag=Q_DIAG_REF, r_diag=R_DIAG_REF,
                 terminal_factor=WN_FACTOR_REF, dtype=torch.float32,
                 device=None) -> CostSpec:
    """The reference cost: W = blkdiag(Q, R), W_e = 50 Q, selector Vx/Vu."""
    return diagonal_lls_cost(q_diag, r_diag, terminal_factor, dtype, device)


def default_ocp(params: QuadrotorParams | None = None, N: int = 50,
                tf: float = 0.75, sim_steps: int = 1, dtype=torch.float32,
                device=None) -> OCPSpec:
    """The exact reference OCP (generate_c_code.py:41-147)."""
    dev = resolve_device(device)
    return OCPSpec(
        params=params or QuadrotorParams(),
        cost=default_cost(dtype=dtype, device=dev),
        lbu=torch.full((NU,), W_MIN_KRPM, dtype=dtype, device=dev),
        ubu=torch.full((NU,), W_MAX_KRPM, dtype=dtype, device=dev),
        tf=torch.tensor(tf, dtype=dtype, device=dev),
        N=N,
        sim_steps=sim_steps,
    )


def hover_yref(spec: OCPSpec, pos=(0.0, 0.0, 0.5), device=None):
    """Regulation reference: hover at `pos`, identity attitude, steady
    rotor speed (generate_c_code.py:128-129).

    Returns (yref (N, 17), yref_e (13,)) in the spec's dtype.
    """
    dev = resolve_device(device)
    y = torch.zeros((NY,), dtype=spec.lbu.dtype, device=dev)
    y[0], y[1], y[2] = pos[0], pos[1], pos[2]
    y[3] = 1.0
    y[NX:] = spec.params.hover_speed()
    return y.expand(spec.N, NY).contiguous(), y[:NX].clone()
