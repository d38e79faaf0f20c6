"""Pendulum-on-cart model: the second model family through the same engine
(PyTorch counterpart of `models/cartpole.py`).

Any CasADi ODE becomes an `AcadosModel` in the reference and flows into
the same SQP-RTI solver the quadrotor uses (generate_c_code.py:36-157;
the pendulum-on-cart is the acados project's own flagship example).  Here
the equivalent is `OCPSpec.f`: any functorch-clean callable
`f(params, x, u)` slots into `solver.rti.rti_step`, which linearises it
with `torch.func.jacfwd` under `vmap`.  The batched kernel path is
quadrotor-specific and refuses such a spec (`rti_step_batched`).

4 states: cart position p [m], pole angle theta [rad] (0 = upright),
cart velocity v, pole angular rate dtheta.  1 control: horizontal force
F [N] on the cart.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from crazyflie_nmpc_tpu_torch.device import device_tensor, resolve_device

CP_NX = 4
CP_NU = 1
CP_NY = CP_NX + CP_NU

STATE_NAMES = ("p", "theta", "v", "dtheta")
CONTROL_NAMES = ("F",)


@dataclasses.dataclass(frozen=True)
class CartpoleParams:
    """Physical parameters (classic benchmark values), Python floats."""

    g0: float = 9.81    # [m/s^2]
    M: float = 1.0      # [kg] cart mass
    m: float = 0.1      # [kg] pole point mass
    l: float = 0.8      # [m] pole length (pivot to mass)

    def hover_speed(self) -> float:
        """Steady-state input (zero force at the upright equilibrium),
        the quadrotor's hover speed's warm-start role."""
        return 0.0


def cartpole_dynamics(params: CartpoleParams, x: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """xdot = f(params, x, u): frictionless pendulum on a cart, x (..., 4),
    u (..., 1).

    Lagrangian dynamics with theta measured from the upright position.
    Each state is a (..., 1) column, never a 0-dim tensor (a 0-dim tensor
    times a Python float gets a float64 tangent under jacfwd).
    """
    theta, v, dtheta = x[..., 1:2], x[..., 2:3], x[..., 3:4]
    F = u[..., 0:1]

    s, c = torch.sin(theta), torch.cos(theta)
    M, m, l, g0 = params.M, params.m, params.l, params.g0
    denom = M + m * s * s
    dv = (F + m * s * (l * dtheta * dtheta - g0 * c)) / denom
    ddtheta = (-F * c
               - m * l * dtheta * dtheta * s * c
               + (M + m) * g0 * s) / (l * denom)
    return torch.cat([v, dtheta, dv, ddtheta], dim=-1)


def upright_state(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((CP_NX,), dtype=dtype, device=resolve_device(device))


def downward_state(dtype=torch.float32, device=None) -> torch.Tensor:
    """Pole hanging straight down: the swing-up initial condition."""
    return device_tensor((0.0, math.pi, 0.0, 0.0), dtype,
                         resolve_device(device))


def cartpole_ocp(params: CartpoleParams | None = None, N: int = 40,
                 tf: float = 2.0, f_max: float = 80.0,
                 q_diag=(1e1, 1e1, 1e-1, 1e-2), r_diag=(1e-3,),
                 terminal_factor: float = 50.0, dtype=torch.float64,
                 device=None):
    """An `OCPSpec` for cart-pole swing-up through the generic RTI path.

    The quadrotor OCP's LLS cost structure (W = blkdiag(Q, R),
    W_e = terminal_factor * Q, selector Vx/Vu) with a force box
    |F| <= f_max: the shape generate_c_code.py:62-136 builds, for another
    model.
    """
    from crazyflie_nmpc_tpu_torch.solver.ocp import (OCPSpec,
                                                     diagonal_lls_cost)

    dev = resolve_device(device)
    params = params or CartpoleParams()
    cost = diagonal_lls_cost(q_diag, r_diag, terminal_factor, dtype, dev)
    return OCPSpec(
        params=params,
        cost=cost,
        lbu=torch.full((CP_NU,), -f_max, dtype=dtype, device=dev),
        ubu=torch.full((CP_NU,), f_max, dtype=dtype, device=dev),
        tf=torch.full((), tf, dtype=dtype, device=dev),
        N=N,
        f=cartpole_dynamics,
        u_ss=torch.zeros((CP_NU,), dtype=dtype, device=dev),
    )
