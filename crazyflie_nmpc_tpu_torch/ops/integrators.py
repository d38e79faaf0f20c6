"""Explicit RK4 integration with forward sensitivities (PyTorch counterpart
of `ops/integrators.py`).

The OCP's integrator is the classic 4-stage explicit Runge-Kutta step over
each shooting interval (generate_c_code.py:142); its sensitivities come
either from `torch.func.jacfwd` through the integrator (17 tangent
directions through the same RK scheme, the JAX package's `jax.jacfwd`), or
from the closed-form matrix VDE on the hand-derived Jacobians of the
quadrotor.  Leading axes are batch axes throughout; the model ODE must be
functorch-clean (no in-place writes, no `.item()`), as `dynamics` is, and
should not multiply a 0-dim tensor by a Python float: jacfwd gives that
product a float64 tangent (`dynamics` takes (..., 1) columns instead).
"""

from __future__ import annotations

from typing import Callable

import torch


def rk4_step(f: Callable, params, x: torch.Tensor, u: torch.Tensor,
             dt) -> torch.Tensor:
    """One classic 4-stage explicit Runge-Kutta step of xdot = f(x, u)."""
    k1 = f(params, x, u)
    k2 = f(params, x + 0.5 * dt * k1, u)
    k3 = f(params, x + 0.5 * dt * k2, u)
    k4 = f(params, x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate(f: Callable, params, x: torch.Tensor, u: torch.Tensor, T,
              num_steps: int = 1) -> torch.Tensor:
    """Integrate over a horizon T with `num_steps` equal RK4 sub-steps,
    control held (zero-order hold, acados_estimator.cpp:573-589)."""
    dt = T / num_steps
    for _ in range(num_steps):
        x = rk4_step(f, params, x, u, dt)
    return x


def step_with_sensitivities(f: Callable, params, x: torch.Tensor,
                            u: torch.Tensor, dt, num_steps: int = 1):
    """Discrete step F(x,u) plus forward sensitivities A = dF/dx,
    B = dF/du of one instance (x (nx,), u (nu,)), by `torch.func.jacfwd`
    through the integrator (the CasADi forward VDE's role,
    acados_mpc.cpp:84).  Returns (x_next (nx,), A (nx,nx), B (nx,nu))."""
    def step_fn(x_, u_):
        return integrate(f, params, x_, u_, dt * num_steps, num_steps)

    A, B = torch.func.jacfwd(step_fn, argnums=(0, 1))(x, u)
    return step_fn(x, u), A, B


def rollout(f: Callable, params, x0: torch.Tensor, u_traj: torch.Tensor,
            dt, num_steps: int = 1) -> torch.Tensor:
    """Open-loop rollout of u_traj (..., N, nu) from x0 (..., nx).

    Returns (..., N+1, nx) including x0.  `num_steps` equal RK4 sub-steps
    per interval, control held (zero-order hold).
    """
    xs = [x0]
    x = x0
    for k in range(u_traj.shape[-2]):
        x = integrate(f, params, x, u_traj[..., k, :], dt * num_steps,
                      num_steps)
        xs.append(x)
    return torch.stack(xs, dim=-2)


def linearize_trajectory(f: Callable, params, x_traj: torch.Tensor,
                         u_traj: torch.Tensor, dt, num_steps: int = 1):
    """Stage-parallel linearization along a trajectory: every shooting
    interval at once, `step_with_sensitivities` under `torch.func.vmap`
    over the stages (and any leading batch axes, flattened into them).

    Args:
      x_traj: (..., N+1, nx) state iterate, u_traj: (..., N, nu).
    Returns:
      x_next (..., N, nx) = F(x_k, u_k), A (..., N, nx, nx),
      B (..., N, nx, nu).
    """
    xs, us = x_traj[..., :-1, :], u_traj
    lead = us.shape[:-1]
    nx, nu = xs.shape[-1], us.shape[-1]

    def one(x, u):
        return step_with_sensitivities(f, params, x, u, dt, num_steps)

    x_next, A, B = torch.func.vmap(one)(xs.reshape(-1, nx),
                                        us.reshape(-1, nu))
    return (x_next.reshape(lead + (nx,)), A.reshape(lead + (nx, nx)),
            B.reshape(lead + (nx, nu)))


def step_with_sensitivities_vde(params, x: torch.Tensor, u: torch.Tensor,
                                dt):
    """RK4 discrete step + sensitivities via the closed-form matrix VDE:
    the (nx, nx)/(nx, nu) tangent matrices through the four RK stages with
    the hand-derived `dynamics_jacobians` (one pass of dense chain rules
    instead of 17 jacfwd tangents).  Equals `step_with_sensitivities(
    dynamics, ...)` to roundoff.

    Shapes: x (..., 13), u (..., 4) ->
      (x_next (..., 13), A (..., 13, 13), B (..., 13, 4)).
    """
    from crazyflie_nmpc_tpu_torch.models.quadrotor import (
        dynamics,
        dynamics_jacobians,
    )

    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)

    def f_and_jac(x_):
        return (dynamics(params, x_, u),) + dynamics_jacobians(params, x_, u)

    k1, J1, G1 = f_and_jac(x)
    k2, J2, G2 = f_and_jac(x + 0.5 * dt * k1)
    k3, J3, G3 = f_and_jac(x + 0.5 * dt * k2)
    k4, J4, G4 = f_and_jac(x + dt * k3)

    # tangent chain through the stages: Ki = d k_i/dx, Mi = d k_i/du
    K1 = J1
    K2 = J2 @ (eye + 0.5 * dt * K1)
    K3 = J3 @ (eye + 0.5 * dt * K2)
    K4 = J4 @ (eye + dt * K3)
    M1 = G1
    M2 = G2 + J2 @ (0.5 * dt * M1)
    M3 = G3 + J3 @ (0.5 * dt * M2)
    M4 = G4 + J4 @ (dt * M3)

    x_next = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    A = eye + (dt / 6.0) * (K1 + 2 * K2 + 2 * K3 + K4)
    B = (dt / 6.0) * (M1 + 2 * M2 + 2 * M3 + M4)
    return x_next, A, B


def linearize_trajectory_vde(params, x_traj: torch.Tensor,
                             u_traj: torch.Tensor, dt):
    """`linearize_trajectory` on the closed-form VDE (num_steps=1): all
    stages at once, leading axes batch axes."""
    return step_with_sensitivities_vde(params, x_traj[..., :-1, :], u_traj,
                                       dt)
