"""Explicit RK4 integration (PyTorch counterpart of `ops/integrators.py`).

Only what the batched RTI step needs: the classic 4-stage step that the
OCP's ERK integrator uses (generate_c_code.py:142) and the open-loop
rollout that seeds the warm start.  Leading axes are batch axes.
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


def rollout(f: Callable, params, x0: torch.Tensor, u_traj: torch.Tensor,
            dt, num_steps: int = 1) -> torch.Tensor:
    """Open-loop rollout of u_traj (..., N, nu) from x0 (..., nx).

    Returns (..., N+1, nx) including x0.  `num_steps` equal RK4 sub-steps
    per interval, control held (zero-order hold).
    """
    h = dt / num_steps
    xs = [x0]
    x = x0
    for k in range(u_traj.shape[-2]):
        u = u_traj[..., k, :]
        for _ in range(num_steps):
            x = rk4_step(f, params, x, u, h)
        xs.append(x)
    return torch.stack(xs, dim=-2)
