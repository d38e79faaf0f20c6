"""Differentiable MPC: gradient-based tuning of the OCP cost (PyTorch
counterpart of `runtime/tuning.py`).

The whole closed loop (RK4 plant, RTI step, fixed-iteration IPM, delay
pipeline) is plain PyTorch on the spec's device, so autograd
differentiates a scalar flight-quality objective through the solver with
respect to the cost weights, and a few dozen Adam steps replace the
reference's hand-tuned weight panel (crazyflie_params.cfg:12-36).

Works for any diagonal LLS cost spec (the quadrotor and the cart-pole
alike): the weights are parameterised in log space (positive by
construction) and the objective is measured in physical units (position
error, control effort), so the tuned weights cannot cheat by rescaling
themselves.  `LoopConfig(remat=True)` recomputes each tick in the backward
pass, so long flights fit in memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import device_tensor, host_sync
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec


class TuneResult(NamedTuple):
    spec: Any        # OCPSpec with the tuned cost
    losses: Any      # (iters+1,) objective per iteration (incl. initial)
    w_diag: Any      # (ny,) tuned stage weight diagonal
    we_diag: Any     # (nx_e,) tuned terminal weight diagonal


def spec_with_diag_cost(spec: OCPSpec, w_diag, we_diag) -> OCPSpec:
    """Rebuild the spec with new diagonal W / W_e (selectors unchanged)."""
    cost = dataclasses.replace(spec.cost, W=torch.diag(w_diag),
                               W_e=torch.diag(we_diag))
    return dataclasses.replace(spec, cost=cost)


def tune_diagonal_cost(spec: OCPSpec,
                       rollout: Callable[[OCPSpec], Any],
                       objective: Callable[[Any], torch.Tensor],
                       iters: int = 30, lr: float = 0.1) -> TuneResult:
    """Tune log-diagonal cost weights by Adam on a closed-loop objective.

    Args:
      rollout: spec -> anything (typically `runtime.closed_loop.simulate`
        output); must be differentiable w.r.t. the spec's cost weights.
      objective: rollout output -> 0-dim loss in physical units.
      iters / lr: Adam steps and learning rate on log-weights
        (`torch.optim.Adam`, betas 0.9 / 0.999, eps 1e-8: optax.adam's).

    Returns TuneResult with the best-seen weights (not necessarily the
    last iterate); `losses[0]` is the untuned objective so callers can
    assert improvement.  Each step reads its loss on the host once (the
    best-iterate bookkeeping, counted by `device.host_sync`).
    """
    # floor zero diagonal entries: log(0) = -inf would give nan gradients
    # that poison every weight through Adam; exp(log(floor)) ~ 1e-12 keeps
    # an unpenalized channel effectively unpenalized while staying tunable
    floor = 1e-12
    w0 = torch.clamp(torch.diagonal(spec.cost.W), min=floor)
    we0 = torch.clamp(torch.diagonal(spec.cost.W_e), min=floor)
    theta = [torch.log(w0).detach().clone().requires_grad_(True),
             torch.log(we0).detach().clone().requires_grad_(True)]

    def loss_fn(th):
        s = spec_with_diag_cost(spec, torch.exp(th[0]), torch.exp(th[1]))
        return objective(rollout(s))

    opt = torch.optim.Adam(theta, lr=lr)
    losses = []
    best_theta = [t.detach().clone() for t in theta]
    best_val = float("inf")
    for _ in range(iters):
        opt.zero_grad()
        val = loss_fn(theta)
        val.backward()
        # `val` is the objective at `theta` (before the update); keep the
        # best iterate seen: Adam on this landscape can overshoot late
        with host_sync("tuning best iterate"):
            v = float(val.detach())
        if v < best_val:
            best_theta = [t.detach().clone() for t in theta]
            best_val = v
        opt.step()
        losses.append(val.detach())
    # losses[0] is the untuned objective; append the final iterate's,
    # from a forward pass only
    with torch.no_grad():
        final = loss_fn(theta)
    with host_sync("tuning best iterate"):
        v = float(final)
    if v < best_val:
        best_theta = [t.detach().clone() for t in theta]
    losses = torch.stack(losses + [final])
    w, we = torch.exp(best_theta[0]), torch.exp(best_theta[1])
    return TuneResult(spec=spec_with_diag_cost(spec, w, we),
                      losses=losses, w_diag=w, we_diag=we)


def hover_objective(setpoint=(0.0, 0.0, 0.5), u_weight: float = 1e-5,
                    settle_weight: float = 4.0):
    """Physical-units flight-quality objective for a hover LoopResult:
    mean squared position error + control-effort penalty + extra weight on
    the late-trajectory (settling) error."""

    def obj(res):
        sp = device_tensor(setpoint, res.x.dtype, res.x.device)
        pos_err = torch.sum((res.x[:, :3] - sp) ** 2, dim=1)
        T = pos_err.shape[0]
        tail = pos_err[int(0.6 * T):]
        du = torch.diff(res.u, dim=0)
        return (torch.mean(pos_err) + settle_weight * torch.mean(tail)
                + u_weight * torch.mean(torch.sum(du ** 2, dim=1)))

    return obj
