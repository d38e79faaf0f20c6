"""Real-time-iteration SQP: one prepare+feedback Gauss-Newton step
(counterpart of `solver/rti.py`).

One Gauss-Newton SQP iteration per control period, warm-started from the
previous solution (the reference's per-tick `acados_solve()` with SQP_RTI,
acados_mpc.cpp:611, generate_c_code.py:146).  The carried iterate is
explicit:

    (RTIState, x0, yref) -> (RTIState', RTIOutput)

`rti_step` is the single-instance step (any model ODE, `spec.f`): the
stage-parallel `torch.func.jacfwd` linearization, the Gauss-Newton QP and
`ops.ipm.solve`, all plain PyTorch on the spec's device.  With escalation
off it never waits on the card (`ops.ipm`).  The batched kernel path is
`solver.rti_batched`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.ops import ipm
from crazyflie_nmpc_tpu_torch.ops.integrators import (linearize_trajectory,
                                                      rollout)
from crazyflie_nmpc_tpu_torch.ops.qp import (build_qp,
                                             gauss_newton_cost_blocks)
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec


@dataclasses.dataclass(frozen=True)
class RTIState:
    """Warm-start iterate carried across RTI calls (primal trajectory)."""

    x_traj: torch.Tensor  # (..., N+1, nx), or (N+1, nx, B) batch-last
    u_traj: torch.Tensor  # (..., N, nu), or (N, nu, B) batch-last


class RTIOutput(NamedTuple):
    """Per-solve outputs (acados_mpc.cpp:614-625)."""

    u0: Any       # first control
    u1: Any       # second control (delay-compensated command)
    x_plan: Any   # open-loop state plan
    u_plan: Any   # open-loop control plan
    kkt_res: Any  # residual diagnostic (cf. nlp_out->inf_norm_res)
    qp_mu: Any    # final IPM complementarity gap

    def x_at(self, stage: int):
        """Predicted state `stage` steps ahead (stage 4 = +60 ms at 15 ms),
        of a single-instance output."""
        return self.x_plan[stage]


def init_rti(spec: OCPSpec, x0, device=None) -> RTIState:
    """Warm start: steady-input rollout from x0 (..., nx), batch-first.

    Leading axes of x0 are batch axes (the JAX package vmaps this).
    """
    x0 = torch.as_tensor(x0, device=resolve_device(device))
    uss = spec.steady_input(x0.dtype).to(x0.device)
    u_traj = uss.expand(x0.shape[:-1] + (spec.N, uss.shape[0])).contiguous()
    x_traj = rollout(spec.ode(), spec.params, x0, u_traj,
                     spec.dt.to(x0.device), spec.sim_steps)
    return RTIState(x_traj=x_traj, u_traj=u_traj)


def rti_step(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
             yref: torch.Tensor, yref_e: torch.Tensor,
             config: ipm.IPMConfig = ipm.IPMConfig()):
    """One SQP-RTI iteration: linearize at the iterate, solve the QP, take
    a full Newton-type step.

    Args:
      x0: (nx,) current state estimate (becomes the lbx0=ubx0 equality).
      yref: (N, ny) stage references; yref_e: (nx,) terminal reference.
    Returns (RTIState', RTIOutput).
    """
    # preparation: stage-parallel linearization
    x_next, A, B = linearize_trajectory(
        spec.ode(), spec.params, state.x_traj, state.u_traj, spec.dt,
        spec.sim_steps)
    cost = spec.cost
    blocks = gauss_newton_cost_blocks(
        cost.W, cost.Vx, cost.Vu, cost.W_e, cost.Vx_e,
        state.x_traj, state.u_traj, yref, yref_e)
    qp = build_qp(A, B, x_next, state.x_traj, state.u_traj, x0,
                  spec.lbu, spec.ubu, blocks)

    # feedback: structured IPM solve + full-step update
    sol = ipm.solve(qp, config)
    x_traj = state.x_traj + sol.dx
    u_traj = state.u_traj + sol.du

    # NLP residual: dynamics infeasibility at the linearization point plus
    # the Newton step norm (both vanish at an NLP KKT point)
    res_nl = torch.maximum(qp.c.abs().amax(), qp.dx0.abs().amax())
    step_norm = torch.maximum(sol.du.abs().amax(), sol.dx.abs().amax())
    out = RTIOutput(u0=u_traj[0], u1=u_traj[1], x_plan=x_traj,
                    u_plan=u_traj, kkt_res=torch.maximum(res_nl, step_norm),
                    qp_mu=sol.stats["mu"])
    return RTIState(x_traj=x_traj, u_traj=u_traj), out


def sqp_solve(spec: OCPSpec, state: RTIState, x0, yref, yref_e,
              iters: int = 10, config: ipm.IPMConfig = ipm.IPMConfig()):
    """Full SQP: `iters` rti_steps on a fixed problem (the converged-NLP
    ground truth RTI tracks).  Returns (RTIState, kkt_res per iteration
    (iters,))."""
    kkts = []
    for _ in range(iters):
        state, out = rti_step(spec, state, x0, yref, yref_e, config)
        kkts.append(out.kkt_res)
    return state, torch.stack(kkts)


def as_rti_prepare(spec: OCPSpec, state: RTIState, x0_pred, yref, yref_e,
                   prep_iters: int = 1,
                   config: ipm.IPMConfig = ipm.IPMConfig()) -> RTIState:
    """Advanced-Step RTI preparation (arXiv:2403.07101, levels C/D):
    `prep_iters` extra SQP iterations on the OCP anchored at the predicted
    next measurement `x0_pred`."""
    state, _ = sqp_solve(spec, state, x0_pred, yref, yref_e,
                         iters=prep_iters, config=config)
    return state


def as_rti_step(spec: OCPSpec, state: RTIState, x0, x0_pred_next,
                yref, yref_e, config: ipm.IPMConfig = ipm.IPMConfig(),
                prep_iters: int = 1):
    """One AS-RTI cycle: feedback at the actual estimate, then
    advanced-step preparation at the predicted next one.  Returns
    (prepared RTIState for the next tick, RTIOutput of this tick)."""
    state, out = rti_step(spec, state, x0, yref, yref_e, config)
    state = as_rti_prepare(spec, state, x0_pred_next, yref, yref_e,
                           prep_iters, config)
    return state, out
