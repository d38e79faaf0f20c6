"""RTI state and outputs (counterpart of `solver/rti.py`).

Only the carried state, the output record and the warm start are ported;
the batched step lives in `solver.rti_batched`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.ops.integrators import rollout
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec


@dataclasses.dataclass(frozen=True)
class RTIState:
    """Warm-start iterate carried across RTI calls (primal trajectory)."""

    x_traj: torch.Tensor  # (..., N+1, nx), or (N+1, nx, B) batch-last
    u_traj: torch.Tensor  # (..., N, nu), or (N, nu, B) batch-last


class RTIOutput(NamedTuple):
    """Per-solve outputs (acados_mpc.cpp:614-625)."""

    u0: Any       # first control
    u1: Any       # second control
    x_plan: Any   # open-loop state plan
    u_plan: Any   # open-loop control plan
    kkt_res: Any  # residual diagnostic
    qp_mu: Any    # final IPM complementarity gap


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
