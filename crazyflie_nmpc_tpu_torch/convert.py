"""Carry a problem, a QP and a warm start across from numpy arrays.

The JAX package's `OCPSpec`, `QPData` and `RTIState` leaves (batched or
single-instance), taken out with `np.asarray`, become the port's objects,
so both packages solve the same problem.  This module imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams
from crazyflie_nmpc_tpu_torch.ops.qp import QPData
from crazyflie_nmpc_tpu_torch.solver.ocp import CostSpec, OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import RTIState

PARAM_KEYS = ("g0", "mq", "Ixx", "Iyy", "Izz", "Cd", "Ct", "l")
COST_KEYS = ("W", "Vx", "Vu", "W_e", "Vx_e")
QP_KEYS = tuple(f.name for f in dataclasses.fields(QPData))


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.array(v)


def leaves_from_spec(spec) -> dict:
    """numpy copies of the leaves `spec_from_numpy` takes, read by
    attribute from any OCPSpec-like object (this package's or the JAX
    package's, whose arrays convert with `np.asarray`)."""
    leaves = {k: _np(getattr(spec.params, k)) for k in PARAM_KEYS}
    leaves.update({k: _np(getattr(spec.cost, k)) for k in COST_KEYS})
    leaves.update(lbu=_np(spec.lbu), ubu=_np(spec.ubu), tf=_np(spec.tf))
    return leaves


def spec_from_numpy(leaves: dict, N: int, *, device=None,
                    dtype=torch.float32, sim_steps: int = 1) -> OCPSpec:
    """`OCPSpec` from numpy leaves: the eight physical parameters (scalars),
    W, Vx, Vu, W_e, Vx_e, lbu, ubu and tf."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev).to(dtype)  # noqa: E731
    missing = set(PARAM_KEYS + COST_KEYS + ("lbu", "ubu", "tf")) - set(leaves)
    if missing:
        raise KeyError(f"spec_from_numpy: missing leaves {sorted(missing)}")
    params = QuadrotorParams(**{k: float(leaves[k]) for k in PARAM_KEYS})
    cost = CostSpec(**{k: t(leaves[k]) for k in COST_KEYS})
    return OCPSpec(params=params, cost=cost, lbu=t(leaves["lbu"]),
                   ubu=t(leaves["ubu"]), tf=t(leaves["tf"]).reshape(()),
                   N=N, sim_steps=sim_steps)


def state_from_numpy(x_traj, u_traj, *, device=None,
                     dtype=torch.float32) -> RTIState:
    """`RTIState` from numpy trajectories, in the layout they come in."""
    dev = resolve_device(device)
    return RTIState(
        x_traj=torch.as_tensor(np.array(x_traj), device=dev).to(dtype),
        u_traj=torch.as_tensor(np.array(u_traj), device=dev).to(dtype))


def leaves_from_qp(qp) -> dict:
    """numpy copies of a QPData-like object's 13 fields (this package's or
    the JAX package's), read by attribute."""
    return {k: _np(getattr(qp, k)) for k in QP_KEYS}


def qp_from_numpy(leaves: dict, *, device=None,
                  dtype=torch.float32) -> QPData:
    """`QPData` from numpy leaves (`leaves_from_qp`), infinite bounds
    kept."""
    dev = resolve_device(device)
    return QPData(**{k: torch.as_tensor(np.array(leaves[k]), device=dev)
                     .to(dtype) for k in QP_KEYS})
