"""Carry a problem, a QP, a warm start and a closed loop's settings and
state across from numpy arrays.

The JAX package's `OCPSpec` (the quadrotor's, or the cart-pole's custom
ODE), `QPData` and `RTIState` leaves (batched or single-instance), its
`AttitudeGains`, `EstimatorState`, `LoopConfig` and the PID
controller's `PIDGains` and `PIDState`, taken out with `np.asarray` (or read by attribute), become the port's
objects, so both packages solve the same problem; `loop_result_to_numpy`
brings a closed loop's result back.  This module imports nothing of the
JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.estimator.lpf import VelocityLPFState
from crazyflie_nmpc_tpu_torch.estimator.pipeline import EstimatorState
from crazyflie_nmpc_tpu_torch.models.cartpole import (CartpoleParams,
                                                      cartpole_dynamics)
from crazyflie_nmpc_tpu_torch.models.firmware import AttitudeGains
from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.ops.qp import QPData
from crazyflie_nmpc_tpu_torch.pid import PIDGains, PIDState
from crazyflie_nmpc_tpu_torch.runtime.closed_loop import LoopConfig, LoopResult
from crazyflie_nmpc_tpu_torch.solver.ocp import CostSpec, OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import RTIState

PARAM_KEYS = ("g0", "mq", "Ixx", "Iyy", "Izz", "Cd", "Ct", "l")
# the models a spec may carry, by the name of their parameter class:
# (parameter class, its fields, the custom ODE `spec.f` or None)
MODELS = {
    "QuadrotorParams": (QuadrotorParams, PARAM_KEYS, None),
    "CartpoleParams": (CartpoleParams, ("g0", "M", "m", "l"),
                       cartpole_dynamics),
}
COST_KEYS = ("W", "Vx", "Vu", "W_e", "Vx_e")
QP_KEYS = tuple(f.name for f in dataclasses.fields(QPData))
GAIN_KEYS = tuple(f.name for f in dataclasses.fields(AttitudeGains))
LPF_KEYS = tuple(f.name for f in dataclasses.fields(VelocityLPFState))
IPM_KEYS = tuple(f.name for f in dataclasses.fields(IPMConfig))
PID_GAIN_KEYS = tuple(f.name for f in dataclasses.fields(PIDGains))
PID_STATE_KEYS = tuple(f.name for f in dataclasses.fields(PIDState))
LOOP_KEYS = tuple(f.name for f in dataclasses.fields(LoopConfig)
                  if f.name != "ipm")


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    return np.array(v)


def leaves_from_spec(spec) -> dict:
    """numpy copies of the leaves `spec_from_numpy` takes, read by
    attribute from any OCPSpec-like object (this package's or the JAX
    package's, whose arrays convert with `np.asarray`): the model's
    physical parameters (`MODELS`), the cost, the bounds, tf and u_ss
    where set.  A custom ODE is carried as its model's: it must be the
    model's own (`cartpole_dynamics`), else ValueError."""
    model = type(spec.params).__name__
    if model not in MODELS:
        raise ValueError(f"leaves_from_spec: unknown model {model!r}; "
                         f"have {sorted(MODELS)}")
    _, keys, f = MODELS[model]
    f_name = getattr(spec.f, "__name__", None)
    if f_name != getattr(f, "__name__", None):
        raise ValueError(f"leaves_from_spec: cannot carry the ODE "
                         f"{f_name!r} of a {model} spec")
    leaves = {k: _np(getattr(spec.params, k)) for k in keys}
    leaves.update({k: _np(getattr(spec.cost, k)) for k in COST_KEYS})
    leaves.update(lbu=_np(spec.lbu), ubu=_np(spec.ubu), tf=_np(spec.tf))
    if spec.u_ss is not None:
        leaves["u_ss"] = _np(spec.u_ss)
    return leaves


def spec_from_numpy(leaves: dict, N: int, *, device=None,
                    dtype=torch.float32, sim_steps: int = 1) -> OCPSpec:
    """`OCPSpec` from numpy leaves: a model's physical parameters
    (scalars: the quadrotor's eight, or the first model of `MODELS` whose
    fields are all there, with its ODE), W, Vx, Vu, W_e, Vx_e, lbu, ubu,
    tf and, if given, u_ss."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.array(a), device=dev).to(dtype)  # noqa: E731
    cls, keys, f = next((m for m in MODELS.values()
                         if set(m[1]) <= set(leaves)),
                        MODELS["QuadrotorParams"])
    missing = set(keys + COST_KEYS + ("lbu", "ubu", "tf")) - set(leaves)
    if missing:
        raise KeyError(f"spec_from_numpy: missing leaves {sorted(missing)}")
    params = cls(**{k: float(leaves[k]) for k in keys})
    cost = CostSpec(**{k: t(leaves[k]) for k in COST_KEYS})
    u_ss = t(leaves["u_ss"]) if "u_ss" in leaves else None
    return OCPSpec(params=params, cost=cost, lbu=t(leaves["lbu"]),
                   ubu=t(leaves["ubu"]), tf=t(leaves["tf"]).reshape(()),
                   N=N, sim_steps=sim_steps, f=f, u_ss=u_ss)


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


def _tensor(v, dev, dtype):
    return torch.as_tensor(np.array(v), device=dev).to(dtype)


def leaves_from_gains(gains) -> dict:
    """An AttitudeGains-like object's four gains: Python numbers stay
    numbers (a Python 0.0 `tau_m` means no motor lag), arrays become numpy
    copies (an array selects the lag branch whatever it holds)."""
    return {k: (v if isinstance(v, (int, float)) else _np(v))
            for k, v in ((k, getattr(gains, k)) for k in GAIN_KEYS)}


def gains_from_numpy(leaves: dict, *, device=None,
                     dtype=torch.float32) -> AttitudeGains:
    """`AttitudeGains` from `leaves_from_gains`: numbers kept, arrays as
    tensors on the device."""
    dev = resolve_device(device)
    return AttitudeGains(**{
        k: (v if isinstance(v, (int, float)) else _tensor(v, dev, dtype))
        for k, v in leaves.items()})


def leaves_from_estimator_state(state) -> dict:
    """numpy copies of an EstimatorState-like object's leaves: the LPF's
    p_prev, v_prev, v_prev2, elapsed and last_u."""
    leaves = {k: _np(getattr(state.lpf, k)) for k in LPF_KEYS}
    leaves["last_u"] = _np(state.last_u)
    return leaves


def estimator_state_from_numpy(leaves: dict, *, device=None,
                               dtype=torch.float32) -> EstimatorState:
    """`EstimatorState` (with its `VelocityLPFState`) from numpy leaves."""
    dev = resolve_device(device)
    lpf = VelocityLPFState(**{k: _tensor(leaves[k], dev, dtype)
                              for k in LPF_KEYS})
    return EstimatorState(lpf=lpf,
                          last_u=_tensor(leaves["last_u"], dev, dtype))


def leaves_from_loop_config(config) -> dict:
    """A LoopConfig-like object's settings, its IPMConfig as a dict."""
    leaves = {k: getattr(config, k) for k in LOOP_KEYS}
    leaves["ipm"] = {k: getattr(config.ipm, k) for k in IPM_KEYS}
    return leaves


def loop_config_from_numpy(leaves: dict) -> LoopConfig:
    """`LoopConfig` with its `IPMConfig` from `leaves_from_loop_config`."""
    kw = {k: v for k, v in leaves.items() if k != "ipm"}
    return LoopConfig(ipm=IPMConfig(**leaves["ipm"]), **kw)


def loop_result_to_numpy(res) -> LoopResult:
    """A LoopResult (this package's or the JAX package's) with numpy
    arrays: x, u, u_cmd, kkt_res, policy_mode."""
    return LoopResult(*(_np(getattr(res, k)) for k in LoopResult._fields))


def pid_gains(gains, *, device=None, dtype=None) -> PIDGains:
    """The port's `PIDGains` from a PIDGains-like object (the JAX
    package's, its arrays read with `np.asarray`), in `dtype` (None: the
    arrays' own) on `device` (None: the card)."""
    dev = resolve_device(device)
    return PIDGains(**{k: torch.as_tensor(_np(getattr(gains, k)),
                                          dtype=dtype, device=dev)
                       for k in PID_GAIN_KEYS})


def pid_state(state, *, device=None, dtype=None) -> PIDState:
    """The port's `PIDState` from a PIDState-like object (read by
    attribute): the float leaves in `dtype` (None: their own), `mode` a
    0-d int32 tensor, all on `device` (None: the card)."""
    dev = resolve_device(device)
    leaves = {k: _np(getattr(state, k)) for k in PID_STATE_KEYS}
    out = {k: torch.as_tensor(v, dtype=dtype, device=dev)
           for k, v in leaves.items()}
    out["mode"] = torch.as_tensor(leaves["mode"], dtype=torch.int32,
                                  device=dev).reshape(())
    return PIDState(**out)
