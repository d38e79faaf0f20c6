"""The port's production loops, tick by tick, against the shared-nothing
numpy oracle `tests/_reference_rti.py` (the loops of
tests/test_certification.py on the port): float64, N=50, each tick's
post-step u-plan within 1e-4 of the oracle's exact RTI step.

  * hover from 0.3 m, saturating, 24 ticks, IPMConfig(iters=8,
    escalate_iters=16), on `rti_step`; the plain 8-iteration solve is off
    by more than 1e-2 on one of the first saturating ticks, so the bar
    sees a wrong plan;
  * the helix, IPMConfig(iters=8), on `rti_step`: its first 48 ticks
    here (the accelerating phase; all 96 took ~56 s of this file's ~110 s
    on one CPU thread), all 96 on the card in `chip_smoke.py`'s
    [certified_loops];
  * the batched path, 5 ticks, B=3 (offsets 0.3 / 0.02 / -0.25 m),
    IPMConfig(iters=8, escalate_iters=16, escalate_capacity=4), on
    `rti_step_batched`.
"""

import numpy as np
import pytest
import torch

import _reference_rti as oracle
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import dynamics, hover_state
from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.solver.rti import rti_step
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from crazyflie_nmpc_tpu_torch.utils.trajectories import helix_trajectory
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-4
HOVER_TICKS = 24
HELIX_TICKS = 48          # of the JAX test's 96 (the card runs all 96)
BATCHED_TICKS = 5
PLAIN_TICKS = 3           # the plain solve is held on the first ticks


@pytest.fixture(scope="module")
def spec():
    return ts.default_ocp(dtype=torch.float64, device="cpu")


def _oracle_plan(spec, prev, x, yref, yref_e):
    _, u_ref = oracle.rti_step_ref(prev.x_traj.numpy(), prev.u_traj.numpy(),
                                   x.numpy(), yref.numpy(), yref_e.numpy(),
                                   float(spec.dt))
    return u_ref


def _certify_loop(spec, x_init, yref_fn, ticks, cfg, plain_ticks=0):
    """The production closed loop; every tick the oracle solves the SAME
    subproblem (same warm start, x0 and yref) and the post-step plans are
    compared.  Returns (per-tick errors, the plain 8-iteration solve's
    errors on the first `plain_ticks` ticks)."""
    state = ts.init_rti(spec, x_init, device="cpu")
    x = x_init
    errs, plain = [], []
    for t in range(ticks):
        yref, yref_e = yref_fn(t)
        prev = state
        state, out = rti_step(spec, prev, x, yref, yref_e, cfg)
        u_ref = _oracle_plan(spec, prev, x, yref, yref_e)
        errs.append(float(np.abs(out.u_plan.numpy() - u_ref).max()))
        if t < plain_ticks:
            _, p = rti_step(spec, prev, x, yref, yref_e, IPMConfig(iters=8))
            plain.append(float(np.abs(p.u_plan.numpy() - u_ref).max()))
        x = integrate(dynamics, spec.params, x, out.u0, spec.dt,
                      spec.sim_steps)
    return errs, plain


def test_certified_hover_loop_saturating(spec):
    x0 = hover_state(spec.params, dtype=torch.float64, device="cpu").clone()
    x0[0] = 0.3
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    errs, plain = _certify_loop(
        spec, x0, lambda t: (yref, yref_e), HOVER_TICKS,
        IPMConfig(iters=8, escalate_iters=16), plain_ticks=PLAIN_TICKS)
    assert max(errs) < TOL, errs
    # the saturating transient is the regime escalation exists for
    assert max(plain) > 1e-2, plain


def test_certified_helix_loop(spec):
    table = helix_trajectory(spec.params, device="cpu")

    def yref_fn(t):
        idx = torch.clamp(t + torch.arange(spec.N + 1), 0,
                          table.shape[0] - 1)
        win = table[idx]
        return win[:-1], win[-1, :13]

    errs, _ = _certify_loop(spec, table[0, :13], yref_fn, HELIX_TICKS,
                            IPMConfig(iters=8))
    assert max(errs) < TOL, errs


def test_certified_batched_path(spec):
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    cfg = IPMConfig(iters=8, escalate_iters=16, escalate_capacity=4)
    x = hover_state(spec.params, dtype=torch.float64,
                    device="cpu").repeat(3, 1)
    x[:, 0] = torch.tensor([0.3, 0.02, -0.25], dtype=torch.float64)
    states = ts.init_rti(spec, x, device="cpu")
    errs = []
    for _ in range(BATCHED_TICKS):
        prev = states
        states, out = rti_step_batched(spec, prev, x, yref, yref_e, cfg)
        for b in range(3):
            lane = ts.RTIState(x_traj=prev.x_traj[b], u_traj=prev.u_traj[b])
            u_ref = _oracle_plan(spec, lane, x[b], yref, yref_e)
            errs.append(float(np.abs(out.u_plan[b].numpy() - u_ref).max()))
        x = integrate(dynamics, spec.params, x, out.u0, spec.dt,
                      spec.sim_steps)
    assert max(errs) < TOL, errs
