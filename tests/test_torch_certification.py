"""The port's certified batched step vs the shared-nothing numpy oracle.

`tests/_reference_rti.py` solves each RTI subproblem exactly (dense KKT,
active set).  On the 1.5 m bang-bang transient (tools/bangbang_cert.py)
the plain 8-iteration solve is off by kRPM on the active-set-discovery
ticks; `certified_config` (escalation to 32 iterations) must match the
oracle to 1e-4 at every tick, as the JAX package's does
(tests/test_certification.py).  float64, N=50, on the CPU.
"""

import numpy as np
import torch

import _reference_rti as oracle
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import dynamics, hover_state
from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-4


def test_certified_step_matches_oracle_on_the_bang_bang_transient():
    spec = ts.default_ocp(dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x = hover_state(spec.params, dtype=torch.float64, device="cpu")[None]
    x[:, 0] = 1.5
    st = ts.init_rti(spec, x, device="cpu")
    worst_cert, worst_plain = 0.0, 0.0
    for _ in range(2):
        prev = st
        st, out = rti_step_batched(spec, prev, x, yref, yref_e,
                                   certified_config(capacity=1))
        _, plain = rti_step_batched(spec, prev, x, yref, yref_e,
                                    IPMConfig(iters=8))
        _, u_ref = oracle.rti_step_ref(
            prev.x_traj[0].numpy(), prev.u_traj[0].numpy(), x[0].numpy(),
            yref.numpy(), yref_e.numpy(), float(spec.dt))
        worst_cert = max(worst_cert,
                         float(np.abs(out.u_plan[0].numpy() - u_ref).max()))
        worst_plain = max(worst_plain, float(
            np.abs(plain.u_plan[0].numpy() - u_ref).max()))
        x = rk4_step(dynamics, spec.params, x, out.u0, spec.dt)
    assert worst_cert < TOL, worst_cert
    # the transient is the regime escalation exists for
    assert worst_plain > 1e-2, worst_plain
