"""The port's `rti_step_batched` vs the JAX package's (float64, N=10, B=8).

The JAX step runs its Pallas kernels in interpret mode, batch-first; the
port runs its plain versions on the CPU in both layouts.  Two chained
steps from the same warm start; every RTIOutput field and the carried
state are compared (the batch-last port results transposed back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched as j_step
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
    rti_step_batched,
    to_batch_first,
    to_batch_last,
)
from _torch_shared import one_torch_thread  # noqa: F401

N, B, STEPS = 10, 8, 2
FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(12)
    jspec = default_ocp(N=N, dtype=jnp.float64)
    x0s = (np.asarray(hover_state(jspec.params, dtype=jnp.float64))[None]
           + np.concatenate([0.3 * rng.standard_normal((B, 3)),
                             0.02 * rng.standard_normal((B, 10))], axis=1))
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(jspec), N,
                                    device="cpu", dtype=torch.float64)
    return jspec, tspec, x0s


@pytest.fixture(scope="module")
def jax_run(problem):
    jspec, _, x0s = problem
    yref, yref_e = hover_yref(jspec)
    step = jax.jit(lambda s, x: j_step(
        jspec, s, x, yref, yref_e, JCfg(iters=8), block_b=B,
        stages_per_step=2, prep_stages_per_step=1, interpret=True))
    st = jax.vmap(lambda x: init_rti(jspec, x))(jnp.asarray(x0s))
    outs = []
    for _ in range(STEPS):
        st, out = step(st, jnp.asarray(x0s))
        outs.append((st, out))
    return outs


def _port_run(problem, layout):
    _, tspec, x0s = problem
    yref, yref_e = ts.hover_yref(tspec, device="cpu")
    x = torch.as_tensor(x0s)
    st = ts.init_rti(tspec, x, device="cpu")
    if layout == "batch_last":
        st = to_batch_last(st)
    outs = []
    for _ in range(STEPS):
        st, out = rti_step_batched(tspec, st, x, yref, yref_e, TCfg(iters=8),
                                   layout=layout)
        if layout == "batch_last":
            first = lambda z: z.movedim(-1, 0)  # noqa: E731
            outs.append((to_batch_first(st), out._replace(
                u0=first(out.u0), u1=first(out.u1),
                x_plan=first(out.x_plan), u_plan=first(out.u_plan))))
        else:
            outs.append((st, out))
    return outs


@pytest.fixture(scope="module", params=["batch_first", "batch_last"])
def port_run(request, problem):
    return _port_run(problem, request.param)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("field", FIELDS)
def test_rti_step_batched_matches_jax(jax_run, port_run, step, field):
    want = np.asarray(getattr(jax_run[step][1], field))
    got = np.asarray(getattr(port_run[step][1], field))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("step", range(STEPS))
def test_carried_state_matches_jax(jax_run, port_run, step):
    jst, tst = jax_run[step][0], port_run[step][0]
    np.testing.assert_allclose(np.asarray(tst.x_traj),
                               np.asarray(jst.x_traj), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tst.u_traj),
                               np.asarray(jst.u_traj), rtol=1e-9, atol=1e-9)


def test_per_problem_reference_equals_shared(problem):
    """yref (B, N, ny) / yref_e (B, nx) tiled per lane give the shared
    reference's result exactly."""
    _, tspec, x0s = problem
    yref, yref_e = ts.hover_yref(tspec, device="cpu")
    x = torch.as_tensor(x0s)
    st = ts.init_rti(tspec, x, device="cpu")
    _, shared = rti_step_batched(tspec, st, x, yref, yref_e, TCfg(iters=4))
    _, tiled = rti_step_batched(tspec, st, x, yref.expand(B, N, 17),
                                yref_e.expand(B, 13), TCfg(iters=4))
    for field in FIELDS:
        assert torch.equal(getattr(shared, field), getattr(tiled, field))
