"""The model-generic path (`models.cartpole`, a custom ODE through
`rti_step`'s jacfwd linearization) vs the JAX package's, float64 on the
CPU, `cartpole_ocp(N=10)` (0.2 s stages):

  * the dynamics and both equilibria to 1e-12;
  * 3 `sqp_solve` iterations from hanging (IPMConfig(iters=12)): the
    iterate and the KKT residuals to 1e-8 relative to max(1, max |JAX|);
  * `simulate` with a 2-tick delay and `trajectory_tracking`, 5 ticks
    each, every LoopResult field to 1e-8;
  * the spec carried across by `convert`, and `rti_step_batched`'s
    ValueError.

Also autograd through the jacfwd linearization (reverse over forward
mode) against central differences.  Each JAX program is jitted once and
compiled at XLA's optimization level 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import cartpole as jcp
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.runtime import closed_loop as jcl
from crazyflie_nmpc_tpu.solver import policies as jpol
from crazyflie_nmpc_tpu.solver.rti import init_rti as jinit
from crazyflie_nmpc_tpu.solver.rti import sqp_solve as jsqp
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import models as tmodels
from crazyflie_nmpc_tpu_torch.models import cartpole as tcp
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime import closed_loop as tcl
from crazyflie_nmpc_tpu_torch.solver import policies as tpol
from crazyflie_nmpc_tpu_torch.solver.rti import init_rti, sqp_solve
from _torch_shared import o0, one_torch_thread  # noqa: F401

N, TICKS, SQP_ITERS = 10, 5, 3
TOL = 1e-8


def _close(got, want, tag, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, tag
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                               err_msg=tag)


@pytest.fixture(scope="module")
def specs():
    js = jcp.cartpole_ocp(N=N)
    ts = tcp.cartpole_ocp(N=N, device="cpu")
    return js, ts


def test_exports_and_constants():
    for name in ("CP_NX", "CP_NU", "CP_NY"):
        assert getattr(tmodels, name) == getattr(jcp, name)
    assert tmodels.cartpole_ocp is tcp.cartpole_ocp
    assert tcp.STATE_NAMES == jcp.STATE_NAMES
    assert tcp.CONTROL_NAMES == jcp.CONTROL_NAMES


def test_dynamics_and_equilibria_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 4)) * np.array([1.0, 3.0, 2.0, 4.0])
    u = rng.standard_normal((7, 1)) * 30.0
    p = (tcp.CartpoleParams(), jcp.CartpoleParams())
    _close(tcp.cartpole_dynamics(p[0], torch.as_tensor(x),
                                 torch.as_tensor(u)),
           jcp.cartpole_dynamics(p[1], jnp.asarray(x), jnp.asarray(u)),
           "dynamics", 1e-12)
    zero = np.zeros(1)
    for name in ("upright_state", "downward_state"):
        xt = getattr(tcp, name)(torch.float64, device="cpu")
        xj = getattr(jcp, name)(jnp.float64)
        _close(xt, xj, name, 0.0)
        f = tcp.cartpole_dynamics(p[0], xt, torch.as_tensor(zero))
        assert float(f.abs().max()) < 1e-12, name
    assert tcp.CartpoleParams().hover_speed() == 0.0


def test_spec_matches_jax_and_carries_across(specs):
    js, ts = specs
    want = convert.leaves_from_spec(js)
    for got in (convert.leaves_from_spec(ts),
                convert.leaves_from_spec(convert.spec_from_numpy(
                    want, N, device="cpu", dtype=torch.float64))):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], k, 0.0)
    carried = convert.spec_from_numpy(want, N, device="cpu",
                                      dtype=torch.float64)
    assert carried.f is tcp.cartpole_dynamics
    assert carried.params == tcp.CartpoleParams()
    with pytest.raises(ValueError, match="cannot carry"):
        convert.leaves_from_spec(jcp.cartpole_ocp(N=N).__class__(
            **{**js.__dict__, "f": lambda p, x, u: x}))


def test_sqp_from_hanging_matches_jax(specs):
    js, ts = specs
    cfg = IPMConfig(iters=12)
    x0j = jcp.downward_state(jnp.float64)
    yref, yref_e = jnp.zeros((N, 5)), jnp.zeros((4,))

    def jrun(x0):
        return jsqp(js, jinit(js, x0), x0, yref, yref_e, iters=SQP_ITERS,
                    config=JCfg(iters=12))

    jst, jk = o0(jrun, x0j)
    x0 = tcp.downward_state(torch.float64, device="cpu")
    st, k = sqp_solve(ts, init_rti(ts, x0, device="cpu"), x0,
                      torch.zeros((N, 5), dtype=torch.float64),
                      torch.zeros((4,), dtype=torch.float64),
                      iters=SQP_ITERS, config=cfg)
    _close(st.x_traj, jst.x_traj, "x_traj")
    _close(st.u_traj, jst.u_traj, "u_traj")
    _close(k, jk, "kkt")
    assert float(st.u_traj.abs().max()) <= 80.0 + 1e-9


def test_batched_path_rejects_custom_model(specs):
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched

    _, ts = specs
    x0 = tcp.downward_state(torch.float64, device="cpu")
    st = init_rti(ts, x0[None], device="cpu")
    with pytest.raises(ValueError, match="specialized"):
        rti_step_batched(ts, st, x0[None],
                         torch.zeros((N, 5), dtype=torch.float64),
                         torch.zeros((4,), dtype=torch.float64))


@pytest.mark.parametrize("loop", ["simulate_delay2", "trajectory_tracking"])
def test_closed_loops_match_jax(specs, loop):
    """runtime.simulate with a full (ny,) regulation row and a 2-tick
    delay, and trajectory_tracking of an upright table (the JAX package's
    custom-model loops), TICKS ticks each."""
    js, ts = specs
    x0 = np.array([0.2, 0.1, 0.0, 0.0])
    if loop == "simulate_delay2":
        jcfg = jcl.LoopConfig(delay_steps=2, ipm=JCfg(iters=10))
        tcfg = tcl.LoopConfig(delay_steps=2, ipm=IPMConfig(iters=10))

        def jrun(x):
            return jcl.simulate(js, x, jpol.regulation_state(jnp.zeros(5)),
                                jnp.zeros((1, 5)), TICKS, jcfg)

        got = tcl.simulate(
            ts, torch.as_tensor(x0),
            tpol.regulation_state(torch.zeros(5, dtype=torch.float64),
                                  device="cpu"),
            torch.zeros((1, 5), dtype=torch.float64), TICKS, tcfg)
    else:
        table = np.zeros((N + TICKS, 5))
        jcfg = jcl.LoopConfig(ipm=JCfg(iters=8))
        tcfg = tcl.LoopConfig(ipm=IPMConfig(iters=8))

        def jrun(x):
            return jcl.trajectory_tracking(js, x, jnp.asarray(table),
                                           steps=TICKS, config=jcfg)

        got = tcl.trajectory_tracking(ts, torch.as_tensor(x0),
                                      torch.as_tensor(table), steps=TICKS,
                                      config=tcfg)
    want = o0(jrun, jnp.asarray(x0))
    got = convert.loop_result_to_numpy(got)
    want = convert.loop_result_to_numpy(want)
    for f in got._fields:
        _close(getattr(got, f), getattr(want, f), f"{loop} {f}")
    assert np.all(np.isfinite(got.kkt_res))


def test_gradient_through_jacfwd_linearization(specs):
    """Reverse-mode autograd through the jacfwd (forward-mode)
    linearization of the custom ODE: d(final |x|^2) / d(log W diag) of 3
    regulation ticks against central differences."""
    _, ts = specs
    from crazyflie_nmpc_tpu_torch.runtime.tuning import spec_with_diag_cost

    x0 = torch.tensor([0.2, 0.1, 0.0, 0.0], dtype=torch.float64)
    cfg = tcl.LoopConfig(ipm=IPMConfig(iters=10))
    pol = tpol.regulation_state(torch.zeros(5, dtype=torch.float64),
                                device="cpu")
    table = torch.zeros((1, 5), dtype=torch.float64)
    w0 = torch.diagonal(ts.cost.W)

    def loss(logw):
        s = spec_with_diag_cost(ts, torch.exp(logw),
                                torch.diagonal(ts.cost.W_e))
        r = tcl.simulate(s, x0, pol, table, 3, cfg)
        return (r.x[-1] ** 2).sum()

    logw = torch.log(w0).requires_grad_(True)
    g, = torch.autograd.grad(loss(logw), logw)
    h = 1e-5
    with torch.no_grad():
        fd = torch.stack([(loss(logw + h * e) - loss(logw - h * e)) / (2 * h)
                          for e in torch.eye(5, dtype=torch.float64)])
    assert float(g.abs().max()) > 1e-6
    np.testing.assert_allclose(g.numpy(), fd.numpy(), rtol=1e-5,
                               atol=1e-6 * float(fd.abs().max()))
