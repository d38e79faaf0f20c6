"""The single-instance RTI path vs the JAX package's (float64, CPU,
N=10): `rti_step` over 3 chained closed-loop ticks from a 1.2 m offset
(with and without Gondzio correctors), the certified configuration
(escalation to 32 iterations), `sqp_solve` and `as_rti_step`.  Each JAX
program is jitted once and compiled at XLA's optimization level 0, in this
process.  Tolerance 1e-9 relative to max(1, max |JAX|), as for the port's
other paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.ops.ipm import certified_config as j_certified
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver import rti as jrti
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from crazyflie_nmpc_tpu_torch.ops.ipm import certified_config as t_certified
from _torch_shared import o0, one_torch_thread  # noqa: F401

N, TICKS = 10, 3
TOL = 1e-9
RTI_FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")


def _close(got, want, name=""):
    got = got.detach().double().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _pair(sim_steps=1):
    js = default_ocp(N=N, dtype=jnp.float64, sim_steps=sim_steps)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                    device="cpu", dtype=torch.float64,
                                    sim_steps=sim_steps)
    yref, yref_e = hover_yref(js)
    return js, tspec, yref, yref_e


@pytest.fixture(scope="module")
def single():
    js, tspec, yref, yref_e = _pair()
    x0 = np.asarray(hover_state(js.params, dtype=jnp.float64))
    x0 = x0 + 0.05 * np.random.default_rng(11).standard_normal(13)
    x0[0] += 1.2
    return dict(js=js, tspec=tspec, yref=yref, yref_e=yref_e, x0=x0,
                jst=init_rti(js, jnp.asarray(x0)),
                tst=ts.init_rti(tspec, _t(x0), device="cpu"))


def _targs(s):
    return (s["tspec"], s["tst"], _t(s["x0"]), _t(s["yref"]),
            _t(s["yref_e"]))


def _cmp_out(got, want, tag):
    for f in RTI_FIELDS:
        _close(getattr(got, f), getattr(want, f), f"{tag} {f}")


@pytest.mark.parametrize("name, cfg", [
    ("iters8", dict(iters=8)),
    ("gondzio", dict(iters=5, gondzio_correctors=1))])
def test_rti_step_chain(single, name, cfg):
    """TICKS chained ticks, the plant an RK4 step of the model under u0
    between them (the same on both sides)."""
    from crazyflie_nmpc_tpu.ops.integrators import integrate as j_int
    from crazyflie_nmpc_tpu_torch.ops.integrators import integrate as t_int

    js, s = single["js"], single

    def j_tick(st, x):
        st, out = jrti.rti_step(js, st, x, s["yref"], s["yref_e"],
                                JCfg(**cfg))
        return st, out, j_int(js.ode(), js.params, x, out.u0, js.dt)

    jst, jx = s["jst"], jnp.asarray(s["x0"])
    tick = jax.jit(j_tick).lower(jst, jx).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    tspec, st, x, yref, yref_e = _targs(s)
    kc.reset_launch_counts()
    for k in range(TICKS):
        jst, jout, jx = tick(jst, jx)
        st, out = ts.rti_step(tspec, st, x, yref, yref_e, TCfg(**cfg))
        _cmp_out(out, jout, f"tick {k}")
        x = t_int(tspec.ode(), tspec.params, x, out.u0, tspec.dt)
    _close(st.x_traj, jst.x_traj, "x_traj")
    _close(st.u_traj, jst.u_traj, "u_traj")
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


def test_certified_tick(single):
    """certified_config(): 8 iterations miss the mu tolerance on the
    transient and the tick re-solves with 32, on both sides."""
    s = single
    jst, jout = o0(lambda st, x: jrti.rti_step(
        s["js"], st, x, s["yref"], s["yref_e"], j_certified()), s["jst"],
        jnp.asarray(s["x0"]))
    _, tout = ts.rti_step(*_targs(s), t_certified())
    _cmp_out(tout, jout, "certified")


def test_sqp_and_as_rti(single):
    s = single
    js = s["js"]
    jst, jk = o0(lambda st, x: jrti.sqp_solve(js, st, x, s["yref"],
                                               s["yref_e"], iters=3,
                                               config=JCfg(iters=8)),
                  s["jst"], jnp.asarray(s["x0"]))
    tspec, st, x, yref, yref_e = _targs(s)
    tst, tk = ts.sqp_solve(tspec, st, x, yref, yref_e, iters=3,
                           config=TCfg(iters=8))
    _close(tk, jk, "kkt_res")
    _close(tst.x_traj, jst.x_traj, "sqp x_traj")
    assert float(tk[-1]) < float(tk[0])

    x_pred = s["x0"] + 0.01
    jst2, jout = o0(lambda st, x, xp: jrti.as_rti_step(
        js, st, x, xp, s["yref"], s["yref_e"], JCfg(iters=8),
        prep_iters=2), s["jst"], jnp.asarray(s["x0"]), jnp.asarray(x_pred))
    tst2, tout = ts.as_rti_step(tspec, st, x, _t(x_pred), yref, yref_e,
                                TCfg(iters=8), prep_iters=2)
    _cmp_out(tout, jout, "as_rti")
    _close(tst2.u_traj, jst2.u_traj, "as_rti u_traj")
    _close(tout.x_at(4), jout.x_at(4), "x_at")
