"""The single-instance path's modules vs the JAX package's (float64, CPU):
rotations, the analytic Jacobians, the integrators and the stage-parallel
linearization, the QP builders, the Riccati solver, the interior-point
method (Gondzio correctors, escalation, infinite bounds), partial
condensing at block sizes 2 and 5, the command outputs and the policies.

The same numpy inputs, made from a seed, go to both packages; each JAX
function is jitted once and compiled at XLA's optimization level 0.
Tolerances, relative to max(1, max |JAX|): 1e-12 for rotations,
Jacobians, integration and linearization (the same formulas in another
summation order), 1e-9 for the QP solves (eight interior-point iterations
amplify rounding through the barrier's 1/s terms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import rotations as jrot
from crazyflie_nmpc_tpu.models.quadrotor import QuadrotorParams as JParams
from crazyflie_nmpc_tpu.models.quadrotor import dynamics as jdyn
from crazyflie_nmpc_tpu.models.quadrotor import dynamics_jacobians as jjac
from crazyflie_nmpc_tpu.ops import condensing as jcond
from crazyflie_nmpc_tpu.ops import integrators as jint
from crazyflie_nmpc_tpu.ops import ipm as jipm
from crazyflie_nmpc_tpu.ops import qp as jqp
from crazyflie_nmpc_tpu.ops import riccati as jric
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver import outputs as jout
from crazyflie_nmpc_tpu.solver import policies as jpol
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch.models import rotations as trot
from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams
from crazyflie_nmpc_tpu_torch.models.quadrotor import dynamics as tdyn
from crazyflie_nmpc_tpu_torch.models.quadrotor import \
    dynamics_jacobians as tjac
from crazyflie_nmpc_tpu_torch.ops import condensing as tcond
from crazyflie_nmpc_tpu_torch.ops import integrators as tint
from crazyflie_nmpc_tpu_torch.ops import ipm as tipm
from crazyflie_nmpc_tpu_torch.ops import qp as tqp
from crazyflie_nmpc_tpu_torch.ops import riccati as tric
from crazyflie_nmpc_tpu_torch.solver import outputs as tout
from crazyflie_nmpc_tpu_torch.solver import policies as tpol
from crazyflie_nmpc_tpu_torch.solver.ocp import default_ocp as t_default_ocp
from _torch_shared import o0, one_torch_thread  # noqa: F401

N = 10
EXACT, QP_TOL = 1e-12, 1e-9


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _close(got, want, tol, name=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(5)


@pytest.fixture(scope="module")
def states(rng):
    """(x (6, 13) unit-quaternion states, u (6, 4) rotor speeds)."""
    x = 0.3 * rng.standard_normal((6, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    u = 14.0 + 2.0 * rng.standard_normal((6, 4))
    return x, u


# --- rotations --------------------------------------------------------------

ROT_UNARY = ("quat_normalize", "quat_canonicalize", "quat_to_euler",
             "euler_to_quat", "rotmat_earth_to_body", "rotmat_body_to_earth",
             "deg2rad", "rad2deg")


@pytest.mark.parametrize("name", ROT_UNARY)
def test_rotations_unary(rng, name):
    arg = rng.standard_normal((5, 3 if name == "euler_to_quat" else 4))
    want = o0(getattr(jrot, name), jnp.asarray(arg))
    _close(getattr(trot, name)(_t(arg)), want, EXACT, name)


def test_rotations_binary(rng):
    q = rng.standard_normal((5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v, b = rng.standard_normal((5, 3)), rng.standard_normal((5, 4))
    _close(trot.rotate_earth_to_body(_t(q), _t(v)),
           o0(jrot.rotate_earth_to_body, q, v), EXACT)
    _close(trot.quat_multiply(_t(q), _t(b)), o0(jrot.quat_multiply, q, b),
           EXACT)


# --- model and integrators --------------------------------------------------

def test_dynamics_jacobians(states):
    x, u = states
    jx, ju = o0(lambda x, u: jjac(JParams(), x, u), x, u)
    tx, tu = tjac(QuadrotorParams(), _t(x), _t(u))
    _close(tx, jx, EXACT, "Jx")
    _close(tu, ju, EXACT, "Ju")
    # and against forward-mode differentiation of the port's own dynamics
    Ax, Au = torch.func.vmap(torch.func.jacfwd(
        lambda x_, u_: tdyn(QuadrotorParams(), x_, u_), argnums=(0, 1)))(
            _t(x), _t(u))
    _close(tx, Ax, EXACT, "jacfwd x")
    _close(tu, Au, EXACT, "jacfwd u")


@pytest.mark.parametrize("num_steps", [1, 3])
def test_integrate_and_sensitivities(states, num_steps):
    x, u = states
    dt = 0.015
    want = o0(lambda x, u: jint.integrate(jdyn, JParams(), x, u,
                                           dt * num_steps, num_steps), x, u)
    _close(tint.integrate(tdyn, QuadrotorParams(), _t(x), _t(u),
                          dt * num_steps, num_steps), want, EXACT)
    wx, wA, wB = o0(lambda x, u: jint.step_with_sensitivities(
        jdyn, JParams(), x, u, dt, num_steps), x[0], u[0])
    gx, gA, gB = tint.step_with_sensitivities(tdyn, QuadrotorParams(),
                                              _t(x[0]), _t(u[0]), dt,
                                              num_steps)
    for g, w, name in ((gx, wx, "x"), (gA, wA, "A"), (gB, wB, "B")):
        _close(g, w, EXACT, name)


@pytest.mark.parametrize("num_steps", [1, 2])
def test_linearize_trajectory(rng, num_steps):
    """Stage-parallel jacfwd linearization of one trajectory, and of a
    batch of them (leading axes)."""
    x = np.tile(np.eye(1, 13, 3), (3, N + 1, 1)) + 0.05 * rng.standard_normal(
        (3, N + 1, 13))
    u = 14.0 + rng.standard_normal((3, N, 4))
    want = o0(jax.vmap(lambda x, u: jint.linearize_trajectory(
        jdyn, JParams(), x, u, 0.015, num_steps)), x, u)
    got = tint.linearize_trajectory(tdyn, QuadrotorParams(), _t(x), _t(u),
                                    0.015, num_steps)
    one = tint.linearize_trajectory(tdyn, QuadrotorParams(), _t(x[1]),
                                    _t(u[1]), 0.015, num_steps)
    for g, o, w, name in zip(got, one, want, ("x_next", "A", "B")):
        _close(g, w, EXACT, name)
        _close(o, np.asarray(w)[1], EXACT, name + " single")


def test_linearization_keeps_float32(states):
    """float32 in, float32 Jacobians out: the port's dynamics never
    multiplies a 0-dim tensor by a Python float, which jacfwd would
    promote to a float64 tangent; and jacfwd's float32 A/B agree with the
    float64 ones to float32 rounding."""
    x, u = states
    got = tint.linearize_trajectory(tdyn, QuadrotorParams(),
                                    _t(x).float(), _t(u[:5]).float(), 0.015)
    ref = tint.linearize_trajectory(tdyn, QuadrotorParams(), _t(x),
                                    _t(u[:5]), 0.015)
    assert [t.dtype for t in got] == [torch.float32] * 3
    u0 = _t(u[0]).float()
    raw = torch.func.jacfwd(lambda x_: tdyn(QuadrotorParams(), x_, u0))(
        _t(x[0]).float())
    assert raw.dtype == torch.float32
    for g, r in zip(got, ref):
        _close(g, r.numpy(), 1e-5)


def test_vde_linearization(rng):
    x = np.eye(1, 13, 3)[0] + 0.05 * rng.standard_normal((N + 1, 13))
    u = 14.0 + rng.standard_normal((N, 4))
    want = o0(lambda x, u: jint.linearize_trajectory_vde(JParams(), x, u,
                                                          0.015), x, u)
    got = tint.linearize_trajectory_vde(QuadrotorParams(), _t(x), _t(u),
                                        0.015)
    jac = tint.linearize_trajectory(tdyn, QuadrotorParams(), _t(x), _t(u),
                                    0.015)
    for g, j, w, name in zip(got, jac, want, ("x_next", "A", "B")):
        _close(g, w, EXACT, name)
        _close(j, g.numpy(), EXACT, name + " jacfwd vs VDE")


@pytest.mark.parametrize("sim_steps", [1, 2])
def test_init_rti_rollout(sim_steps):
    """The warm start's rollout: `sim_steps` RK4 sub-steps of dt each per
    interval, as in the JAX package (the port's earlier rollout split dt
    into sim_steps sub-steps)."""
    from crazyflie_nmpc_tpu_torch.solver import init_rti as t_init

    js = default_ocp(N=N, dtype=jnp.float64, sim_steps=sim_steps)
    x0 = np.eye(1, 13, 3)[0] + 0.1 * np.arange(13) / 13
    want = init_rti(js, jnp.asarray(x0))
    ts_ = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                  device="cpu", dtype=torch.float64,
                                  sim_steps=sim_steps)
    got = t_init(ts_, _t(x0), device="cpu")
    _close(got.x_traj, want.x_traj, EXACT, "x_traj")
    _close(got.u_traj, want.u_traj, EXACT, "u_traj")


# --- QP assembly and solvers ------------------------------------------------

@pytest.fixture(scope="module")
def problem(rng):
    """A JAX RTI QP at N=10 (1.2 m off the hover setpoint, so the lower
    bounds bind), some bounds infinite, and the port's copy."""
    js = default_ocp(N=N, dtype=jnp.float64)
    yref, yref_e = hover_yref(js)
    x0 = np.asarray(init_rti(js, jnp.zeros(13).at[3].set(1.0)).x_traj[0])
    x0 = x0 + 0.05 * rng.standard_normal(13)
    x0[0] += 1.2
    st = init_rti(js, jnp.asarray(x0))
    x_next, A, Bm = jint.linearize_trajectory(jdyn, js.params, st.x_traj,
                                              st.u_traj, js.dt)
    c = js.cost
    blocks = jqp.gauss_newton_cost_blocks(c.W, c.Vx, c.Vu, c.W_e, c.Vx_e,
                                          st.x_traj, st.u_traj, yref,
                                          yref_e)
    qp = jqp.build_qp(A, Bm, x_next, st.x_traj, st.u_traj, jnp.asarray(x0),
                      js.lbu, js.ubu, blocks)
    ub = np.array(qp.ub)
    ub[2:4, 1] = np.inf
    lb = np.array(qp.lb)
    lb[7, :] = -np.inf
    qp = dataclasses.replace(qp, lb=jnp.asarray(lb), ub=jnp.asarray(ub))
    tqp_ = convert.qp_from_numpy(convert.leaves_from_qp(qp), device="cpu",
                                 dtype=torch.float64)
    return dict(js=js, st=st, x0=x0, yref=yref, yref_e=yref_e, qp=qp,
                tqp=tqp_)


def test_qp_builders(problem):
    js, st = problem["js"], problem["st"]
    c = js.cost
    args = (c.W, c.Vx, c.Vu, c.W_e, c.Vx_e, st.x_traj, st.u_traj,
            problem["yref"], problem["yref_e"])
    want = o0(jqp.gauss_newton_cost_blocks, *args)
    got = tqp.gauss_newton_cost_blocks(*(_t(a) for a in args))
    for k in want:
        _close(got[k], want[k], EXACT, k)
    x_next, A, Bm = jint.linearize_trajectory(jdyn, js.params, st.x_traj,
                                              st.u_traj, js.dt)
    jq = jqp.build_qp(A, Bm, x_next, st.x_traj, st.u_traj,
                      jnp.asarray(problem["x0"]), js.lbu, js.ubu, want)
    tq = tqp.build_qp(_t(A), _t(Bm), _t(x_next), _t(st.x_traj),
                      _t(st.u_traj), _t(problem["x0"]), _t(js.lbu),
                      _t(js.ubu), got)
    for f in convert.QP_KEYS:
        _close(getattr(tq, f), getattr(jq, f), EXACT, f)
    assert tq.horizon == N


def test_riccati_pieces(problem):
    q, t = problem["qp"], problem["tqp"]
    Ruu = q.Ruu + 0.5 * jnp.eye(4)
    jf = o0(jric.factorize, q.A, q.B, q.Qxx, Ruu, q.S, q.P)
    tf = tric.factorize(t.A, t.B, t.Qxx, _t(Ruu), t.S, t.P)
    for g, w, name in zip(tf, jf, tf._fields):
        _close(g, w, QP_TOL, name)
    jk, jp = o0(lambda f: jric.backward_vector(f, q.A, q.B, q.qx, q.ru,
                                                q.c, q.p), jf)
    tk, tp = tric.backward_vector(tf, t.A, t.B, t.qx, t.ru, t.c, t.p)
    _close(tk, jk, QP_TOL, "k_ff")
    _close(tp, jp, QP_TOL, "p")
    jr = o0(lambda f, k: jric.forward_rollout(f, k, q.A, q.B, q.c, q.dx0),
             jf, jk)
    tr = tric.forward_rollout(tf, tk, t.A, t.B, t.c, t.dx0)
    for g, w, name in zip(tr, jr, ("dx", "du")):
        _close(g, w, QP_TOL, name)
    args = (q.A, q.B, q.c, q.Qxx, q.qx, Ruu, q.ru, q.S, q.P, q.p, q.dx0)
    for g, w in zip(tric.solve_lq(*(_t(a) for a in args)),
                    o0(jric.solve_lq, *args)):
        _close(g, w, QP_TOL, "solve_lq")


IPM_CASES = {
    "plain": dict(iters=8),
    "gondzio": dict(iters=5, gondzio_correctors=2),
    "warm_mu0": dict(iters=6, mu0_init=0.1, reg=1e-6),
    "escalated": dict(iters=3, escalate_iters=12),
}


@pytest.mark.parametrize("case", list(IPM_CASES))
def test_ipm_solve(problem, case):
    """solve (escalation included: the 3-iteration solve misses the mu
    tolerance and re-solves with 12) against the JAX package's."""
    cfg = IPM_CASES[case]
    want = o0(lambda q: jipm.solve(q, jipm.IPMConfig(**cfg)), problem["qp"])
    got = tipm.solve(problem["tqp"], tipm.IPMConfig(**cfg))
    for f in ("dx", "du", "lam_l", "lam_u"):
        _close(getattr(got, f), getattr(want, f), QP_TOL, f)
    for k, v in want.stats.items():
        _close(got.stats[k], v, QP_TOL, k)
    if case == "escalated":
        assert int(got.stats["escalated"]) == int(want.stats["escalated"])
        assert int(got.stats["escalated"]) == 1


def test_ipm_warm_duals_and_iterate(problem):
    q, t = problem["qp"], problem["tqp"]
    lam = np.full((N, 4), 0.3)
    cfg = dict(iters=4)
    want = o0(lambda q, l: jipm.solve(q, jipm.IPMConfig(**cfg), l, l), q,
               lam)
    got = tipm.solve(t, tipm.IPMConfig(**cfg), _t(lam), _t(lam))
    _close(got.du, want.du, QP_TOL, "du")
    carry_j = jipm.init_state(q)
    carry_t = tipm.init_state(t)
    for g, w in zip(carry_t, carry_j):
        _close(g, w, EXACT, "init_state")
    (cj, (aj, mj)) = o0(lambda q, c: jipm.iterate(q, jipm.IPMConfig(), c),
                         q, carry_j)
    (ct, (at, mt)) = tipm.iterate(t, tipm.IPMConfig(), carry_t)
    for g, w in zip(ct, cj):
        _close(g, w, QP_TOL, "iterate")
    _close(at, aj, QP_TOL, "alpha")
    _close(mt, mj, QP_TOL, "mu")


@pytest.mark.parametrize("block", [2, 5])
def test_condensing(problem, block):
    q, t = problem["qp"], problem["tqp"]
    jr, jm = o0(lambda q: jcond.condense(q, block), q)
    tr, tm = tcond.condense(t, block)
    for f in convert.QP_KEYS:
        _close(getattr(tr, f), getattr(jr, f), EXACT, f)
    for g, w, name in zip(tm, jm, tm._fields):
        _close(g, w, EXACT, name)
    M = N // block
    dx = np.linspace(-1, 1, (M + 1) * 13).reshape(M + 1, 13)
    v = np.linspace(0, 2, M * block * 4).reshape(M, block * 4)
    for g, w in zip(tcond.expand(tm, _t(dx), _t(v)),
                    o0(jcond.expand, jm, dx, v)):
        _close(g, w, EXACT, "expand")
    cfg = dict(iters=8)
    want = o0(lambda q: jcond.solve_partial(q, block,
                                             jipm.IPMConfig(**cfg)), q)
    got = tcond.solve_partial(t, block, tipm.IPMConfig(**cfg))
    for f in ("dx", "du", "lam_l", "lam_u"):
        _close(getattr(got, f), getattr(want, f), QP_TOL, f)
    with pytest.raises(ValueError, match="divide"):
        tcond.condense(t, 3)


# --- outputs and policies ---------------------------------------------------

def test_outputs(rng):
    u1 = 12.0 + 3.0 * rng.standard_normal((4, 4))
    x4 = rng.standard_normal((4, 13))
    for clamp in (True, False):
        want = o0(lambda u, x: jout.to_cmd_vel(u, x, clamp), u1, x4)
        got = tout.to_cmd_vel(_t(u1), _t(x4), clamp)
        for g, w, name in zip(got, want, got._fields):
            _close(g, w, EXACT, name)
    pwm = rng.uniform(0, 60000, 7)
    _close(tout.pwm2krpm(_t(pwm)), o0(jout.pwm2krpm, pwm), EXACT)
    _close(tout.krpm2pwm(_t(u1)), o0(jout.krpm2pwm, u1), EXACT)


@pytest.mark.parametrize("mode, playhead", [("regulation", 0),
                                            ("tracking", 3),
                                            ("tracking", 25),
                                            ("hold", 4)])
def test_make_yref(rng, mode, playhead):
    """Each mode, the playhead's advance and the latch to Position_Hold
    when fewer than N rows remain (a 30-row table)."""
    js = default_ocp(N=N, dtype=jnp.float64)
    ts_ = t_default_ocp(N=N, dtype=torch.float64, device="cpu")
    table = rng.standard_normal((30, 17))
    sp = (0.3, -0.2, 0.8)
    if mode == "hold":
        jst = jpol.PolicyState(mode=jnp.int32(jpol.POSITION_HOLD),
                               playhead=jnp.int32(playhead),
                               setpoint=jnp.asarray(sp))
        tst = tpol.PolicyState(mode=torch.tensor(tpol.POSITION_HOLD,
                                                 dtype=torch.int32),
                               playhead=torch.tensor(playhead,
                                                     dtype=torch.int32),
                               setpoint=_t(sp))
    else:
        make = {"regulation": "regulation_state",
                "tracking": "tracking_state"}[mode]
        jst = dataclasses.replace(getattr(jpol, make)(sp),
                                  playhead=jnp.int32(playhead))
        tst = dataclasses.replace(getattr(tpol, make)(sp, device="cpu"),
                                  playhead=torch.tensor(playhead,
                                                        dtype=torch.int32))
    jy, jye, jns = o0(lambda s, t: jpol.make_yref(js, s, t), jst, table)
    ty, tye, tns = tpol.make_yref(ts_, tst, _t(table))
    _close(ty, jy, EXACT, "yref")
    _close(tye, jye, EXACT, "yref_e")
    assert int(tns.mode) == int(jns.mode)
    assert int(tns.playhead) == int(jns.playhead)


def test_regulation_table_and_custom_setpoint():
    ts_ = t_default_ocp(N=N, dtype=torch.float64, device="cpu")
    table = tpol.regulation_table(ts_, dtype=torch.float64, device="cpu")
    assert table.shape == (1, 17)
    st = tpol.regulation_state((0.0, 0.0, 0.5), device="cpu")
    yref, yref_e, _ = tpol.make_yref(ts_, st, table)
    assert yref.shape == (N, 17) and float(yref[0, 2]) == 0.5
    custom = dataclasses.replace(ts_, f=lambda p, x, u: x)
    with pytest.raises(ValueError, match="full"):
        tpol.make_yref(custom, st, table)
