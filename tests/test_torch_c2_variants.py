"""The port's split sweeps (windowed=True) and one-launch Mehrotra
iteration (fused_iter=True) vs the JAX package's (float64, N=10, B=8).

Kernel level: the plain `kkt_sweep_c2_win`, `corrector_sweep_c2_win` and
`iter_sweep_c2` against the Pallas kernels run in interpret mode on the
same numpy inputs (for the iteration: slacks, duals, residuals and masks
with some infinite bounds, and one lane with none).  Path level: two
chained `rti_step_batched` steps with each option, and the certified
configuration with `fused_iter=True` through `solve_batched` (its
escalation re-solve runs the two-launch iteration).  Each JAX path is
jitted once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state as j_hover_state
from crazyflie_nmpc_tpu.ops import ipm_fast as jfast
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.ops.ipm import certified_config as j_certified
from crazyflie_nmpc_tpu.ops.pallas import condensed_kernels as jck
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched as j_step
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.ops import ipm_fast as tfast
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as tck
from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as tpk
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from crazyflie_nmpc_tpu_torch.ops.ipm import certified_config
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prep_tiles,
                                                         prepare_qp,
                                                         rti_step_batched)
from _torch_shared import jit_o0, one_torch_thread  # noqa: F401

N, M, B, STEPS = 10, 5, 8, 2
TOL = 1e-9
KKT_OUT = ("K", "kff", "L", "Pc", "dx", "du")
ITER_OUT = ("z_dx", "z_du", "s_l", "s_u", "lam_l", "lam_u", "qx", "r1u",
            "c_res", "r3", "r4", "r1x_T", "dx0_res", "z_dxT", "alpha", "mu")
RTI_FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")
SOLVE_FIELDS = ("dx", "du", "lam_l", "lam_u", "mu", "res_stat", "res_eq")
OPTIONS = ("fused_iter", "windowed")


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _x0s(rng):
    """Hover plus noise, three lanes 1 m / -0.6 m / 0.4 m off in x (they
    saturate the rotors and escalate)."""
    x0s = (np.asarray(j_hover_state(default_ocp(N=N).params,
                                    dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    x0s[:3, 0] += np.array([1.0, -0.6, 0.4])
    return x0s


def _port_spec():
    return ts.default_ocp(N=N, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def sweeps():
    """Numpy inputs from a seed; each kernel run on both sides."""
    rng = np.random.default_rng(21)
    spec = _port_spec()
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(rng))
    st = ts.init_rti(spec, x0s, device="cpu")
    x = st.x_traj.movedim(0, -1).contiguous()
    u = (st.u_traj.movedim(0, -1)
         + 0.3 * torch.as_tensor(rng.standard_normal((N, 4, B))))
    cnd = tpk.prep_condense2_ref(
        x, u.contiguous(), yref[:, :, None].expand(N, 17, B).contiguous(),
        *prep_tiles(spec, B, torch.float64, "cpu"))[0]
    cnd = {k: v.numpy() for k, v in cnd.items()}
    W = np.diagonal(spec.cost.W.numpy())
    pT = np.broadcast_to(50.0 * W[:13, None], (13, B)).copy()
    p_term = pT * (x[-1].numpy() - yref_e.numpy()[:, None])
    dx0 = 0.01 * rng.standard_normal((13, B))

    k5 = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["Qbar"], cnd["S1T"],
          cnd["R00"], cnd["qbar"],
          np.tile(W[13:], 2)[None, :, None]
          + rng.uniform(0.01, 1.0, (M, 8, B)),
          cnd["rbar"], pT, p_term, dx0)
    jkkt = jit_o0(lambda *a: jck.kkt_sweep_c2_win(
        *a, block_b=B, stages_per_step=1, interpret=True))(
            *map(jnp.asarray, k5))
    tkkt = tck.kkt_sweep_c2_win(*map(_t, k5))

    kc = (k5[0], k5[1], k5[2], k5[6],
          k5[8] + 0.1 * rng.standard_normal((M, 8, B)),
          np.array(jkkt[0]), np.array(jkkt[2]), np.array(jkkt[3]), p_term,
          dx0)
    jcorr = jit_o0(lambda *a: jck.corrector_sweep_c2_win(
        *a, block_b=B, stages_per_step=1, interpret=True))(
            *map(jnp.asarray, kc))
    tcorr = tck.corrector_sweep_c2_win(*map(_t, kc))

    # the iteration's carried state: finite bounds where the mask is 1
    # (lane 7 has none), s=1, lam=r3=r4=0 where it is 0
    m_l = (rng.uniform(size=(M, 8, B)) < 0.8).astype(np.float64)
    m_u = (rng.uniform(size=(M, 8, B)) < 0.8).astype(np.float64)
    m_l[..., 7] = m_u[..., 7] = 0.0
    s_l = np.where(m_l > 0, rng.uniform(0.1, 2.0, (M, 8, B)), 1.0)
    s_u = np.where(m_u > 0, rng.uniform(0.1, 2.0, (M, 8, B)), 1.0)
    lam_l = m_l * rng.uniform(0.05, 1.5, (M, 8, B))
    lam_u = m_u * rng.uniform(0.05, 1.5, (M, 8, B))
    r3 = m_l * 0.05 * rng.standard_normal((M, 8, B))
    r4 = m_u * 0.05 * rng.standard_normal((M, 8, B))
    n_fin = m_l.sum(axis=(0, 1)) + m_u.sum(axis=(0, 1))
    ki = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["Qbar"], cnd["S1T"],
          cnd["R00"], cnd["qbar"], np.broadcast_to(
              np.tile(W[13:], 2)[None, :, None], (M, 8, B)).copy(),
          cnd["rbar"] - lam_l + lam_u, s_l, s_u, lam_l, lam_u, r3, r4,
          m_l, m_u, 0.01 * rng.standard_normal((M, 13, B)),
          0.01 * rng.standard_normal((M, 8, B)), pT, p_term, dx0,
          0.01 * rng.standard_normal((13, B)))
    jiter = jit_o0(lambda *a: jck.iter_sweep_c2(
        *a, 0.995, block_b=B, stages_per_step=1, interpret=True))(
            *map(jnp.asarray, ki), jnp.asarray(np.maximum(n_fin, 1)),
            jnp.asarray(n_fin > 0))
    tin = tuple(map(_t, ki))
    titer = tck.iter_sweep_c2(
        *tin, _t(np.maximum(n_fin, 1)[None]), _t((n_fin > 0)[None] * 1.0),
        0.995, scratch=tck.iter_scratch(M, B, torch.float64, "cpu"))
    return dict(
        kkt=(dict(zip(KKT_OUT, jkkt)), dict(zip(KKT_OUT, tkkt))),
        corr=(dict(zip(("dx", "du"), jcorr)), dict(zip(("dx", "du"), tcorr))),
        iter=(dict(zip(ITER_OUT, jiter)), dict(zip(ITER_OUT, titer))),
        iter_in=tin, n_fin=n_fin)


@pytest.mark.parametrize("name", KKT_OUT)
def test_kkt_sweep_c2_win_plain_matches_pallas(sweeps, name):
    jout, tout = sweeps["kkt"]
    _close(tout[name], jout[name])


@pytest.mark.parametrize("name", ("dx", "du"))
def test_corrector_sweep_c2_win_plain_matches_pallas(sweeps, name):
    jout, tout = sweeps["corr"]
    _close(tout[name], jout[name])


@pytest.mark.parametrize("name", ITER_OUT)
def test_iter_sweep_c2_plain_matches_pallas(sweeps, name):
    jout, tout = sweeps["iter"]
    _close(tout[name], jout[name])


def test_iter_sweep_c2_updates_its_carries_in_place(sweeps):
    """The first 14 outputs are the carried inputs themselves (the Pallas
    kernel's input_output_aliases); the lane without finite bounds takes a
    full step and keeps its masked invariants."""
    _, tout = sweeps["iter"]
    tin = dict(zip(("Abar", "Bbar", "c_res", "Qbar", "S1T", "R00", "qx",
                    "ruu", "r1u", "s_l", "s_u", "lam_l", "lam_u", "r3", "r4",
                    "m_l", "m_u", "z_dx", "z_du", "pT", "r1x_T", "dx0_res",
                    "z_dxT"), sweeps["iter_in"]))
    for name in ITER_OUT[:14]:
        assert tout[name] is tin[name], name
    assert sweeps["n_fin"][7] == 0
    assert float(tout["alpha"][0, 7]) == 1.0
    assert float(tout["mu"][0, 7]) == 0.0
    for name, want in (("s_l", 1.0), ("s_u", 1.0), ("lam_l", 0.0),
                       ("lam_u", 0.0)):
        assert bool((tout[name][..., 7] == want).all()), name


# --- the batched step with each option ------------------------------------

@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(12)
    jspec = default_ocp(N=N, dtype=jnp.float64)
    x0s = (np.asarray(j_hover_state(jspec.params, dtype=jnp.float64))[None]
           + np.concatenate([0.3 * rng.standard_normal((B, 3)),
                             0.02 * rng.standard_normal((B, 10))], axis=1))
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(jspec), N,
                                    device="cpu", dtype=torch.float64)
    return jspec, tspec, x0s


@pytest.fixture(scope="module", params=OPTIONS)
def steps(request, problem):
    """Two chained steps with the option on both sides: (jax, port)."""
    jspec, tspec, x0s = problem
    kw = {request.param: True}
    yref, yref_e = hover_yref(jspec)
    step = jit_o0(lambda s, x: j_step(
        jspec, s, x, yref, yref_e, JCfg(iters=8), block_b=B,
        stages_per_step=2, prep_stages_per_step=1, interpret=True, **kw))
    jst = jax.vmap(lambda x: init_rti(jspec, x))(jnp.asarray(x0s))
    tyref, tyref_e = ts.hover_yref(tspec, device="cpu")
    tx = torch.as_tensor(x0s)
    tst = ts.init_rti(tspec, tx, device="cpu")
    runs = []
    for _ in range(STEPS):
        jst, jout = step(jst, jnp.asarray(x0s))
        tst, tout = rti_step_batched(tspec, tst, tx, tyref, tyref_e,
                                     TCfg(iters=8), **kw)
        runs.append(((jst, jout), (tst, tout)))
    return runs


@pytest.mark.parametrize("step", range(STEPS))
def test_rti_step_option_matches_jax(steps, step):
    (jst, jout), (tst, tout) = steps[step]
    for field in RTI_FIELDS:
        _close(getattr(tout, field), getattr(jout, field))
    _close(tst.x_traj, jst.x_traj)
    _close(tst.u_traj, jst.u_traj)


@pytest.fixture(scope="module")
def certified_qp():
    """A precondensed QP from the port's plain prep (float64), saturating
    lanes included, as numpy arrays for both sides."""
    rng = np.random.default_rng(9)
    spec = _port_spec()
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(rng))
    st = ts.init_rti(spec, x0s, device="cpu")
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False)
    return {k: v.numpy().copy() for k, v in qp.items()}


def test_certified_fused_iter_solve_matches_jax(certified_qp):
    """certified_config through solve_batched with fused_iter=True: the
    first pass is 8 one-launch iterations, the escalated lanes are
    re-solved by the two-launch iteration on both sides."""
    jsol = jit_o0(lambda q: jfast.solve_batched(
        q, j_certified(capacity=4), block_b=B, stages_per_step=2,
        interpret=True, condense=2, fused_iter=True))(
            {k: jnp.asarray(v) for k, v in certified_qp.items()})
    tsol = tfast.solve_batched(
        {k: torch.as_tensor(v) for k, v in certified_qp.items()},
        certified_config(capacity=4), condense=2, fused_iter=True)
    n = int(tsol.stats["escalated"])
    assert n == int(jsol.stats["escalated"]) and 0 < n <= 4
    for name in SOLVE_FIELDS:
        got = tsol.stats[name] if name in jsol.stats else getattr(tsol, name)
        want = jsol.stats[name] if name in jsol.stats else getattr(jsol, name)
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                                   atol=TOL * scale, err_msg=name)
    assert tsol.stats["c2_windowed"] == jsol.stats["c2_windowed"] == 0


@pytest.mark.parametrize("windowed, flag", [(None, 0), (False, 0),
                                            (True, 1)])
def test_stats_report_the_windowed_sweeps(certified_qp, windowed, flag):
    q = {k: torch.as_tensor(v) for k, v in certified_qp.items()}
    stats = tfast.solve_batched(q, TCfg(iters=2), condense=2,
                                windowed=windowed).stats
    assert stats["c2_windowed"] == flag
    assert stats["c2_compress_gains"] == stats["c2_compress_ab"] == 0


def test_fused_iter_with_windowed_raises(problem):
    _, tspec, x0s = problem
    yref, yref_e = ts.hover_yref(tspec, device="cpu")
    x = torch.as_tensor(x0s)
    st = ts.init_rti(tspec, x, device="cpu")
    with pytest.raises(ValueError, match="fused_iter"):
        rti_step_batched(tspec, st, x, yref, yref_e, fused_iter=True,
                         windowed=True)
    with pytest.raises(ValueError, match="fused_iter"):
        tfast.solve_batched({}, TCfg(), condense=2, fused_iter=True,
                            windowed=True)

