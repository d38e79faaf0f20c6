"""The port's uncondensed path (condense=1, every odd horizon) and its
unfused preparation (fused_prep_condense=False) vs the JAX package's
(float64, B=8, the Pallas kernels in interpret mode with one stage per
grid step).

Kernel level: the plain `prep_sweep` (N=9 and 10), `condense2`, the
stride-2 `expand2` (N=10), `kkt_sweep` and `corrector_sweep` (N=9) on the
same numpy inputs.  Path level: two chained `rti_step_batched` steps at
N=9 (odd, default condense) and at N=10 with `fused_prep_condense=False`;
`solve_batched` with default arguments on one uncondensed QP; the
certified configuration's escalation at N=9.
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
from crazyflie_nmpc_tpu.ops.pallas import prep_kernel as jpk
from crazyflie_nmpc_tpu.ops.pallas import riccati_kernels as jrk
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched as j_step
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops import ipm_fast as tfast
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as tck
from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as tpk
from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as trk
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from crazyflie_nmpc_tpu_torch.ops.ipm import certified_config
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prep_tiles,
                                                         prepare_qp,
                                                         rti_step_batched)
from _torch_shared import jit_o0, one_torch_thread  # noqa: F401

B, STEPS = 8, 2
PREP_TOL, TOL = 1e-12, 1e-9
PREP_OUT = ("A", "B", "c", "qx", "ru", "lb", "ub")
CND_OUT = ("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar", "rbar")
KKT_OUT = ("K", "kff", "L", "Pc", "dx", "du")
RTI_FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")
SOLVE_FIELDS = ("dx", "du", "lam_l", "lam_u", "mu", "res_stat", "res_eq")
# (N, rti_step_batched options) of the two chained-step paths
PATHS = {"odd_N": (9, {}),
         "unfused_prep": (10, dict(fused_prep_condense=False))}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_scaled(got, want, name):
    """To TOL relative to max(1, max |want|): the solver's duals reach
    ~1e2 on saturated lanes."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * scale, err_msg=name)


def _field(sol, name):
    return sol.stats[name] if name in sol.stats else getattr(sol, name)


def _x0s(N, rng):
    """Hover plus noise, three lanes 1 m / -0.6 m / 0.4 m off in x (they
    saturate the rotors and escalate)."""
    x0s = (np.asarray(j_hover_state(default_ocp(N=N).params,
                                    dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    x0s[:3, 0] += np.array([1.0, -0.6, 0.4])
    return x0s


def _uncondensed_qp(N, seed):
    """An uncondensed batch-last QP from the port's plain `prep_sweep`
    (float64), as numpy arrays for both sides."""
    rng = np.random.default_rng(seed)
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(N, rng))
    st = ts.init_rti(spec, x0s, device="cpu")
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False,
                          fused_condense=False)
    return {k: v.numpy().copy() for k, v in qp.items()}


# --- the kernels ------------------------------------------------------------

def _prep_inputs(N, rng):
    """prep_sweep's inputs at horizon N: perturbed hover trajectories."""
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, _ = ts.hover_yref(spec, device="cpu")
    st = ts.init_rti(spec, torch.as_tensor(_x0s(N, rng)), device="cpu")
    x = st.x_traj.movedim(0, -1)
    u = st.u_traj.movedim(0, -1) + 0.3 * torch.as_tensor(
        rng.standard_normal((N, 4, B)))
    args = (x, u, yref[:, :, None].expand(N, 17, B)) + prep_tiles(
        spec, B, torch.float64, "cpu")
    return tuple(np.array(a) for a in args)


@pytest.fixture(scope="module")
def kernels():
    """Numpy inputs from a seed; each kernel run on both sides."""
    rng = np.random.default_rng(31)
    out = {}
    for N in (9, 10):
        k7 = _prep_inputs(N, rng)
        jprep = jpk.prep_sweep(*map(jnp.asarray, k7), block_b=B,
                               stages_per_step=1, interpret=True)
        tprep = tpk.prep_sweep(*map(_t, k7))
        out[f"prep_sweep N={N}"] = (dict(zip(PREP_OUT, jprep)),
                                    dict(zip(PREP_OUT, tprep)))
        out[N] = [np.array(a) for a in jprep]

    # condense2 and the stride-2 expansion on the N=10 stage data (k7 is
    # N=10's: its q_diag tile is the stage cost)
    A, Bm, c, qx, ru, _, _ = out[10]
    qxx = np.broadcast_to(k7[3][None], (10, 13, B)).copy()
    k6 = (A, Bm, c, qxx, qx, ru)
    jcnd = jck.condense2(*map(jnp.asarray, k6), block_b=B,
                         stages_per_step=1, interpret=True)
    out["condense2"] = (jcnd, tck.condense2(*map(_t, k6)))
    k4 = (A, Bm, c, 0.01 * rng.standard_normal((5, 13, B)),
          rng.standard_normal((5, 4, B)))
    out["expand2 stride 2"] = (
        dict(dxo=jck.expand2(*map(jnp.asarray, k4), block_b=B,
                             stages_per_step=1, interpret=True,
                             even_only=False)),
        dict(dxo=tck.expand2(*map(_t, k4), stride=2)))

    # the uncondensed sweeps on the N=9 stage data plus a barrier shift
    A, Bm, c, qx, ru, _, _ = out[9]
    W = np.diagonal(ts.default_ocp(device="cpu", dtype=torch.float64)
                    .cost.W.numpy())
    pT = np.broadcast_to(50.0 * W[:13, None], (13, B)).copy()
    p_term = 0.1 * rng.standard_normal((13, B))
    dx0 = 0.01 * rng.standard_normal((13, B))
    k8 = (A, Bm, c, np.broadcast_to(W[None, :13, None], (9, 13, B)).copy(),
          qx, W[None, 13:, None] + rng.uniform(0.01, 1.0, (9, 4, B)), ru,
          pT, p_term, dx0)
    jkkt = jrk.kkt_sweep(*map(jnp.asarray, k8), block_b=B,
                         stages_per_step=1, interpret=True)
    out["kkt_sweep"] = (dict(zip(KKT_OUT, jkkt)),
                        dict(zip(KKT_OUT, trk.kkt_sweep(*map(_t, k8)))))
    k8c = (A, Bm, c, qx, ru + 0.1 * rng.standard_normal((9, 4, B)),
           np.array(jkkt[0]), np.array(jkkt[2]), np.array(jkkt[3]), p_term,
           dx0)
    jcorr = jrk.corrector_sweep(*map(jnp.asarray, k8c), block_b=B,
                                stages_per_step=1, interpret=True)
    out["corrector_sweep"] = (
        dict(zip(("dx", "du"), jcorr)),
        dict(zip(("dx", "du"), trk.corrector_sweep(*map(_t, k8c)))))
    return out


KERNEL_CASES = {
    "prep_sweep N=9": (PREP_OUT, PREP_TOL),
    "prep_sweep N=10": (PREP_OUT, PREP_TOL),
    "condense2": (CND_OUT, PREP_TOL),
    "expand2 stride 2": (("dxo",), PREP_TOL),
    "kkt_sweep": (KKT_OUT, TOL),
    "corrector_sweep": (("dx", "du"), TOL),
}


@pytest.mark.parametrize("kernel", KERNEL_CASES)
def test_plain_kernel_matches_pallas(kernels, kernel):
    names, tol = KERNEL_CASES[kernel]
    jout, tout = kernels[kernel]
    for name in names:
        _close(tout[name], jout[name], tol)


def test_cholesky_packing_matches_chol4():
    """The packed 4x4 factor of the plain sweeps is the Pallas kernel's
    `_chol4` layout, [l00, l10, l20, l30, l11, l21, l31, l22, l32, l33]."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((4, 4, 6))
    Q = np.einsum("ikb,jkb->ijb", X, X) + 4 * np.eye(4)[:, :, None]
    _close(tck._chol_n(torch.as_tensor(Q), 4),
           jrk._chol4(jnp.asarray(Q)), 1e-13)


# --- the batched step -------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(PATHS))
def steps(request):
    """Two chained steps on both sides: (label, [(jax, port) per step])."""
    N, kw = PATHS[request.param]
    rng = np.random.default_rng(12)
    jspec = default_ocp(N=N, dtype=jnp.float64)
    x0s = (np.asarray(j_hover_state(jspec.params, dtype=jnp.float64))[None]
           + np.concatenate([0.3 * rng.standard_normal((B, 3)),
                             0.02 * rng.standard_normal((B, 10))], axis=1))
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(jspec), N,
                                    device="cpu", dtype=torch.float64)
    yref, yref_e = hover_yref(jspec)
    step = jit_o0(lambda s, x: j_step(
        jspec, s, x, yref, yref_e, JCfg(iters=8), block_b=B,
        stages_per_step=1, prep_stages_per_step=1, interpret=True, **kw))
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
def test_rti_step_matches_jax(steps, step):
    (jst, jout), (tst, tout) = steps[step]
    for field in RTI_FIELDS:
        _close(getattr(tout, field), getattr(jout, field))
    _close(tst.x_traj, jst.x_traj)
    _close(tst.u_traj, jst.u_traj)


def test_prep_batch_rows_selects_the_unfused_preparation():
    """prep_batch_rows > 1 (the JAX package's batch-tiled preparation)
    runs the fused_prep_condense=False path: the same result."""
    spec = ts.default_ocp(N=10, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(10, np.random.default_rng(4)))
    st = ts.init_rti(spec, x0s, device="cpu")
    outs = [rti_step_batched(spec, st, x0s, yref, yref_e, TCfg(iters=4),
                             **kw)[1]
            for kw in (dict(prep_batch_rows=2),
                       dict(fused_prep_condense=False), {})]
    for field in RTI_FIELDS:
        assert torch.equal(getattr(outs[0], field), getattr(outs[1], field))
    # and the fused launch's result to rounding
    _close(outs[0].u_plan, outs[2].u_plan)


# --- solve_batched ----------------------------------------------------------

@pytest.fixture(scope="module")
def uncondensed_qp():
    return _uncondensed_qp(9, seed=2)


def test_solve_batched_defaults_match_jax(uncondensed_qp):
    """The same call, `solve_batched(qp, cfg)` with the default condense
    (1), on one uncondensed QP in both packages (the JAX side in interpret
    mode at one lane block)."""
    jsol = jit_o0(lambda q: jfast.solve_batched(
        q, JCfg(iters=8), block_b=B, interpret=True))(
            {k: jnp.asarray(v) for k, v in uncondensed_qp.items()})
    tsol = tfast.solve_batched(
        {k: torch.as_tensor(v) for k, v in uncondensed_qp.items()},
        TCfg(iters=8))
    for name in ("dx", "du", "lam_l", "lam_u", "mu"):
        _close_scaled(_field(tsol, name), _field(jsol, name), name)
    assert not any(k.startswith("c2_") for k in tsol.stats)


def test_certified_escalation_matches_jax(uncondensed_qp):
    """certified_config at N=9 (condense=1): the escalated lanes, their
    number and every solution field as the JAX package's."""
    jsol = jit_o0(lambda q: jfast.solve_batched(
        q, j_certified(capacity=4), block_b=B, interpret=True))(
            {k: jnp.asarray(v) for k, v in uncondensed_qp.items()})
    tsol = tfast.solve_batched(
        {k: torch.as_tensor(v) for k, v in uncondensed_qp.items()},
        certified_config(capacity=4))
    n = int(tsol.stats["escalated"])
    assert n == int(jsol.stats["escalated"]) and 0 < n <= 4
    for name in SOLVE_FIELDS:
        _close_scaled(_field(tsol, name), _field(jsol, name), name)


def test_solve_batched_warm_start_duals_match_jax(uncondensed_qp):
    """lam0_l/lam0_u, clipped to >= 1e-4 on the finite bounds."""
    rng = np.random.default_rng(6)
    lam0 = [rng.uniform(-0.5, 2.0, uncondensed_qp["lb"].shape)
            for _ in range(2)]
    jsol = jit_o0(lambda q, a, b: jfast.solve_batched(
        q, JCfg(iters=3), block_b=B, interpret=True, lam0_l=a, lam0_u=b))(
            {k: jnp.asarray(v) for k, v in uncondensed_qp.items()},
            *map(jnp.asarray, lam0))
    tsol = tfast.solve_batched(
        {k: torch.as_tensor(v) for k, v in uncondensed_qp.items()},
        TCfg(iters=3), lam0_l=_t(lam0[0]), lam0_u=_t(lam0[1]))
    for name in SOLVE_FIELDS:
        _close_scaled(_field(tsol, name), _field(jsol, name), name)


def test_condense_2_on_stage_data_condenses_first(uncondensed_qp):
    """condense=2 on stage data (N even) runs condense2, the condensed
    sweeps and the stride-2 expansion: the condense=1 solution to
    rounding, no kernel launched on CPU tensors."""
    qp = {k: torch.as_tensor(v) for k, v in _uncondensed_qp(10, 3).items()}
    kc.reset_launch_counts()
    one = tfast.solve_batched(qp, TCfg(iters=8))
    two = tfast.solve_batched(qp, TCfg(iters=8), condense=2)
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)
    for name in SOLVE_FIELDS:
        _close_scaled(_field(two, name), _field(one, name), name)
    assert two.stats["c2_windowed"] == 0


def test_precondensed_data_need_condense_2():
    spec = ts.default_ocp(N=6, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(6, np.random.default_rng(1)))
    st = ts.init_rti(spec, x0s, device="cpu")
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False)
    with pytest.raises(ValueError, match="condense=2"):
        tfast.solve_batched(qp, TCfg(iters=2))
    with pytest.raises(ValueError, match="condense=2"):
        rti_step_batched(spec, st, x0s, yref, yref_e, condense=1,
                         fused_prep_condense=True)
