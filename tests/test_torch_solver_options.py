"""The port's remaining solver options vs the JAX package's (float64, B=8,
the Pallas kernels in interpret mode with one stage per grid step).

Kernel level, on the same numpy inputs: the split uncondensed sweeps
`backward_sweep`, `forward_sweep`, `backward_vector_sweep` (N=9); the
bfloat16-stream forms of `kkt_sweep_c2` / `corrector_sweep_c2` (N=10,
bf16 gains and the deviation-coded bf16 stage stream together); the
order-2 VDE forms of `prep_sweep` (N=9) and `prep_condense2` (N=10).
Solver level: `solve_batched(fused=False)`; Gondzio correctors on the four
sweep forms; each of the three compress combinations, with the guards and
stats.  Path level: two chained throughput-mode steps (bf16 streams and
the order-2 VDE) at N=10.

The JAX side of a case is lowered and compiled once, at XLA's
optimization level 0, in this process, when a test first needs it
(`jax_side`).  JAX programs that compute the same thing are compiled
once.  With Gondzio correctors `fused_iter=True` runs the
two-launch iteration, the default condense=2 program; the windowed
sweeps are the fused ones split at launch boundaries, and the split
uncondensed sweeps compute the fused ones' formulas in the same order (to
1e-12 on the port, below).  So the four sweep forms are held against two
JAX programs, the condensed and the uncondensed one.

Tolerances: 1e-12 for the plain kernels' full-precision outputs, 1e-9
(relative to max(1, max |JAX|)) for the solves and steps, as for the
port's other paths.  The bfloat16 outputs of the kernels are compared
exactly: both sides round the same float64 value through float32.  The
solves with bf16 gains are held to BF16_PRIMAL / BF16_DUAL instead: a
float64 difference of ~1e-13 between the two sides' gains can cross a
float32 rounding boundary and move one bf16 gain by a rounding step
(2^-8), which moves the primal iterate by ~1e-9 of its scale and, through
the 1/s of an active bound, a dual by up to ~1e-3 of its scale.  The same
1e-13 perturbation of the QP moves the port's own bf16-gain solve by 2e-7
(primal) and 3e-3 (duals) at this size.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state as j_hover_state
from crazyflie_nmpc_tpu.ops import ipm_fast as jfast
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
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
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prep_tiles,
                                                         prepare_qp,
                                                         rti_step_batched)
from _torch_shared import o0, one_torch_thread  # noqa: F401

B, STEPS = 8, 2
KERNEL_TOL, TOL = 1e-12, 1e-9
BF16_PRIMAL, BF16_DUAL = 1e-6, 2e-2
KERN = dict(block_b=B, stages_per_step=1, interpret=True)
PREP_OUT = ("A", "B", "c", "qx", "ru", "lb", "ub")
CND_OUT = ("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar", "rbar",
           "Ae", "Be", "c", "lb", "ub")
KKT_OUT = ("K", "kff", "L", "Pc", "dx", "du")
GAINS = ("K", "L", "Pc")
RTI_FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")
SOLVE_FIELDS = ("dx", "du", "lam_l", "lam_u", "mu", "res_stat", "res_eq")
DUALS = ("lam_l", "lam_u")
THROUGHPUT = dict(iters=8, compress_gains=True, compress_ab=True)
# (condense, the port's solve_batched options, the JAX program held
# against) of the four sweep forms; the condensed fused form with
# fused_iter=True, which Gondzio correctors turn into the two-launch
# iteration, JAX's "c2" program
SWEEP_FORMS = {
    "c2_fused": (2, dict(condense=2, fused_iter=True), "c2"),
    "c2_windowed": (2, dict(condense=2, windowed=True), "c2"),
    "uncondensed_fused": (1, {}, "uncondensed"),
    "uncondensed_split": (1, dict(fused=False), "uncondensed")}
GONDZIO = dict(iters=5, gondzio_correctors=2)
# the JAX programs of the Gondzio cases: (condense, solve_batched options)
GONDZIO_JAX = {"c2": (2, dict(condense=2)), "uncondensed": (1, {})}
COMPRESS = {"gains": dict(compress_gains=True),
            "ab": dict(compress_ab=True),
            "gains_ab": dict(compress_gains=True, compress_ab=True)}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    """A JAX, numpy or torch array as float64 numpy (bf16 upcast exactly)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, dtype=np.float64)


def _close(got, want, tol, name=""):
    """To tol relative to max(1, max |want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=name)


def _field(sol, name):
    if isinstance(sol, dict):
        return sol[name]
    return sol.stats[name] if name in sol.stats else getattr(sol, name)


def _x0s(N, rng):
    """Hover plus noise, three lanes 1 m / -0.6 m / 0.4 m off in x (they
    saturate the rotors)."""
    x0s = (np.asarray(j_hover_state(default_ocp(N=N).params,
                                    dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    x0s[:3, 0] += np.array([1.0, -0.6, 0.4])
    return x0s


def _prep_inputs(N, rng):
    """The preparation's inputs at horizon N: perturbed hover
    trajectories (float64 torch tensors)."""
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, _ = ts.hover_yref(spec, device="cpu")
    st = ts.init_rti(spec, torch.as_tensor(_x0s(N, rng)), device="cpu")
    x = st.x_traj.movedim(0, -1).contiguous()
    u = (st.u_traj.movedim(0, -1) + 0.3 * torch.as_tensor(
        rng.standard_normal((N, 4, B)))).contiguous()
    return (x, u, yref[:, :, None].expand(N, 17, B).contiguous()) + \
        prep_tiles(spec, B, torch.float64, "cpu")


def _qp(N, seed, fused_condense):
    """A batch-last QP from the port's plain preparation (float64), as
    numpy arrays for both sides."""
    rng = np.random.default_rng(seed)
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = torch.as_tensor(_x0s(N, rng))
    st = ts.init_rti(spec, x0s, device="cpu")
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False,
                          fused_condense=fused_condense)
    return {k: v.numpy().copy() for k, v in qp.items()}


# --- the JAX side ------------------------------------------------------------

def _host(tree):
    """JAX outputs as numpy, bfloat16 as float32 (exact)."""
    def one(a):
        a = jnp.asarray(a)
        return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                          else a)
    return jax.tree.map(one, tree)


def _j_prep(k7, k1):
    return (o0(lambda *a: jpk.prep_sweep(*a, **KERN, vde_order=2), *k7),
            o0(lambda *a: jpk.prep_condense2(
                *a, block_b=B, pairs_per_step=1, interpret=True,
                vde_order=2), *k1))


def _j_k9(k9b, dx0, ru_v):
    A, Bm, c, _, qx, _, _, _, p_term = k9b
    K, kff, L, Pc = o0(lambda *a: jrk.backward_sweep(*a, **KERN), *k9b)
    fwd = o0(lambda *a: jrk.forward_sweep(*a, **KERN), A, Bm, c, K, kff,
               dx0)
    vec = o0(lambda *a: jrk.backward_vector_sweep(*a, **KERN), A, Bm, qx,
               ru_v, K, L, Pc, p_term)
    return (K, kff, L, Pc), fwd, (vec,)


def _j_bf16(stream, rest, k3):
    stream = [jnp.asarray(a, jnp.bfloat16) for a in stream]
    k2 = o0(lambda *a: jck.kkt_sweep_c2(
        *a, **KERN, gains_dtype=jnp.bfloat16, a_dev=True), *stream, *rest)
    qx, ru, p_term, dx0 = k3
    k3 = o0(lambda *a: jck.corrector_sweep_c2(*a, **KERN, a_dev=True),
              *stream, qx, ru, k2[0], k2[2], k2[3], p_term, dx0)
    return k2, k3


def _j_solve(qp, cfg, kw):
    sol = o0(lambda q: jfast.solve_batched(q, JCfg(**cfg), **KERN, **kw),
               qp)
    return dict(sol.stats, dx=sol.dx, du=sol.du, lam_l=sol.lam_l,
                lam_u=sol.lam_u)


def _j_throughput(x0s):
    jspec = default_ocp(N=10, dtype=jnp.float64)
    yref, yref_e = hover_yref(jspec)
    x = jnp.asarray(x0s)
    st = jax.vmap(lambda x: init_rti(jspec, x))(x)
    step = jax.jit(lambda s, x: j_step(
        jspec, s, x, yref, yref_e, JCfg(**THROUGHPUT), block_b=B,
        stages_per_step=1, prep_stages_per_step=1, interpret=True,
        prep_vde_order=2)).lower(st, x).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    runs = []
    for _ in range(STEPS):
        st, out = step(st, x)
        runs.append((dict(x_traj=st.x_traj, u_traj=st.u_traj),
                     {f: getattr(out, f) for f in RTI_FIELDS}))
    return runs


_JAX_CASES = {"prep": _j_prep, "k9": _j_k9, "bf16": _j_bf16,
              "solve": _j_solve, "throughput": _j_throughput}


def _bf16(t):
    """A float64 torch tensor rounded to bfloat16, and its values as
    float32 numpy (exact) for the JAX side."""
    t = t.to(torch.bfloat16)
    return t, t.float().numpy()


@pytest.fixture(scope="module")
def cases():
    """Every case's inputs (numpy, from seeds) and the port's side where
    it needs no JAX output: {case: (port side, JAX kind, JAX args)}."""
    rng = np.random.default_rng(41)
    out = {}
    k7 = _prep_inputs(9, rng)
    k1 = _prep_inputs(10, rng)
    tcnd, *trest = tpk.prep_condense2(*k1, vde_order=2)
    out["prep"] = ((tpk.prep_sweep(*k7, vde_order=2),
                    [tcnd[k] for k in CND_OUT[:8]] + trest), "prep",
                   (tuple(a.numpy() for a in k7),
                    tuple(a.numpy() for a in k1)))

    # K9 on the N=9 order-4 stage data plus a barrier shift
    A, Bm, c, qx, ru, _, _ = (t.numpy() for t in tpk.prep_sweep_ref(*k7))
    W = np.diagonal(ts.default_ocp(device="cpu", dtype=torch.float64)
                    .cost.W.numpy())
    pT = np.broadcast_to(50.0 * W[:13, None], (13, B)).copy()
    p_term = 0.1 * rng.standard_normal((13, B))
    dx0 = 0.01 * rng.standard_normal((13, B))
    k9b = (A, Bm, c, np.broadcast_to(W[None, :13, None], (9, 13, B)).copy(),
           qx, W[None, 13:, None] + rng.uniform(0.01, 1.0, (9, 4, B)), ru,
           pT, p_term)
    out["k9"] = (None, "k9", (k9b, dx0,
                              ru + 0.1 * rng.standard_normal((9, 4, B))))

    # the bf16 forms of K2/K3 on the N=10 condensed data: bf16 gains and
    # the deviation-coded bf16 stream (Abar - I, Bbar, cbar) together
    cnd = tpk.prep_condense2_ref(*k1)[0]
    eye = torch.eye(13, dtype=torch.float64)[:, :, None]
    stream = [_bf16(t) for t in (cnd["Abar"] - eye, cnd["Bbar"],
                                 cnd["cbar"])]
    rest = (cnd["Qbar"], cnd["S1T"], cnd["R00"], cnd["qbar"],
            torch.as_tensor(np.tile(W[13:], 2)[None, :, None]
                            + rng.uniform(0.01, 1.0, (5, 8, B))),
            cnd["rbar"], torch.as_tensor(pT), torch.as_tensor(p_term),
            torch.as_tensor(dx0))
    k3 = (cnd["qbar"], cnd["rbar"] + 0.1 * torch.as_tensor(
        rng.standard_normal((5, 8, B))), torch.as_tensor(p_term),
        torch.as_tensor(dx0))
    tk2 = tck.kkt_sweep_c2(*(t for t, _ in stream), *rest,
                           gains_dtype=torch.bfloat16, a_dev=True)
    out["bf16"] = ((stream, rest, k3, tk2), "bf16",
                   ([a for _, a in stream], [t.numpy() for t in rest],
                    [t.numpy() for t in k3]))

    # solve_batched on the uncondensed QP at N=9 and the precondensed one
    # at N=10
    qps = {1: _qp(9, 2, fused_condense=False),
           2: _qp(10, 3, fused_condense=True)}
    out["qps"] = (qps, None, None)
    out["split"] = (None, "solve", (qps[1], dict(iters=8),
                                    dict(fused=False)))
    for prog, (cond, kw) in GONDZIO_JAX.items():
        out["gondzio " + prog] = (None, "solve", (qps[cond], GONDZIO, kw))
    for combo, kw in COMPRESS.items():
        out["compress " + combo] = (None, "solve", (
            qps[2], dict(iters=8, **kw), dict(condense=2)))

    rng = np.random.default_rng(12)
    x0s = (np.asarray(j_hover_state(default_ocp(N=10).params,
                                    dtype=jnp.float64))[None]
           + np.concatenate([0.3 * rng.standard_normal((B, 3)),
                             0.02 * rng.standard_normal((B, 10))], axis=1))
    out["throughput"] = (x0s, "throughput", (x0s,))
    return out


@pytest.fixture(scope="module")
def jax_side(cases):
    """jax_side(case): the case's JAX outputs as numpy, computed when a
    test first asks for them."""
    done = {}

    def get(case):
        if case not in done:
            _, kind, args = cases[case]
            done[case] = _host(_JAX_CASES[kind](*args))
        return done[case]
    return get


# --- the kernels ------------------------------------------------------------

def _kernel_pairs(cases, jax_side, kernel):
    """(names, JAX outputs, port outputs) of one kernel case."""
    if kernel == "prep_sweep vde_order=2":
        return PREP_OUT, jax_side("prep")[0], cases["prep"][0][0]
    if kernel == "prep_condense2 vde_order=2":
        jcnd, *jrest = jax_side("prep")[1]
        return (CND_OUT, [jcnd[k] for k in CND_OUT[:8]] + jrest,
                cases["prep"][0][1])
    if kernel in ("backward_sweep", "forward_sweep",
                  "backward_vector_sweep"):
        k9b, dx0, ru_v = cases["k9"][2]
        jb, jf, jv = jax_side("k9")
        A, Bm, c, _, qx, _, _, _, p_term = k9b
        K, kff, L, Pc = map(_t, jb)
        if kernel == "backward_sweep":
            return KKT_OUT[:4], jb, trk.backward_sweep(*map(_t, k9b))
        if kernel == "forward_sweep":
            return ("dx", "du"), jf, trk.forward_sweep(
                *map(_t, (A, Bm, c)), K, kff, _t(dx0))
        return ("kff",), jv, (trk.backward_vector_sweep(
            *map(_t, (A, Bm, qx, ru_v)), K, L, Pc, _t(p_term)),)
    stream, rest, k3, tk2 = cases["bf16"][0]
    jk2, jk3 = jax_side("bf16")
    if kernel == "kkt_sweep_c2 bf16":
        return KKT_OUT, jk2, tk2
    # the corrector on the JAX factorization's bf16 gains (exact in bf16)
    K, L, Pc = (_t(jk2[i]).to(torch.bfloat16) for i in (0, 2, 3))
    qx, ru, p_term, dx0 = k3
    return ("dx", "du"), jk3, tck.corrector_sweep_c2(
        *(t for t, _ in stream), qx, ru, K, L, Pc, p_term, dx0, a_dev=True)


KERNEL_CASES = ("backward_sweep", "forward_sweep", "backward_vector_sweep",
                "kkt_sweep_c2 bf16", "corrector_sweep_c2 bf16",
                "prep_sweep vde_order=2", "prep_condense2 vde_order=2")


@pytest.mark.parametrize("kernel", KERNEL_CASES)
def test_plain_kernel_form_matches_pallas(cases, jax_side, kernel):
    names, jout, tout = _kernel_pairs(cases, jax_side, kernel)
    assert len(jout) == len(tout) == len(names)
    for name, j, t in zip(names, jout, tout):
        if kernel == "kkt_sweep_c2 bf16" and name in GAINS:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)
        else:
            _close(t, j, KERNEL_TOL, name)


# --- solve_batched ----------------------------------------------------------

def _port_solve(qp, cfg, kw):
    """solve_batched on the numpy QP's CPU tensors: no kernel launched."""
    kc.reset_launch_counts()
    sol = tfast.solve_batched({k: torch.as_tensor(v) for k, v in qp.items()},
                              TCfg(**cfg), **kw)
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)
    return sol


def _assert_solutions_match(tsol, jsol, primal=TOL, dual=TOL):
    for name in SOLVE_FIELDS:
        _close(_field(tsol, name), _field(jsol, name),
               dual if name in DUALS else primal, name)


def test_split_uncondensed_solve_matches_jax(cases, jax_side):
    """solve_batched(fused=False): backward_sweep + forward_sweep, then
    backward_vector_sweep + forward_sweep per iteration, on both sides;
    no kernel launched on CPU tensors."""
    _assert_solutions_match(_port_solve(*cases["split"][2]),
                            jax_side("split"))


def test_split_uncondensed_solve_equals_the_fused_one(cases):
    """The split sweeps compute the fused ones' formulas in the same order:
    the same solution to 1e-12."""
    qp = {k: torch.as_tensor(v) for k, v in cases["qps"][0][1].items()}
    split = tfast.solve_batched(qp, TCfg(iters=8), fused=False)
    fused = tfast.solve_batched(qp, TCfg(iters=8))
    for name in SOLVE_FIELDS:
        _close(_field(split, name), _field(fused, name), KERNEL_TOL, name)


@pytest.mark.parametrize("form", SWEEP_FORMS)
def test_gondzio_correctors_match_jax(cases, jax_side, form):
    cond, kw, prog = SWEEP_FORMS[form]
    qp = cases["qps"][0][cond]
    _assert_solutions_match(_port_solve(qp, GONDZIO, kw),
                            jax_side("gondzio " + prog))


@pytest.mark.parametrize("combo", COMPRESS)
def test_compressed_streams_solve_matches_jax(cases, jax_side, combo):
    case = "compress " + combo
    tsol, jsol = _port_solve(*cases[case][2]), jax_side(case)
    if "compress_gains" in COMPRESS[combo]:
        _assert_solutions_match(tsol, jsol, BF16_PRIMAL, BF16_DUAL)
    else:
        _assert_solutions_match(tsol, jsol)
    for key, opt in (("c2_compress_gains", "compress_gains"),
                     ("c2_compress_ab", "compress_ab")):
        assert tsol.stats[key] == int(jsol[key]) == int(opt in COMPRESS[combo])


def test_compressed_streams_guards(cases):
    """windowed=True drops both compressions with a warning (stats 0);
    fused_iter=True with either raises ValueError; the escalation re-solve
    runs full precision (the escalated lanes' answer is a plain solve of
    those lanes)."""
    qp = {k: torch.as_tensor(v) for k, v in cases["qps"][0][2].items()}
    cfg = TCfg(iters=2, compress_gains=True, compress_ab=True)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        stats = tfast.solve_batched(qp, cfg, condense=2, windowed=True).stats
    assert any("compress" in str(w.message) for w in rec)
    assert stats["c2_compress_gains"] == stats["c2_compress_ab"] == 0
    assert stats["c2_windowed"] == 1
    with pytest.raises(ValueError, match="fused_iter"):
        tfast.solve_batched(qp, cfg, condense=2, fused_iter=True)
    comp = tfast.solve_batched(qp, TCfg(
        iters=2, compress_gains=True, compress_ab=True, escalate_iters=4,
        escalate_mu_tol=0.0, escalate_capacity=3), condense=2)
    lanes = comp.stats["escalated_lanes"].nonzero().squeeze(1)
    assert int(comp.stats["escalated"]) == lanes.numel() == 3
    full = tfast.solve_batched({k: v[..., lanes] for k, v in qp.items()},
                               TCfg(iters=4), condense=2)
    for name in ("du", "dx", "lam_l"):
        _close(getattr(comp, name)[..., lanes], getattr(full, name),
               KERNEL_TOL, name)


# --- the throughput-mode step ---------------------------------------------

@pytest.fixture(scope="module")
def throughput_steps(cases):
    """Two chained throughput-mode steps on the port's side."""
    x0s = cases["throughput"][0]
    jspec = default_ocp(N=10, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(jspec), 10,
                                    device="cpu", dtype=torch.float64)
    yref, yref_e = ts.hover_yref(tspec, device="cpu")
    tx = torch.as_tensor(x0s)
    st = ts.init_rti(tspec, tx, device="cpu")
    runs = []
    for _ in range(STEPS):
        st, out = rti_step_batched(tspec, st, tx, yref, yref_e,
                                   TCfg(**THROUGHPUT), prep_vde_order=2)
        runs.append((st, out))
    return runs


@pytest.mark.parametrize("step", range(STEPS))
def test_throughput_mode_step_matches_jax(throughput_steps, jax_side, step):
    """bf16 gains: held to BF16_PRIMAL (the plans, residuals and mu)."""
    tst, tout = throughput_steps[step]
    jst, jout = jax_side("throughput")[step]
    for field in RTI_FIELDS:
        _close(getattr(tout, field), jout[field], BF16_PRIMAL, field)
    _close(tst.x_traj, jst["x_traj"], BF16_PRIMAL)
    _close(tst.u_traj, jst["u_traj"], BF16_PRIMAL)
