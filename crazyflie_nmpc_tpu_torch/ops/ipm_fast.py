"""Batch-last interior-point solver on the fused Riccati sweeps (PyTorch).

Counterpart of `crazyflie_nmpc_tpu/ops/ipm_fast.py`.  Mehrotra
predictor-corrector with exact (1 - alpha) affine-residual tracking; per
iteration one factorization sweep and one corrector sweep (and one more
corrector sweep per Gondzio corrector), with the elementwise barrier
algebra between them in plain PyTorch on the card.  The sweeps are those
of the problem's form:

  * condense=1: the uncondensed diagonal-cost sweeps `kkt_sweep` /
    `corrector_sweep` on the stage data (A, B, c, qxx, qx, ru), or with
    fused=False their split launches (`backward_sweep` + `forward_sweep`,
    `backward_vector_sweep` + `forward_sweep`);
  * condense=2: block-2 partial condensing, the condensed sweeps
    `kkt_sweep_c2` / `corrector_sweep_c2` (`windowed=True`: each as its
    two split launches; `fused_iter=True`: the whole iteration, barrier
    algebra included, in one `iter_sweep_c2` launch; compress_gains /
    compress_ab: their bfloat16-stream forms), on data precondensed by
    `prep_condense2` (the "c2*" keys) or condensed here by `condense2`;
    the expansion `expand2` recovers the eliminated states once per solve.

`solve_batched` consumes a batch-last QP dict; `from_qpdata` converts a
batch-first QPData.  All (B,) problems run in lockstep with per-lane step
lengths; infinite bounds are masked.  Per-lane escalation re-solves the worst unconverged
lanes as a sub-batch (see `solve_batched`).  A serving loop passes
`LoopGraphs` (through `solve_checked`) to replay the barrier algebra
between the sweeps from CUDA graphs.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import host_sync
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.ops.qp import QPData

_C2_KEYS = ("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar", "rbar")


class BatchSolution(NamedTuple):
    dx: Any      # (N+1, nx, B)
    du: Any      # (N, nu, B)
    lam_l: Any   # (N, nu, B)
    lam_u: Any   # (N, nu, B)
    stats: Any   # dict with (B,) entries


def from_qpdata(qp: QPData) -> dict:
    """Batch-first QPData (every field with a leading batch axis) ->
    batch-last tensor dict, as `solve_batched` takes it.

    The fused kernels exploit the reference cost structure: Qxx/Ruu/P
    diagonal, S = 0 (LLS cost with selector Vx/Vu, generate_c_code.py:
    86-107).  Only the diagonals are extracted — callers with genuinely
    dense cost blocks must use `ops.ipm` instead.
    """
    bl = lambda x: torch.movedim(x, 0, -1).contiguous()  # noqa: E731
    diag = lambda x: torch.diagonal(x, dim1=-2, dim2=-1)  # noqa: E731
    return dict(A=bl(qp.A), B=bl(qp.B), c=bl(qp.c),
                qxx=bl(diag(qp.Qxx)), qx=bl(qp.qx),
                ruu=bl(diag(qp.Ruu)), ru=bl(qp.ru),
                pT=bl(diag(qp.P)), p=bl(qp.p), lb=bl(qp.lb), ub=bl(qp.ub),
                dx0=bl(qp.dx0))


def _uses_iter(config: IPMConfig, condense: int, fused_iter) -> bool:
    """Whether the one-launch iteration runs: condense=2 and fused_iter
    without Gondzio correctors (with them the two-launch iteration runs,
    as in the JAX package)."""
    return bool(condense == 2 and fused_iter
                and config.gondzio_correctors == 0)


def check_supported(config: IPMConfig, condense: int, windowed,
                    fused_iter, fused: bool = True) -> None:
    """Raise ValueError where the JAX package does: condense not 1 or 2,
    condense=2 with fused=False, and the one-launch iteration
    (`_uses_iter`) with windowed=True (it has no split form) or with a
    compressed stream (its gains never leave the kernel).  With condense=1
    windowed, fused_iter and the compressions have no effect."""
    if condense not in (1, 2):
        raise ValueError(f"condense={condense} (1 or 2)")
    if not fused and condense == 2:
        raise ValueError("condense=2 requires the fused kernel path")
    if _uses_iter(config, condense, fused_iter):
        if windowed:
            raise ValueError("fused_iter=True requires the fused c2 sweeps; "
                             "windowed=True selects the split ones (use "
                             "fused_iter=False)")
        if config.compress_gains or config.compress_ab:
            raise ValueError("compress_gains/compress_ab are not "
                             "supported with fused_iter=True (its gains "
                             "never leave the kernel)")


def _clip(v, lo, hi):
    """jnp.clip(v, lo, hi) with (B,) bounds: max with lo, then min with
    hi."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _max_step_lane(v, dv, tau):
    """Per-lane fraction-to-boundary over every axis but the last -> (B,).
    One call on the four stacked (slack, dual) pairs gives the minimum of
    the four separate steps exactly: tau * x and the clamp are monotone."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(
        tau * torch.amin(ratio, dim=tuple(range(ratio.dim() - 1))), max=1.0)


def _compl(lam, s, fin, n_ineq):
    """Mean complementarity per lane over the finite bounds, from the
    stacked (lower, upper) duals and slacks -> (B,)."""
    p = (lam * s * fin).sum(dim=(1, 2))
    return (p[0] + p[1]) / n_ineq


# The Mehrotra iteration's barrier algebra in segments, each a function
# from the loop's state (a dict) to the entries it sets.  The lower and
# upper bounds' slacks `s`, duals `lam`, masks `fin` and residuals `r34`
# (-lb - s_l, ub - s_u) are stacked on a leading axis of 2, so each step
# is one operation on both; `sgn` (+1, -1) maps du onto each side's slack
# step (du + r3, r4 - du).  `_solve_core` runs them eagerly between the
# sweeps, or replays them from CUDA graphs (`LoopGraphs`).

def _init(inp, s_min_init, mu0_init):
    """The initial point (cf. ipm.init_state) and residuals from the QP
    data: lb0/ub0 (N, nu, B), ruu, qx, ru, cs, p_T, dx0 and optional
    warm-start duals lam0_l/lam0_u (clipped interior)."""
    lb0, ub0, cs = inp["lb0"], inp["ub0"], inp["cs"]
    dtype, dev = cs.dtype, cs.device
    N, nu, B = lb0.shape
    fin = torch.isfinite(torch.stack([lb0, ub0]))
    bnd = torch.stack([-torch.where(fin[0], lb0, 0.0),
                       torch.where(fin[1], ub0, 0.0)])
    n_fin = fin.sum(dim=(0, 1, 2))
    s = torch.where(fin, torch.clamp(bnd, min=s_min_init), 1.0)
    # scalars are filled on the device: a host-to-device copy of a fresh
    # tensor would block the host until the card's queue drains
    mu0 = torch.full((), mu0_init, dtype=dtype, device=dev)
    lam = torch.where(fin, mu0 / s, 0.0)
    warm = (inp.get("lam0_l"), inp.get("lam0_u"))
    if any(w is not None for w in warm):
        lam = torch.stack([lam[i] if w is None else torch.where(
            fin[i], torch.clamp(w, min=1e-4), 0.0)
            for i, w in enumerate(warm)])
    sgn = torch.ones((2, 1, 1, 1), dtype=dtype, device=dev)
    sgn[1] = -1.0
    return dict(
        fin=fin, s=s, lam=lam, sgn=sgn, ruu=inp["ruu"],
        n_ineq=torch.clamp(n_fin, min=1), has_ineq=n_fin > 0,
        tiny=torch.full((), torch.finfo(dtype).tiny, dtype=dtype,
                        device=dev),
        z_du=torch.zeros((N, nu, B), dtype=dtype, device=dev),
        z_dx=torch.zeros((N + 1,) + cs.shape[1:], dtype=dtype, device=dev),
        r1x=torch.cat([inp["qx"], inp["p_T"][None]], dim=0),
        r1u=inp["ru"] - lam[0] + lam[1],
        r2=torch.cat([-inp["dx0"][None], -cs], dim=0),
        r34=torch.where(fin, bnd - s, 0.0))


def _iter_pre(st):
    """Before the factorization: mu, the barrier-shifted input Hessian
    and the predictor's right-hand side."""
    fin, lam, s = st["fin"], st["lam"], st["s"]
    sig = torch.where(fin, lam / s, 0.0)
    r5 = lam * s
    rt = torch.where(fin, (r5 + lam * st["r34"]) / s, 0.0)
    return dict(mu=_compl(lam, s, fin, st["n_ineq"]),
                ruu_shift=st["ruu"] + sig[0] + sig[1], r5=r5,
                rt1u=st["r1u"] + rt[0] - rt[1], c_res=-st["r2"][1:],
                dx0_res=-st["r2"][0])


def _iter_mid(st):
    """Between the sweeps: the affine step's length and complementarity,
    the centring parameter and the corrector's right-hand side.  `ones`
    holds the (slack, dual) pairs with the masked entries at 1, the
    fraction-to-boundary operands of every step of this iteration."""
    fin, lam, s, r34, mu = st["fin"], st["lam"], st["s"], st["r34"], st["mu"]
    ds_a = torch.where(fin, st["sgn"] * st["ddu_a"] + r34, 0.0)
    dlam_a = torch.where(fin, -(st["r5"] + lam * ds_a) / s, 0.0)
    ones = torch.cat([torch.where(fin, s, 1.0), torch.where(fin, lam, 1.0)])
    alpha_aff = _max_step_lane(ones, torch.cat([ds_a, dlam_a]), 1.0)
    mu_aff = _compl(lam + alpha_aff * dlam_a, s + alpha_aff * ds_a, fin,
                    st["n_ineq"])
    sigma = torch.clamp((mu_aff / torch.maximum(mu, st["tiny"])) ** 3,
                        0.0, 1.0)
    r5_c = st["r5"] - sigma * mu + ds_a * dlam_a
    rt_c = torch.where(fin, (r5_c + lam * r34) / s, 0.0)
    return dict(ones=ones, sigma=sigma, r5_c=r5_c,
                rt1u_c=st["r1u"] + rt_c[0] - rt_c[1])


def _iter_step(st, tau):
    """After the corrector sweep: the slack and dual steps and the step
    length."""
    fin, s = st["fin"], st["s"]
    ds = torch.where(fin, st["sgn"] * st["ddu"] + st["r34"], 0.0)
    dlam = torch.where(fin, -(st["r5_c"] + st["lam"] * ds) / s, 0.0)
    return dict(ds=ds, dlam=dlam, alpha=_max_step_lane(
        st["ones"], torch.cat([ds, dlam]), tau))


def _iter_update(st, mu_floor):
    """The step taken, the residuals shrunk by (1 - alpha)."""
    fin = st["fin"]
    alpha = torch.where(st["has_ineq"] & (st["mu"] <= mu_floor), 0.0,
                        st["alpha"])
    shrink = 1.0 - alpha
    return dict(z_dx=st["z_dx"] + alpha * st["ddx"],
                z_du=st["z_du"] + alpha * st["ddu"],
                s=torch.where(fin, st["s"] + alpha * st["ds"], 1.0),
                lam=torch.where(fin, st["lam"] + alpha * st["dlam"], 0.0),
                r1x=shrink * st["r1x"], r1u=shrink * st["r1u"],
                r2=shrink * st["r2"], r34=shrink * st["r34"])


def _iter_post(st, tau, mu_floor):
    """`_iter_step` then `_iter_update` (no Gondzio corrector between)."""
    out = _iter_step(st, tau)
    return {**out, **_iter_update({**st, **out}, mu_floor)}


def _gondzio(st, corr, factors, cstream, tau):
    """One Gondzio centrality corrector: one more corrector sweep on the
    same factorization (K, L, Pc), right-hand side the pure
    complementarity outlier correction, kept per lane where the step
    lengthens.  The stored Pc = P_{k+1} c_k carries the original dynamics
    residual into the vector pass, and this solve has none, so Pc is
    zeroed (K and L do not depend on the right-hand side)."""
    K, L, Pc = factors
    fin, s, lam, sgn = st["fin"], st["s"], st["lam"], st["sgn"]
    ds, dlam, alpha = st["ds"], st["dlam"], st["alpha"]
    mu_t = st["sigma"] * st["mu"]                               # (B,)
    a_hat = torch.clamp(alpha + 0.1, max=1.0)
    v = (s + a_hat * ds) * (lam + a_hat * dlam)
    t = torch.where(fin, _clip(v, 0.1 * mu_t, 10.0 * mu_t) - v, 0.0)
    tg = torch.where(fin, (-sgn * t) / s, 0.0)
    r1x, r2 = st["r1x"], st["r2"]
    ddx_g, ddu_g = corr(
        cstream(torch.zeros_like(r2[1:])), torch.zeros_like(r1x[:-1]),
        tg[0] + tg[1], K, L, torch.zeros_like(Pc),
        torch.zeros_like(r1x[-1]), torch.zeros_like(r2[0]))
    ds_g = torch.where(fin, sgn * ddu_g, 0.0)
    dlam_g = torch.where(fin, (t - lam * ds_g) / s, 0.0)
    ds2, dlam2 = ds + ds_g, dlam + dlam_g
    alpha2 = _max_step_lane(st["ones"], torch.cat([ds2, dlam2]), tau)
    keep = alpha2 > alpha                                       # (B,)
    return dict(ddx=torch.where(keep, st["ddx"] + ddx_g, st["ddx"]),
                ddu=torch.where(keep, st["ddu"] + ddu_g, st["ddu"]),
                ds=torch.where(keep, ds2, ds),
                dlam=torch.where(keep, dlam2, dlam),
                alpha=torch.maximum(alpha, alpha2))


class _Arena:
    """The loop state of one problem shape at fixed addresses, and the
    segments captured on it: `replay(name, fn)` captures fn's writes into
    the state as a CUDA graph at its first call (after one eager run on a
    side stream that sizes its outputs), then replays it."""

    def __init__(self, inputs: dict):
        self.state = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.graphs = {}

    def __getitem__(self, key):
        return self.state[key]

    def put(self, key, value):
        if key not in self.state:
            self.state[key] = torch.empty_like(value)
        self.state[key].copy_(value)

    def replay(self, name, fn):
        graph = self.graphs.get(name)
        if graph is None:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = fn(self.state)
            torch.cuda.current_stream().wait_stream(side)
            for k, v in out.items():
                if k not in self.state:
                    self.state[k] = torch.empty_like(v)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for k, v in fn(self.state).items():
                    self.state[k].copy_(v)
            self.graphs[name] = graph
        graph.replay()


class LoopGraphs:
    """CUDA graphs of the two-launch Mehrotra iteration's barrier algebra
    for a caller that solves the same shapes every tick (a serving loop):
    `solve_batched`'s state lives in one arena per shape, the initial
    point and each of the three segments between the sweeps is one graph
    replay, and the sweeps themselves launch as always, between them.
    Issued one by one the algebra is ~120 small operations an iteration,
    each issued by the host; a replay is one.

    A shape's first solve captures its graphs, and torch waits for the
    card to capture: the caller marks that solve as an intended wait
    (`device.host_sync("graph capture")`).  Used on the card only, and
    not with Gondzio correctors, the bfloat16 A/B streams or warm-start
    duals, which run eagerly; so does an escalation re-solve."""

    def __init__(self):
        self._arenas = {}

    def arena(self, inputs: dict, *settings) -> _Arena:
        """The arena of the inputs' shapes and the `settings` the graphs
        bake in, holding a copy of `inputs`."""
        key = tuple((k, tuple(v.shape), v.dtype, str(v.device))
                    for k, v in inputs.items()) + settings
        arena = self._arenas.get(key)
        if arena is None:
            arena = self._arenas[key] = _Arena(inputs)
        for k, v in inputs.items():
            arena.state[k].copy_(v)
        return arena


def solve_batched(qp: dict, config: IPMConfig = IPMConfig(),
                  fused: bool = True, lam0_l=None, lam0_u=None,
                  condense: int = 1, fused_iter: bool = False,
                  windowed: bool | None = None) -> BatchSolution:
    """Solve a batch of box-constrained multistage QPs (batch-last,
    diagonal stage cost), as the JAX package's `solve_batched` (without
    its TPU blocking arguments).

    `qp` holds c (N,13,B), lb/ub (N,4,B), ruu (N,4,B), pT/p/dx0 (13,B) and
    either the stage data A (N,13,13,B), B (N,13,4,B), qxx/qx (N,13,B),
    ru (N,4,B), or (condense=2 only) the `prep_condense2` outputs under
    "c2Abar" ... "c2rbar", "c2Ae", "c2Be".

    condense: 1 runs the uncondensed sweeps; 2 block-2 partial condensing
    (N even), with `condense2` first where the data are not precondensed.
    fused=False (condense=1 only) runs each uncondensed sweep as its split
    launches: `backward_sweep` + `forward_sweep` for the factorization,
    `backward_vector_sweep` + `forward_sweep` for each corrector.
    lam0_l/lam0_u (N,4,B): warm-start bound duals, clipped to >= 1e-4 on
    the finite bounds.

    Per-lane escalation (config.escalate_iters > 0 and
    escalate_capacity > 0): the worst `escalate_capacity` lanes by final
    mu above `escalate_mu_tol` are gathered (`torch.topk`, distinct
    indices), re-solved from scratch with `escalate_iters` plain Mehrotra
    iterations, and scattered back on the lanes that were unconverged.
    Whether any lane is unconverged is one host sync per call
    (`bool(bad.any())`); converged batches then skip the re-solve.
    stats gains `escalated` (number of re-solved lanes) and
    `escalated_lanes` ((B,) bool, the lanes that were re-solved).  The
    escalation re-solve runs the two-launch iteration (with `windowed` and
    `fused`), never `fused_iter`, without Gondzio correctors and in full
    precision, as in the JAX package.

    config.gondzio_correctors = k > 0: after each Mehrotra corrector, k
    Gondzio centrality correctors, each one more corrector sweep on the
    same factorization with Pc zeroed, accepted per lane where it
    lengthens the step (on every sweep form; with fused_iter=True the
    two-launch iteration runs, as in the JAX package).

    windowed (condense=2): True runs each sweep as its split launches
    (`bwd_c2` + `fwd_c2`, `bwd_vec_c2` + `fwd_c2`: the JAX package's
    long-horizon form).  None or False run the fused `kkt_sweep_c2`/
    `corrector_sweep_c2` at every horizon: their gains live in device
    memory, so they have no VMEM-sized envelope to outgrow, and the JAX
    package's auto rule (the TPU's VMEM clamps) does not apply.  stats
    gains `c2_windowed` (0/1) and `c2_compress_gains`/`c2_compress_ab`
    (0/1: the compressions that ran).

    config.compress_gains / compress_ab (condense=2, the JAX package's
    bfloat16 streams): K, L and Pc travel from the factorization to the
    correctors in bfloat16; Abar - I and Bbar are stored in bfloat16 once
    per solve and the dynamics residual stream is cast to bfloat16 at
    every use.  windowed=True drops both with a warning (its sweeps run
    full precision), fused_iter=True with either raises ValueError.

    fused_iter (condense=2): True runs each Mehrotra iteration as one
    `iter_sweep_c2` launch; False (default) the two sweeps with the
    barrier algebra between them.  With condense=1, windowed, fused_iter
    and the compressions have no effect and stats carry no c2_* keys.
    """
    if "c2Abar" in qp and condense != 2:
        raise ValueError("precondensed (c2*) QP data requires condense=2")
    check_supported(config, condense, windowed, fused_iter, fused)
    return solve_checked(qp, config, condense, windowed, fused_iter,
                         lam0_l, lam0_u, fused)


# Escalation accounting (kin of the kernels' launch counters): re-solves
# run, and lanes re-solved, summed on the device so counting never waits
# for the card.
_ESCALATIONS = {"resolves": 0, "lanes": None}


def escalation_counts() -> dict:
    """Re-solves and re-solved lanes since the last reset (reading the
    lanes waits for the card)."""
    lanes = _ESCALATIONS["lanes"]
    return dict(resolves=_ESCALATIONS["resolves"],
                lanes=0 if lanes is None else int(lanes))


def reset_escalation_counts() -> None:
    _ESCALATIONS.update(resolves=0, lanes=None)


def solve_checked(qp: dict, config: IPMConfig, condense: int,
                  windowed: bool | None = None, fused_iter: bool = False,
                  lam0_l=None, lam0_u=None, fused: bool = True,
                  graphs: LoopGraphs | None = None) -> BatchSolution:
    """`solve_batched` for a caller that has run `check_supported`;
    `graphs` replays the iteration's barrier algebra (`LoopGraphs`)."""
    sol = _solve_core(qp, config, condense, windowed, fused_iter, lam0_l,
                      lam0_u, fused, graphs)
    cap = config.escalate_capacity
    if config.escalate_iters <= 0 or cap <= 0:
        return sol
    B = qp["c"].shape[-1]
    cap = min(cap, B)
    esc_cfg = IPMConfig(iters=config.escalate_iters, tau=config.tau,
                        reg=config.reg, s_min_init=config.s_min_init,
                        mu0_init=config.mu0_init)

    score = sol.stats["mu"]
    bad = score > config.escalate_mu_tol
    stats = dict(sol.stats)
    with host_sync("escalation"):
        any_bad = bool(bad.any())
    if not any_bad:
        stats["escalated"] = torch.zeros((), dtype=torch.int32,
                                         device=score.device)
        stats["escalated_lanes"] = torch.zeros_like(bad)
        return sol._replace(stats=stats)

    masked = torch.where(bad, score, -torch.inf)
    idx = torch.topk(masked, cap).indices          # distinct lane indices
    valid = bad[idx]                               # (cap,)
    sub = _solve_core({k: v.index_select(-1, idx) for k, v in qp.items()},
                      esc_cfg, condense, windowed, fused=fused)

    def scat(full, part):
        # in place on this call's own outputs: lanes `idx` take the
        # re-solved values where valid, keep their own elsewhere
        full[..., idx] = torch.where(valid, part, full[..., idx])
        return full

    for k in ("mu", "res_stat", "res_eq"):
        stats[k] = scat(stats[k], sub.stats[k])
    stats["escalated"] = valid.sum(dtype=torch.int32)
    _ESCALATIONS["resolves"] += 1
    lanes = _ESCALATIONS["lanes"]
    _ESCALATIONS["lanes"] = (stats["escalated"] if lanes is None
                             else lanes + stats["escalated"])
    stats["escalated_lanes"] = scat(torch.zeros_like(bad), valid)
    return BatchSolution(dx=scat(sol.dx, sub.dx), du=scat(sol.du, sub.du),
                         lam_l=scat(sol.lam_l, sub.lam_l),
                         lam_u=scat(sol.lam_u, sub.lam_u), stats=stats)


def _solve_core(qp: dict, config: IPMConfig, condense: int,
                windowed: bool | None = None, fused_iter: bool = False,
                lam0_l=None, lam0_u=None, fused: bool = True,
                graphs: LoopGraphs | None = None) -> BatchSolution:
    c = qp["c"]
    ruu = qp["ruu"]
    pT_diag, p_T = qp["pT"], qp["p"]
    N_orig, nu_orig, B = ruu.shape
    nx = c.shape[1]
    dtype = c.dtype
    lb0, ub0 = qp["lb"], qp["ub"]
    use_iter = _uses_iter(config, condense, fused_iter)
    comp_g = comp_ab = False

    if condense == 2:
        if "c2Abar" in qp:
            cnd = {k: qp["c2" + k] for k in _C2_KEYS}
            exp_A, exp_B, stride = qp["c2Ae"], qp["c2Be"], 1
        else:
            cnd = ck.condense2(qp["A"], qp["B"], c, qp["qxx"], qp["qx"],
                               qp["ru"])
            exp_A, exp_B, stride = qp["A"], qp["B"], 2
        # bounds / slacks / duals are per original input; the stage-major
        # layout makes the condensed stacking a pure reshape
        N, nu = N_orig // 2, 2 * nu_orig
        resh = lambda z: z.reshape(N, nu, B)  # noqa: E731
        lb0, ub0, ruu = resh(lb0), resh(ub0), resh(ruu)
        if lam0_l is not None:
            lam0_l = resh(lam0_l)
        if lam0_u is not None:
            lam0_u = resh(lam0_u)
        ru, qx, cs = cnd["rbar"], cnd["qbar"], cnd["cbar"]
        Abar, Bbar = cnd["Abar"], cnd["Bbar"]
        Qbar, S1T, R00 = cnd["Qbar"], cnd["S1T"], cnd["R00"]
        # bf16 compressed streams (the JAX package's IPMConfig note): on the
        # fused two-launch sweeps only
        comp_g = bool(config.compress_gains)
        comp_ab = bool(config.compress_ab)
        if (comp_g or comp_ab) and windowed:
            warnings.warn(
                "compress_gains/compress_ab ignored: windowed=True selects "
                "the split c2 sweeps, which run full-precision",
                stacklevel=3)
            comp_g = comp_ab = False
        if windowed:
            kkt_c2, corr_c2 = ck.kkt_sweep_c2_win, ck.corrector_sweep_c2_win
        else:
            kkt_c2 = functools.partial(
                ck.kkt_sweep_c2, gains_dtype=torch.bfloat16 if comp_g
                else None, a_dev=comp_ab)
            corr_c2 = functools.partial(ck.corrector_sweep_c2, a_dev=comp_ab)
        if comp_ab:
            # deviation-coded A: the bf16 rounding lands on the O(dt J)
            # deviation, not on the unit diagonal
            eye = torch.eye(nx, dtype=dtype, device=c.device)[:, :, None]
            Abar = (Abar - eye).to(torch.bfloat16)
            Bbar = Bbar.to(torch.bfloat16)

        def kkt(c_res, q, rs, r, pterm, dx0):
            return kkt_c2(Abar, Bbar, c_res, Qbar, S1T, R00, q, rs, r,
                          pT_diag, pterm, dx0)

        def corr(c_res, q, r, K, L, Pc, pterm, dx0):
            return corr_c2(Abar, Bbar, c_res, q, r, K, L, Pc, pterm, dx0)
    else:
        N, nu = N_orig, nu_orig
        A, Bm, qxx = qp["A"], qp["B"], qp["qxx"]
        ru, qx, cs = qp["ru"], qp["qx"], c

        if fused:
            def kkt(c_res, q, rs, r, pterm, dx0):
                return rk.kkt_sweep(A, Bm, c_res, qxx, q, rs, r, pT_diag,
                                    pterm, dx0)

            def corr(c_res, q, r, K, L, Pc, pterm, dx0):
                return rk.corrector_sweep(A, Bm, c_res, q, r, K, L, Pc,
                                          pterm, dx0)
        else:
            def kkt(c_res, q, rs, r, pterm, dx0):
                K, kff, L, Pc = rk.backward_sweep(A, Bm, c_res, qxx, q, rs, r,
                                                  pT_diag, pterm)
                return (K, kff, L, Pc) + tuple(
                    rk.forward_sweep(A, Bm, c_res, K, kff, dx0))

            def corr(c_res, q, r, K, L, Pc, pterm, dx0):
                kff = rk.backward_vector_sweep(A, Bm, q, r, K, L, Pc, pterm)
                return rk.forward_sweep(A, Bm, c_res, K, kff, dx0)
    # the dynamics-residual stream as the sweeps take it (bf16 with
    # compress_ab, cast at every use as in the JAX package)
    cstream = ((lambda z: z.to(torch.bfloat16)) if comp_ab
               else (lambda z: z))

    inputs = dict(lb0=lb0, ub0=ub0, ruu=ruu, qx=qx, ru=ru, cs=cs, p_T=p_T,
                  dx0=qp["dx0"])
    warm = dict(lam0_l=lam0_l, lam0_u=lam0_u)
    init = functools.partial(_init, s_min_init=config.s_min_init,
                             mu0_init=config.mu0_init)
    if use_iter:
        # one launch per iteration (the JAX package's `iteration2`); the
        # kernel updates its carries in place, and they are views of
        # z_dx, r1x, cd and the stacked bounds' rows, so nothing is
        # reassembled afterwards
        st = init({**inputs, **warm})
        z_dx, z_du, r1x, r1u = st["z_dx"], st["z_du"], st["r1x"], st["r1u"]
        cd = -st["r2"]                          # rows dx0_res, c_res
        (s_l, s_u), (lam_l, lam_u) = st["s"], st["lam"]
        m_l, m_u = st["fin"].to(dtype)
        r3, r4 = st["r34"]
        nin = st["n_ineq"].to(dtype)[None]
        has = st["has_ineq"].to(dtype)[None]
        scratch = ck.iter_scratch(N, B, dtype, c.device)
        for _ in range(config.iters):
            ck.iter_sweep_c2(
                Abar, Bbar, cd[1:], Qbar, S1T, R00, r1x[:-1], ruu, r1u,
                s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, z_dx[:-1], z_du,
                pT_diag, r1x[-1], cd[0], z_dx[-1], nin, has, config.tau,
                scratch=scratch)
        st["r2"] = -cd
    else:
        # mu_floor = 100 eps^2, rounded to the working dtype
        mu_floor = float(100.0 * torch.tensor(torch.finfo(dtype).eps,
                                              dtype=dtype) ** 2)
        pre, mid = _iter_pre, _iter_mid
        post = functools.partial(_iter_post, tau=config.tau,
                                 mu_floor=mu_floor)
        if (graphs is not None and c.device.type == "cuda"
                and config.gondzio_correctors == 0 and not comp_ab
                and lam0_l is None and lam0_u is None):
            # the same segments replayed from CUDA graphs, the sweeps
            # launched between them as always
            st = graphs.arena(inputs, config.tau, config.s_min_init,
                              config.mu0_init)
            st.replay("init", init)
            for _ in range(config.iters):
                st.replay("pre", pre)
                K, _, L, Pc, _, ddu_a = kkt(
                    st["c_res"], st["r1x"][:-1], st["ruu_shift"],
                    st["rt1u"], st["r1x"][-1], st["dx0_res"])
                st.put("ddu_a", ddu_a)
                st.replay("mid", mid)
                ddx, ddu = corr(st["c_res"], st["r1x"][:-1], st["rt1u_c"],
                                K, L, Pc, st["r1x"][-1], st["dx0_res"])
                st.put("ddx", ddx)
                st.put("ddu", ddu)
                st.replay("post", post)
            # the next solve overwrites the arena: copy out what the
            # solution returns (the stats below are new tensors)
            st = dict(st.state)
            st.update({k: st[k].clone() for k in ("z_dx", "z_du", "lam")})
        else:
            st = init({**inputs, **warm})
            step = functools.partial(_iter_step, tau=config.tau)
            update = functools.partial(_iter_update, mu_floor=mu_floor)
            for _ in range(config.iters):
                st.update(pre(st))
                c_res = cstream(st["c_res"])
                K, _, L, Pc, _, st["ddu_a"] = kkt(
                    c_res, st["r1x"][:-1], st["ruu_shift"], st["rt1u"],
                    st["r1x"][-1], st["dx0_res"])
                st.update(mid(st))
                st["ddx"], st["ddu"] = corr(
                    c_res, st["r1x"][:-1], st["rt1u_c"], K, L, Pc,
                    st["r1x"][-1], st["dx0_res"])
                st.update(step(st))
                for _ in range(config.gondzio_correctors):
                    st.update(_gondzio(st, corr, (K, L, Pc), cstream,
                                       config.tau))
                st.update(update(st))
    z_dx, z_du, r1x, r1u, r2 = (st[k] for k in ("z_dx", "z_du", "r1x",
                                                "r1u", "r2"))
    lam_l, lam_u = st["lam"]

    stats = dict(
        mu=_compl(st["lam"], st["s"], st["fin"], st["n_ineq"]),
        res_stat=torch.maximum(torch.amax(r1x.abs(), dim=(0, 1)),
                               torch.amax(r1u.abs(), dim=(0, 1))),
        res_eq=torch.amax(r2.abs(), dim=(0, 1)),
    )
    if condense == 1:
        return BatchSolution(dx=z_dx, du=z_du, lam_l=lam_l, lam_u=lam_u,
                             stats=stats)
    stats.update(c2_windowed=int(bool(windowed)),
                 c2_compress_gains=int(comp_g), c2_compress_ab=int(comp_ab))

    # expand: interior states were eliminated exactly through their
    # dynamics row; recover them once (not per iteration)
    dx_even = z_dx[:-1]                                 # (M, 13, B)
    dx_odd = ck.expand2(exp_A, exp_B, c, dx_even,
                        z_du[:, :nu_orig].contiguous(), stride)
    dx_full = torch.cat([
        torch.stack([dx_even, dx_odd], dim=1).reshape(N_orig, nx, B),
        z_dx[-1:]], dim=0)                              # (N_orig+1, nx, B)
    return BatchSolution(
        dx=dx_full,
        du=z_du.reshape(N_orig, nu_orig, B),
        lam_l=lam_l.reshape(N_orig, nu_orig, B),
        lam_u=lam_u.reshape(N_orig, nu_orig, B),
        stats=stats)
