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
lanes as a sub-batch (see `solve_batched`).
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
    """Per-lane fraction-to-boundary over the (N, nu) axes -> (B,)."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.inf)
    return torch.clamp(tau * torch.amin(ratio, dim=(0, 1)), max=1.0)


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
                  lam0_l=None, lam0_u=None,
                  fused: bool = True) -> BatchSolution:
    """`solve_batched` for a caller that has run `check_supported`."""
    sol = _solve_core(qp, config, condense, windowed, fused_iter, lam0_l,
                      lam0_u, fused)
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
                lam0_l=None, lam0_u=None,
                fused: bool = True) -> BatchSolution:
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

    finite_l = torch.isfinite(lb0)
    finite_u = torch.isfinite(ub0)
    lb = torch.where(finite_l, lb0, 0.0)
    ub = torch.where(finite_u, ub0, 0.0)
    n_fin = finite_l.sum(dim=(0, 1)) + finite_u.sum(dim=(0, 1))
    n_ineq = torch.clamp(n_fin, min=1)
    has_ineq = n_fin > 0

    # initial point (cf. ipm.init_state)
    z_du = torch.zeros((N, nu, B), dtype=dtype, device=c.device)
    z_dx = torch.zeros((N + 1, nx, B), dtype=dtype, device=c.device)
    s_l = torch.where(finite_l, torch.clamp(-lb, min=config.s_min_init), 1.0)
    s_u = torch.where(finite_u, torch.clamp(ub, min=config.s_min_init), 1.0)
    # scalars are filled on the device: a host-to-device copy of a fresh
    # tensor would block the host until the card's queue drains
    mu0 = torch.full((), config.mu0_init, dtype=dtype, device=c.device)
    lam_l = torch.where(finite_l, mu0 / s_l, 0.0)
    lam_u = torch.where(finite_u, mu0 / s_u, 0.0)
    # warm-started bound duals (cf. ipm.init_state): clipped interior
    if lam0_l is not None:
        lam_l = torch.where(finite_l, torch.clamp(lam0_l, min=1e-4), 0.0)
    if lam0_u is not None:
        lam_u = torch.where(finite_u, torch.clamp(lam0_u, min=1e-4), 0.0)

    r1x = torch.cat([qx, p_T[None]], dim=0)               # (N+1, nx, B)
    r1u = ru - lam_l + lam_u
    r2 = torch.cat([-qp["dx0"][None], -cs], dim=0)        # (N+1, nx, B)
    r3 = torch.where(finite_l, -lb - s_l, 0.0)
    r4 = torch.where(finite_u, ub - s_u, 0.0)

    def compl(a, b):
        return ((a[0] * b[0] * finite_l).sum(dim=(0, 1))
                + (a[1] * b[1] * finite_u).sum(dim=(0, 1))) / n_ineq

    if use_iter:
        # one launch per iteration (the JAX package's `iteration2`); the
        # kernel updates its carries in place, and they are views of
        # z_dx, r1x and cd, so nothing is reassembled afterwards
        cd = -r2                                # rows dx0_res, c_res
        m_l, m_u = finite_l.to(dtype), finite_u.to(dtype)
        nin, has = n_ineq.to(dtype)[None], has_ineq.to(dtype)[None]
        scratch = ck.iter_scratch(N, B, dtype, c.device)
        for _ in range(config.iters):
            ck.iter_sweep_c2(
                Abar, Bbar, cd[1:], Qbar, S1T, R00, r1x[:-1], ruu, r1u,
                s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, z_dx[:-1], z_du,
                pT_diag, r1x[-1], cd[0], z_dx[-1], nin, has, config.tau,
                scratch=scratch)
        r2 = -cd
    else:
        # mu_floor = 100 eps^2 and tiny, both rounded to the working dtype
        finfo = torch.finfo(dtype)
        mu_floor = float(100.0 * torch.tensor(finfo.eps, dtype=dtype) ** 2)
        tiny = torch.full((), finfo.tiny, dtype=dtype, device=c.device)
        for _ in range(config.iters):
            mu = compl((lam_l, lam_u), (s_l, s_u))
            sig_l = torch.where(finite_l, lam_l / s_l, 0.0)
            sig_u = torch.where(finite_u, lam_u / s_u, 0.0)
            ruu_shift = ruu + sig_l + sig_u                    # (N, nu, B)

            r5l = lam_l * s_l
            r5u = lam_u * s_u
            rt1u = (r1u + torch.where(finite_l, (r5l + lam_l * r3) / s_l, 0.0)
                    - torch.where(finite_u, (r5u + lam_u * r4) / s_u, 0.0))

            # predictor: factorization + affine backward + forward rollout
            c_res = cstream(-r2[1:])
            dx0_res = -r2[0]
            K, _, L, Pc, ddx_a, ddu_a = kkt(c_res, r1x[:-1], ruu_shift,
                                            rt1u, r1x[-1], dx0_res)

            ds_l_a = torch.where(finite_l, ddu_a + r3, 0.0)
            ds_u_a = torch.where(finite_u, r4 - ddu_a, 0.0)
            dlam_l_a = torch.where(finite_l,
                                   -(r5l + lam_l * ds_l_a) / s_l, 0.0)
            dlam_u_a = torch.where(finite_u,
                                   -(r5u + lam_u * ds_u_a) / s_u, 0.0)

            one_l = torch.where(finite_l, s_l, 1.0)
            one_u = torch.where(finite_u, s_u, 1.0)
            lam1_l = torch.where(finite_l, lam_l, 1.0)
            lam1_u = torch.where(finite_u, lam_u, 1.0)
            alpha_aff = torch.minimum(
                torch.minimum(_max_step_lane(one_l, ds_l_a, 1.0),
                              _max_step_lane(one_u, ds_u_a, 1.0)),
                torch.minimum(_max_step_lane(lam1_l, dlam_l_a, 1.0),
                              _max_step_lane(lam1_u, dlam_u_a, 1.0)))
            mu_aff = compl((lam_l + alpha_aff * dlam_l_a,
                            lam_u + alpha_aff * dlam_u_a),
                           (s_l + alpha_aff * ds_l_a,
                            s_u + alpha_aff * ds_u_a))
            sigma = torch.clamp((mu_aff / torch.maximum(mu, tiny)) ** 3,
                                0.0, 1.0)

            # corrector: reuse the factorization, new right-hand side
            r5l_c = r5l - sigma * mu + ds_l_a * dlam_l_a
            r5u_c = r5u - sigma * mu + ds_u_a * dlam_u_a
            rt1u_c = (r1u
                      + torch.where(finite_l, (r5l_c + lam_l * r3) / s_l, 0.0)
                      - torch.where(finite_u, (r5u_c + lam_u * r4) / s_u, 0.0))
            ddx, ddu = corr(c_res, r1x[:-1], rt1u_c, K, L, Pc, r1x[-1],
                            dx0_res)

            ds_l = torch.where(finite_l, ddu + r3, 0.0)
            ds_u = torch.where(finite_u, r4 - ddu, 0.0)
            dlam_l = torch.where(finite_l, -(r5l_c + lam_l * ds_l) / s_l, 0.0)
            dlam_u = torch.where(finite_u, -(r5u_c + lam_u * ds_u) / s_u, 0.0)

            alpha = torch.minimum(
                torch.minimum(_max_step_lane(one_l, ds_l, config.tau),
                              _max_step_lane(one_u, ds_u, config.tau)),
                torch.minimum(_max_step_lane(lam1_l, dlam_l, config.tau),
                              _max_step_lane(lam1_u, dlam_u, config.tau)))
            # Gondzio centrality correctors: one more corrector sweep each
            # on the same factorization, right-hand side the pure
            # complementarity outlier correction, kept per lane where the
            # step lengthens.  The stored Pc = P_{k+1} c_k carries the
            # original dynamics residual into the vector pass, and this
            # solve has none, so Pc is zeroed (K and L do not depend on
            # the right-hand side).
            for _ in range(config.gondzio_correctors):
                mu_t = sigma * mu                                   # (B,)
                a_hat = torch.clamp(alpha + 0.1, max=1.0)
                v_l = (s_l + a_hat * ds_l) * (lam_l + a_hat * dlam_l)
                v_u = (s_u + a_hat * ds_u) * (lam_u + a_hat * dlam_u)
                t_l = torch.where(finite_l, _clip(v_l, 0.1 * mu_t,
                                                  10.0 * mu_t) - v_l, 0.0)
                t_u = torch.where(finite_u, _clip(v_u, 0.1 * mu_t,
                                                  10.0 * mu_t) - v_u, 0.0)
                rt1u_g = (torch.where(finite_l, -t_l / s_l, 0.0)
                          + torch.where(finite_u, t_u / s_u, 0.0))
                ddx_g, ddu_g = corr(
                    cstream(torch.zeros_like(r2[1:])),
                    torch.zeros_like(r1x[:-1]), rt1u_g, K, L,
                    torch.zeros_like(Pc), torch.zeros_like(r1x[-1]),
                    torch.zeros_like(r2[0]))
                ds_l_g = torch.where(finite_l, ddu_g, 0.0)
                ds_u_g = torch.where(finite_u, -ddu_g, 0.0)
                dlam_l_g = torch.where(finite_l,
                                       (t_l - lam_l * ds_l_g) / s_l, 0.0)
                dlam_u_g = torch.where(finite_u,
                                       (t_u - lam_u * ds_u_g) / s_u, 0.0)
                ds_l2, ds_u2 = ds_l + ds_l_g, ds_u + ds_u_g
                dlam_l2, dlam_u2 = dlam_l + dlam_l_g, dlam_u + dlam_u_g
                alpha2 = torch.minimum(
                    torch.minimum(_max_step_lane(one_l, ds_l2, config.tau),
                                  _max_step_lane(one_u, ds_u2, config.tau)),
                    torch.minimum(
                        _max_step_lane(lam1_l, dlam_l2, config.tau),
                        _max_step_lane(lam1_u, dlam_u2, config.tau)))
                keep = alpha2 > alpha                               # (B,)
                ddx = torch.where(keep, ddx + ddx_g, ddx)
                ddu = torch.where(keep, ddu + ddu_g, ddu)
                ds_l = torch.where(keep, ds_l2, ds_l)
                ds_u = torch.where(keep, ds_u2, ds_u)
                dlam_l = torch.where(keep, dlam_l2, dlam_l)
                dlam_u = torch.where(keep, dlam_u2, dlam_u)
                alpha = torch.maximum(alpha, alpha2)

            alpha = torch.where(has_ineq & (mu <= mu_floor), 0.0, alpha)

            z_dx = z_dx + alpha * ddx
            z_du = z_du + alpha * ddu
            s_l = torch.where(finite_l, s_l + alpha * ds_l, 1.0)
            s_u = torch.where(finite_u, s_u + alpha * ds_u, 1.0)
            lam_l = torch.where(finite_l, lam_l + alpha * dlam_l, 0.0)
            lam_u = torch.where(finite_u, lam_u + alpha * dlam_u, 0.0)

            shrink = 1.0 - alpha
            r1x, r1u, r2 = shrink * r1x, shrink * r1u, shrink * r2
            r3, r4 = shrink * r3, shrink * r4

    stats = dict(
        mu=compl((lam_l, lam_u), (s_l, s_u)),
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
