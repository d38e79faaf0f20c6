"""Primal-dual interior-point method for box-constrained multistage QPs
(PyTorch counterpart of `ops/ipm.py`).

`IPMConfig` and `certified_config` are shared with the batched solver
(`ops.ipm_fast`): field names and defaults are the JAX package's, so a
config means the same thing on both sides.  `solve` is the single-instance
solver of `solver.rti.rti_step`: a fixed number of Mehrotra
predictor-corrector iterations sharing one Riccati factorization each
(`ops.riccati`), with the affine KKT residuals carried and contracted by
(1 - alpha) instead of re-evaluated, optional Gondzio centrality
correctors, and infinite bounds masked.

KKT system (P = selector of du; s_l, s_u slack, lam_l, lam_u >= 0):
    r1   = H z + g + E'nu - P'lam_l + P'lam_u        (stationarity)
    r2   = E z - e                                    (dynamics + x0)
    r3   = P z - lb - s_l                             (lower bound)
    r4   = ub - P z - s_u                             (upper bound)
    r5_l = Lam_l s_l - sigma mu,  r5_u = Lam_u s_u - sigma mu

Eliminating (ds, dlam) yields an LQ problem with input-Hessian shift
Sigma = lam_l/s_l + lam_u/s_u, solved by `ops.riccati`.

Every quantity stays a tensor where it was computed: with escalation off a
solve on the card never waits on it.  Escalation (escalate_iters > 0) is
one host branch: the JAX package's `lax.cond` re-solves only when the
final mu misses its tolerance, and the port reads that one comparison back
(one synchronisation per solve) rather than always paying the
escalate_iters re-solve as a select would.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import host_sync
from crazyflie_nmpc_tpu_torch.ops import riccati
from crazyflie_nmpc_tpu_torch.ops.qp import QPData


class IPMSolution(NamedTuple):
    dx: Any        # (N+1, nx) primal state deviations
    du: Any        # (N, nu)   primal input deviations
    lam_l: Any     # (N, nu)   lower-bound duals
    lam_u: Any     # (N, nu)   upper-bound duals
    stats: Any     # dict of convergence diagnostics


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Mehrotra predictor-corrector settings."""

    iters: int = 12
    tau: float = 0.995
    reg: float = 0.0
    s_min_init: float = 1e-2
    # duals start at lam = mu0_init / s (1.0 is the classic cold start)
    mu0_init: float = 1.0
    # Gondzio centrality correctors per iteration: each one more corrector
    # sweep on the same factorization, kept per lane where it lengthens
    # the step
    gondzio_correctors: int = 0
    # escalation: a problem (`solve`) or lane (`ipm_fast`) whose final mu
    # exceeds escalate_mu_tol is re-solved from scratch with
    # escalate_iters iterations; the batched solver re-solves at most
    # escalate_capacity lanes per call (0 disables it there)
    escalate_iters: int = 0
    escalate_mu_tol: float = 1e-9
    escalate_capacity: int = 0
    # bf16 compressed streams of the condensed sweeps (condense=2, fused
    # sweeps only): K/L/Pc from the factorization to the correctors
    # (compress_gains), the deviation-coded Abar - I, Bbar and the
    # dynamics residual (compress_ab); arithmetic stays in the working
    # dtype.  `solve` ignores both.
    compress_gains: bool = False
    compress_ab: bool = False


# The BranchLog that records or checks the escalation branches `solve`
# takes, where a caller has set one (`BranchLog.record`).
_BRANCH_LOG: contextvars.ContextVar = contextvars.ContextVar(
    "ipm_branch_log", default=None)


class BranchLog:
    """The escalation branches of the solves in one recomputed region
    (a tick under `LoopConfig(remat=True)`): recorded on the forward pass
    and checked when the region is recomputed for the backward pass,
    where another branch would silently give another gradient."""

    def __init__(self):
        self.taken: list[bool] = []
        self._replay = None

    def see(self, escalated: bool):
        if self._replay is None:
            self.taken.append(escalated)
            return
        k, self._replay = self._replay, self._replay + 1
        if k >= len(self.taken) or self.taken[k] != escalated:
            raise RuntimeError(
                f"recomputed solve {k} took another escalation branch "
                f"(escalated={escalated}) than on the forward pass "
                f"({self.taken[k] if k < len(self.taken) else 'none'})")

    @contextlib.contextmanager
    def record(self, replay: bool = False):
        """Record the branches taken inside (replay=False), or check them
        against the record (replay=True)."""
        self._replay = 0 if replay else None
        token = _BRANCH_LOG.set(self)
        try:
            yield
        finally:
            _BRANCH_LOG.reset(token)

    def contexts(self):
        """(forward, recomputation) context managers, the pair
        `torch.utils.checkpoint`'s `context_fn` returns."""
        return self.record(), self.record(replay=True)


def certified_config(capacity: int = 0) -> IPMConfig:
    """The serving default: 8 Mehrotra iterations + escalation to 32,
    certified against the exact active-set oracle in the JAX package
    (tools/bangbang_cert.py).  `capacity` is the batched solver's
    escalation sub-batch size (`solve` ignores it).
    """
    return IPMConfig(iters=8, escalate_iters=32, escalate_capacity=capacity)


def _max_step(v, dv, tau):
    """Fraction-to-boundary: largest alpha <= 1 with v + alpha dv >=
    (1-tau) v, over all entries (0-dim tensor).  Entries with
    non-negative dv never bind."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        torch.inf)
    return _min(tau * torch.amin(ratio), 1.0)


def _min(x, bound):
    """min(x, bound) with the JAX package's gradient at a tie
    (`jnp.minimum`: half to each side; `torch.clamp` passes all of it).
    The bound is filled on x's device: no copy from the host."""
    return torch.minimum(x, torch.full((), bound, dtype=x.dtype,
                                       device=x.device))


def _max(x, bound):
    """max(x, bound), `jnp.maximum`'s gradient at a tie (`_min`)."""
    return torch.maximum(x, torch.full((), bound, dtype=x.dtype,
                                       device=x.device))


def _min4(a, b, c, d):
    return torch.minimum(torch.minimum(a, b), torch.minimum(c, d))


def init_state(qp: QPData, config: IPMConfig = IPMConfig(),
               lam0_l=None, lam0_u=None):
    """Initial IPM iterate + affine KKT residuals (z = 0 start): slacks at
    the clipped distance to the bounds, duals mu0_init / s (lam0_l/lam0_u,
    (N, nu): warm-start duals clipped to >= 1e-4), masked where a bound
    is infinite."""
    N, nx = qp.c.shape[-2], qp.c.shape[-1]
    nu = qp.ru.shape[-1]
    dtype, dev = qp.c.dtype, qp.c.device

    finite_l = torch.isfinite(qp.lb)
    finite_u = torch.isfinite(qp.ub)
    lb = torch.where(finite_l, qp.lb, 0.0)
    ub = torch.where(finite_u, qp.ub, 0.0)

    z_du = torch.zeros((N, nu), dtype=dtype, device=dev)
    z_dx = torch.zeros((N + 1, nx), dtype=dtype, device=dev)
    s_l = torch.where(finite_l, _max(-lb, config.s_min_init), 1.0)
    s_u = torch.where(finite_u, _max(ub, config.s_min_init), 1.0)
    lam_l = torch.where(finite_l, config.mu0_init / s_l, 0.0)
    lam_u = torch.where(finite_u, config.mu0_init / s_u, 0.0)
    lam_min = 1e-4
    if lam0_l is not None:
        lam_l = torch.where(finite_l, _max(lam0_l, lam_min), 0.0)
    if lam0_u is not None:
        lam_u = torch.where(finite_u, _max(lam0_u, lam_min), 0.0)

    # affine residuals at the initial point (equality duals nu = 0)
    r1x = torch.cat([qp.qx, qp.p[None]], dim=0)
    r1u = qp.ru - lam_l + lam_u
    r2 = torch.cat([-qp.dx0[None], -qp.c], dim=0)
    r3 = torch.where(finite_l, -lb - s_l, 0.0)
    r4 = torch.where(finite_u, ub - s_u, 0.0)
    return (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4)


def iterate(qp: QPData, config: IPMConfig, carry):
    """One Mehrotra predictor-corrector iteration on the carried state.
    Returns (carry, (alpha, mu))."""
    (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry
    nu = qp.ru.shape[-1]
    dtype = qp.c.dtype
    finite_l = torch.isfinite(qp.lb)
    finite_u = torch.isfinite(qp.ub)
    fl, fu = finite_l.to(dtype), finite_u.to(dtype)
    n_fin = finite_l.sum() + finite_u.sum()
    n_ineq = torch.clamp(n_fin, min=1).to(dtype)

    mu = ((lam_l * s_l * fl).sum() + (lam_u * s_u * fu).sum()) / n_ineq
    sig_l = torch.where(finite_l, lam_l / s_l, 0.0)
    sig_u = torch.where(finite_u, lam_u / s_u, 0.0)
    sigma_diag = sig_l + sig_u

    def masked(mask, v):
        return torch.where(mask, v, 0.0)

    # ---- predictor (affine scaling, sigma = 0)
    r5l = lam_l * s_l
    r5u = lam_u * s_u
    rt1u = (r1u + masked(finite_l, (r5l + lam_l * r3) / s_l)
            - masked(finite_u, (r5u + lam_u * r4) / s_u))
    Ruu_shift = qp.Ruu + torch.diag_embed(sigma_diag)
    if config.reg:
        Ruu_shift = Ruu_shift + config.reg * torch.eye(
            nu, dtype=dtype, device=Ruu_shift.device)
    factors = riccati.factorize(qp.A, qp.B, qp.Qxx, Ruu_shift, qp.S, qp.P)

    def directions(rt1u_):
        k_ff, _ = riccati.backward_vector(
            factors, qp.A, qp.B, r1x[:-1], rt1u_, -r2[1:], r1x[-1])
        return riccati.forward_rollout(factors, k_ff, qp.A, qp.B, -r2[1:],
                                       -r2[0])

    def step_len(ds_l_, ds_u_, dlam_l_, dlam_u_, tau):
        return _min4(
            _max_step(torch.where(finite_l, s_l, 1.0), ds_l_, tau),
            _max_step(torch.where(finite_u, s_u, 1.0), ds_u_, tau),
            _max_step(torch.where(finite_l, lam_l, 1.0), dlam_l_, tau),
            _max_step(torch.where(finite_u, lam_u, 1.0), dlam_u_, tau))

    ddx_a, ddu_a = directions(rt1u)
    ds_l_a = masked(finite_l, ddu_a + r3)
    ds_u_a = masked(finite_u, r4 - ddu_a)
    dlam_l_a = masked(finite_l, -(r5l + lam_l * ds_l_a) / s_l)
    dlam_u_a = masked(finite_u, -(r5u + lam_u * ds_u_a) / s_u)

    alpha_aff = step_len(ds_l_a, ds_u_a, dlam_l_a, dlam_u_a, 1.0)
    mu_aff = (((lam_l + alpha_aff * dlam_l_a)
               * (s_l + alpha_aff * ds_l_a) * fl).sum()
              + ((lam_u + alpha_aff * dlam_u_a)
                 * (s_u + alpha_aff * ds_u_a) * fu).sum()) / n_ineq
    tiny = torch.finfo(dtype).tiny
    sigma = _min(_max((mu_aff / _max(mu, tiny)) ** 3, 0.0), 1.0)

    # ---- corrector (centering + Mehrotra second-order term)
    r5l_c = r5l - sigma * mu + ds_l_a * dlam_l_a
    r5u_c = r5u - sigma * mu + ds_u_a * dlam_u_a
    rt1u_c = (r1u + masked(finite_l, (r5l_c + lam_l * r3) / s_l)
              - masked(finite_u, (r5u_c + lam_u * r4) / s_u))
    ddx, ddu = directions(rt1u_c)
    ds_l = masked(finite_l, ddu + r3)
    ds_u = masked(finite_u, r4 - ddu)
    dlam_l = masked(finite_l, -(r5l_c + lam_l * ds_l) / s_l)
    dlam_u = masked(finite_u, -(r5u_c + lam_u * ds_u) / s_u)
    alpha = step_len(ds_l, ds_u, dlam_l, dlam_u, config.tau)

    # ---- Gondzio centrality correctors on the same factorization, each
    # kept only where it lengthens the step; pure complementarity
    # right-hand side, so the (1 - alpha) contraction below holds
    for _ in range(config.gondzio_correctors):
        mu_t = sigma * mu
        a_hat = _min(alpha + 0.1, 1.0)
        v_l = (s_l + a_hat * ds_l) * (lam_l + a_hat * dlam_l)
        v_u = (s_u + a_hat * ds_u) * (lam_u + a_hat * dlam_u)
        t_l = masked(finite_l, torch.minimum(torch.maximum(v_l, 0.1 * mu_t),
                                             10.0 * mu_t) - v_l)
        t_u = masked(finite_u, torch.minimum(torch.maximum(v_u, 0.1 * mu_t),
                                             10.0 * mu_t) - v_u)
        rt1u_g = masked(finite_l, -t_l / s_l) + masked(finite_u, t_u / s_u)
        zc = torch.zeros_like(r2[1:])
        k_g, _ = riccati.backward_vector(
            factors, qp.A, qp.B, torch.zeros_like(r1x[:-1]), rt1u_g, zc,
            torch.zeros_like(r1x[-1]))
        ddx_g, ddu_g = riccati.forward_rollout(
            factors, k_g, qp.A, qp.B, zc, torch.zeros_like(r2[0]))
        ds_l_g = masked(finite_l, ddu_g)
        ds_u_g = masked(finite_u, -ddu_g)
        dlam_l_g = masked(finite_l, (t_l - lam_l * ds_l_g) / s_l)
        dlam_u_g = masked(finite_u, (t_u - lam_u * ds_u_g) / s_u)

        ds_l2, ds_u2 = ds_l + ds_l_g, ds_u + ds_u_g
        dlam_l2, dlam_u2 = dlam_l + dlam_l_g, dlam_u + dlam_u_g
        alpha2 = step_len(ds_l2, ds_u2, dlam_l2, dlam_u2, config.tau)
        keep = alpha2 > alpha

        def pick(new, old, keep=keep):
            return torch.where(keep, new, old)
        ddx, ddu = pick(ddx + ddx_g, ddx), pick(ddu + ddu_g, ddu)
        ds_l, ds_u = pick(ds_l2, ds_l), pick(ds_u2, ds_u)
        dlam_l, dlam_u = pick(dlam_l2, dlam_l), pick(dlam_u2, dlam_u)
        alpha = torch.maximum(alpha, alpha2)

    # convergence freeze once the gap is far below achievable accuracy
    # (eps^2-scaled), only where inequalities exist
    mu_floor = 100.0 * torch.finfo(dtype).eps ** 2
    alpha = torch.where((n_fin > 0) & (mu <= mu_floor), 0.0, alpha)

    z_dx = z_dx + alpha * ddx
    z_du = z_du + alpha * ddu
    s_l = torch.where(finite_l, s_l + alpha * ds_l, 1.0)
    s_u = torch.where(finite_u, s_u + alpha * ds_u, 1.0)
    lam_l = torch.where(finite_l, lam_l + alpha * dlam_l, 0.0)
    lam_u = torch.where(finite_u, lam_u + alpha * dlam_u, 0.0)

    # affine residuals contract exactly by (1 - alpha) for a QP
    shrink = 1.0 - alpha
    carry = (z_dx, z_du, s_l, s_u, lam_l, lam_u,
             shrink * r1x, shrink * r1u, shrink * r2,
             shrink * r3, shrink * r4)
    return carry, (alpha, mu)


def solve(qp: QPData, config: IPMConfig = IPMConfig(),
          lam0_l=None, lam0_u=None) -> IPMSolution:
    """Solve the box-constrained multistage QP (non-finite lb/ub entries
    are masked out of the barrier: slack frozen at 1, dual at 0).

    With `config.escalate_iters > 0` a problem whose final mu exceeds
    `config.escalate_mu_tol` is re-solved from scratch at the larger
    iteration budget, without Gondzio correctors; whether it does is one
    host read of that comparison (the module note), recorded in the
    caller's `BranchLog` where one is set.  stats gains an
    `escalated` flag (int32, 0 or 1); `alphas`/`mus` stay those of the
    primary solve.
    """
    sol = _solve(qp, config, lam0_l, lam0_u)
    if config.escalate_iters <= 0:
        return sol
    stats = dict(sol.stats)
    with host_sync("escalation"):
        converged = not bool(sol.stats["mu"] > config.escalate_mu_tol)
    log = _BRANCH_LOG.get()
    if log is not None:
        log.see(not converged)
    if converged:
        stats["escalated"] = torch.zeros((), dtype=torch.int32,
                                         device=qp.c.device)
        return sol._replace(stats=stats)
    esc_cfg = dataclasses.replace(config, iters=config.escalate_iters,
                                  escalate_iters=0, gondzio_correctors=0)
    s2 = _solve(qp, esc_cfg, lam0_l, lam0_u)
    for k in ("mu", "res_stat", "res_eq", "res_ineq"):
        stats[k] = s2.stats[k]
    stats["escalated"] = torch.ones((), dtype=torch.int32,
                                    device=qp.c.device)
    return IPMSolution(dx=s2.dx, du=s2.du, lam_l=s2.lam_l, lam_u=s2.lam_u,
                       stats=stats)


def _solve(qp: QPData, config: IPMConfig, lam0_l=None,
           lam0_u=None) -> IPMSolution:
    dtype = qp.c.dtype
    fl = torch.isfinite(qp.lb).to(dtype)
    fu = torch.isfinite(qp.ub).to(dtype)
    n_ineq = torch.clamp(fl.sum() + fu.sum(), min=1)

    carry = init_state(qp, config, lam0_l=lam0_l, lam0_u=lam0_u)
    alphas, mus = [], []
    for _ in range(config.iters):
        carry, (alpha, mu) = iterate(qp, config, carry)
        alphas.append(alpha)
        mus.append(mu)
    (z_dx, z_du, s_l, s_u, lam_l, lam_u, r1x, r1u, r2, r3, r4) = carry

    mu_final = ((lam_l * s_l * fl).sum() + (lam_u * s_u * fu).sum()) / n_ineq
    empty = qp.c.new_zeros((0,))
    stats = dict(
        mu=mu_final,
        alphas=torch.stack(alphas) if alphas else empty,
        mus=torch.stack(mus) if mus else empty,
        res_stat=torch.maximum(r1x.abs().amax(), r1u.abs().amax()),
        res_eq=r2.abs().amax(),
        res_ineq=torch.maximum(r3.abs().amax(), r4.abs().amax()),
    )
    return IPMSolution(dx=z_dx, du=z_du, lam_l=lam_l, lam_u=lam_u,
                       stats=stats)
