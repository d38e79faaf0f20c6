"""Riccati-recursion solver for equality-constrained LQ problems (PyTorch
counterpart of `ops/riccati.py`).

Each interior-point iteration reduces to an equality-constrained affine-LQ
solve: a backward value-function recursion and a forward rollout, Python
loops over the horizon here (`lax.scan` in the JAX package).  The
factorization (P_k, K_k, chol(Quu_k)) is separated from the affine/vector
pass so a Mehrotra predictor-corrector reuses one factorization for two
right-hand sides.

Problem solved (dims: N stages, nx states, nu inputs):

  min  sum_k 1/2 dx_k'Qxx_k dx_k + 1/2 du_k'Ruu_k du_k + du_k'S_k dx_k
             + qx_k'dx_k + ru_k'du_k
       + 1/2 dx_N'P dx_N + p'dx_N
  s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 given.

The Cholesky factor is `torch.linalg.cholesky_ex` without its error check
and the solves are two triangular solves (what `cho_solve` does): neither
reads a result back to the host, so a solve on the card never blocks it.
Leading axes before the stage axis are batch axes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class RiccatiFactors(NamedTuple):
    """Horizon-stacked factorization of the LQ problem.

    P:    (N+1, nx, nx) cost-to-go Hessians (P[N] = terminal).
    K:    (N, nu, nx)   feedback gains  du = K dx + k.
    Quu_chol: (N, nu, nu) lower Cholesky factors of
              Quu_k = Ruu_k + B_k'P_{k+1}B_k.
    """

    P: Any
    K: Any
    Quu_chol: Any


def _t(m):
    return m.transpose(-1, -2)


def cho_solve(L, b):
    """Solve (L L^T) x = b for b (..., n, k) with the lower factor L."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(_t(L), y, upper=True)


def _cho_solve_vec(L, v):
    return cho_solve(L, v.unsqueeze(-1)).squeeze(-1)


def _mv(a, v):
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def factorize(A, B, Qxx, Ruu, S, P_term):
    """Backward Riccati factorization (quadratic terms only); stage k of
    the stacked inputs is axis -3."""
    N = A.shape[-3]
    P = P_term
    Ps, Ks, Ls = [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        PA = P @ A_k
        PB = P @ B_k
        Quu = Ruu[..., k, :, :] + _t(B_k) @ PB
        Qux = S[..., k, :, :] + _t(B_k) @ PA
        L, _ = torch.linalg.cholesky_ex(Quu)
        K = -cho_solve(L, Qux)
        P = Qxx[..., k, :, :] + _t(A_k) @ PA + _t(Qux) @ K
        P = 0.5 * (P + _t(P))
        Ps[k], Ks[k], Ls[k] = P, K, L
    return RiccatiFactors(P=torch.stack(Ps + [P_term], dim=-3),
                          K=torch.stack(Ks, dim=-3),
                          Quu_chol=torch.stack(Ls, dim=-3))


def backward_vector(factors: RiccatiFactors, A, B, qx, ru, c, p_term):
    """Backward pass for the affine terms on an existing factorization
    (Qux'k_ff = K'Qu, so the cross term S is not needed here).
    Returns (k (N, nu) feedforward terms, p (N+1, nx) cost-to-go
    gradients)."""
    N = A.shape[-3]
    p = p_term
    ks, ps = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        m = p + _mv(factors.P[..., k + 1, :, :], c[..., k, :])
        Qu = ru[..., k, :] + _mv(_t(B_k), m)
        ks[k] = -_cho_solve_vec(factors.Quu_chol[..., k, :, :], Qu)
        p = (qx[..., k, :] + _mv(_t(A_k), m)
             + _mv(_t(factors.K[..., k, :, :]), Qu))
        ps[k] = p
    return torch.stack(ks, dim=-2), torch.stack(ps + [p_term], dim=-2)


def forward_rollout(factors: RiccatiFactors, k_ff, A, B, c, dx0):
    """Forward pass: dx_{k+1} = A dx + B du + c with du = K dx + k.
    Returns (dx (N+1, nx), du (N, nu))."""
    N = A.shape[-3]
    dx = dx0
    dxs, dus = [], []
    for k in range(N):
        du = _mv(factors.K[..., k, :, :], dx) + k_ff[..., k, :]
        dxs.append(dx)
        dus.append(du)
        dx = (_mv(A[..., k, :, :], dx) + _mv(B[..., k, :, :], du)
              + c[..., k, :])
    dxs.append(dx)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)


def solve_lq(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term, dx0):
    """One-shot equality-constrained affine-LQ solve.  Returns
    (dx (N+1, nx), du (N, nu))."""
    factors = factorize(A, B, Qxx, Ruu, S, P_term)
    k_ff, _ = backward_vector(factors, A, B, qx, ru, c, p_term)
    return forward_rollout(factors, k_ff, A, B, c, dx0)
