"""Associative-scan Riccati: log-depth backward pass over the horizon
(PyTorch counterpart of `ops/riccati_pscan.py`).

STATUS: research module, as in the JAX package: parity-tested against the
sequential `ops.riccati` and wired into no product path.  The JAX package
demoted it on a TPU measurement (the sequential sweep won at every horizon
there); `chip_smoke.py` [pscan] measures the crossover on the GPU, where
the sequential sweep is a Python loop of small launches.

The sequential Riccati recursion is O(N) *depth*.  This module
reformulates the backward pass as an ASSOCIATIVE operation on per-stage
"conditional value-function" elements, so a parallel scan evaluates all N
cost-to-go functions in O(log N) depth (the temporal-parallelization
construction of Särkkä & García-Fernández, parallel LQT; see PAPERS.md),
and the forward rollout parallelizes the same way as a composition of
affine maps.

Math.  A stage with dynamics z = A x + B u + c and cost
½x'Qx + q'x + ½u'Ru + r'u + u'Sx induces, after eliminating u, the
entry/exit cost kernel

    S(x, z) = ½ x'J x − η'x + quad(z − Ã x − b; C)

with Ã = A − B R⁻¹S, b = c − B R⁻¹r, C = B R⁻¹B' (singular, never
inverted), J = Q − S'R⁻¹S, η = −(q − S'R⁻¹r).  Composition
S_ij(x,z) = min_y S_i(x,y) + S_j(y,z) is closed under this 5-tuple:

    M   = (I + C_i J_j)⁻¹
    A'' = A_j M A_i
    b'' = A_j M (b_i + C_i η_j) + b_j
    C'' = A_j M C_i A_j' + C_j
    η'' = A_i' (I + J_j C_i)⁻¹ (η_j − J_j b_i) + η_i
    J'' = A_i' (I + J_j C_i)⁻¹ J_j A_i + J_i

and a reversed associative scan of stages k..N yields the cost-to-go
V_k(x) = ½ x'P_k x + p_k'x with P_k = J_{k:N}, p_k = −η_{k:N}.

PyTorch has no associative scan, so `associative_scan` below is the
recursion of `jax.lax.associative_scan`: combine adjacent pairs, scan the
half-length sequence, then fill the remaining positions, about 2 log2 N
rounds of one batched combine each.  Every solve is `linalg.solve_ex` /
`cholesky_ex` without its error check: the scan never waits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.ops import riccati as riccati_seq


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


def _t(m):
    return m.transpose(-1, -2)


def _mv(a, v):
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _solve(A, B):
    """A^-1 B without the error check (`solve_ex`: no host sync)."""
    return torch.linalg.solve_ex(A, B)[0]


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Compose earlier element ei with later element ej (batched over the
    leading scan axis)."""
    nx = ei.A.shape[-1]
    eye = torch.eye(nx, dtype=ei.A.dtype, device=ei.A.device).expand(
        ei.A.shape)
    # solves instead of inverses; (I + C_i J_j) is nonsingular for convex
    # stage costs (C psd, J psd)
    M = _solve(eye + ei.C @ ej.J, eye)
    Mt = _solve(eye + ej.J @ ei.C, eye)
    AjM = ej.A @ M
    A = AjM @ ei.A
    b = _mv(AjM, ei.b + _mv(ei.C, ej.eta)) + ej.b
    C = AjM @ ei.C @ _t(ej.A) + ej.C
    AiT = _t(ei.A)
    rhs = ej.eta - _mv(ej.J, ei.b)
    eta = _mv(AiT @ Mt, rhs) + ei.eta
    J = AiT @ Mt @ ej.J @ ei.A + ei.J
    J = 0.5 * (J + _t(J))
    return _Elem(A=A, b=b, C=C, eta=eta, J=J)


def _interleave(a, b):
    """a0 b0 a1 b1 ... along axis 0 (len(a) is len(b) or len(b) + 1)."""
    n = b.shape[0]
    out = torch.stack([a[:n], b], dim=1).flatten(0, 1)
    return torch.cat([out, a[n:]]) if a.shape[0] > n else out


def associative_scan(fn, elems, reverse: bool = False):
    """Inclusive scan of `elems` (a NamedTuple of tensors, scanned along
    axis 0) under the associative `fn(earlier, later)`, by the recursion
    of `jax.lax.associative_scan`; `reverse=True` scans from the end (the
    sequence is reversed, scanned, and reversed back, so `fn`'s left
    operand is then the LATER element, as in JAX)."""
    kind = type(elems)

    def rev(e):
        return kind(*(x.flip(0) for x in e))

    def scan(e):
        n = e[0].shape[0]
        if n < 2:
            return e
        # combine adjacent pairs, scan the reduced sequence
        odd = scan(fn(kind(*(x[0:-1:2] for x in e)),
                      kind(*(x[1::2] for x in e))))
        # the remaining (even) positions: each from the scanned position
        # before it
        if n % 2 == 0:
            even = fn(kind(*(x[:-1] for x in odd)),
                      kind(*(x[2::2] for x in e)))
        else:
            even = fn(odd, kind(*(x[2::2] for x in e)))
        even = kind(*(torch.cat([x[:1], y]) for x, y in zip(e, even)))
        return kind(*(_interleave(a, b) for a, b in zip(even, odd)))

    out = scan(rev(elems) if reverse else elems)
    return rev(out) if reverse else out


def cost_to_go_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term):
    """All cost-to-go pairs (P_k, p_k), k = 0..N, in O(log N) depth.

    Same arguments as `riccati.factorize`/`backward_vector` combined.
    Returns (P (N+1, nx, nx), p (N+1, nx)).
    """
    N, nx, nu = B.shape

    Rinv_r = _solve(Ruu, ru.unsqueeze(-1)).squeeze(-1)          # (N, nu)
    Rinv_S = _solve(Ruu, S)                                     # (N, nu, nx)
    Rinv_Bt = _solve(Ruu, _t(B))                                # (N, nu, nx)

    A_t = A - B @ Rinv_S
    b = c - _mv(B, Rinv_r)
    C = B @ Rinv_Bt
    J = Qxx - _t(S) @ Rinv_S
    eta = -(qx - _mv(_t(S), Rinv_r))

    # terminal element: absorbs z-dependence (A = 0, C = 0)
    z_m = torch.zeros((1, nx, nx), dtype=A.dtype, device=A.device)
    elems = _Elem(
        A=torch.cat([A_t, z_m]),
        b=torch.cat([b, torch.zeros((1, nx), dtype=A.dtype,
                                    device=A.device)]),
        C=torch.cat([C, z_m]),
        eta=torch.cat([eta, -p_term.unsqueeze(0)]),
        J=torch.cat([J, P_term.unsqueeze(0)]),
    )
    # reverse=True reverses the sequence before prefix-combining, so the
    # operator's LEFT operand is the LATER element: swap back to keep
    # _combine's (earlier, later) convention.
    suffix = associative_scan(lambda a, b: _combine(b, a), elems,
                              reverse=True)
    return suffix.J, -suffix.eta


class _Affine(NamedTuple):
    M: torch.Tensor
    v: torch.Tensor


def _compose(f: _Affine, g: _Affine) -> _Affine:
    """Apply g after f: x -> g.M (f.M x + f.v) + g.v."""
    return _Affine(g.M @ f.M, _mv(g.M, f.v) + g.v)


def solve_lq_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term, dx0):
    """Full equality-constrained LQ solve in O(log N) depth.

    Backward: associative-scan cost-to-go; per-stage gains are then local.
    Forward: the closed-loop rollout dx_{k+1} = (A+BK)dx + (B kff + c) is a
    composition of affine maps, also an associative scan.
    Matches `riccati.solve_lq`.  Returns (dx (N+1, nx), du (N, nu)).
    """
    P, p = cost_to_go_pscan(A, B, c, Qxx, qx, Ruu, ru, S, P_term, p_term)
    P_next, p_next = P[1:], p[1:]

    Bt = _t(B)
    Quu = Ruu + Bt @ P_next @ B
    Qux = S + Bt @ P_next @ A
    m = p_next + _mv(P_next, c)
    Qu = ru + _mv(Bt, m)
    K = -_solve(Quu, Qux)
    kff = -_solve(Quu, Qu.unsqueeze(-1)).squeeze(-1)

    # forward pass as an associative scan of affine maps (M, v):
    # dx_{k+1} = M_k dx_k + v_k with M = A + B K, v = B kff + c
    maps = associative_scan(_compose, _Affine(A + B @ K, _mv(B, kff) + c))
    dx_tail = _mv(maps.M, dx0.unsqueeze(0)) + maps.v        # dx_1..dx_N
    dx = torch.cat([dx0.unsqueeze(0), dx_tail])
    du = _mv(K, dx[:-1]) + kff
    return dx, du


def factors_pscan(A, B, Qxx, Ruu, S, P_term):
    """RiccatiFactors (P, K, Quu_chol) via the parallel scan: drop-in for
    `riccati.factorize` where only the quadratic terms matter."""
    N, nx, nu = B.shape
    kw = dict(dtype=A.dtype, device=A.device)
    P, _ = cost_to_go_pscan(A, B, torch.zeros((N, nx), **kw), Qxx,
                            torch.zeros((N, nx), **kw), Ruu,
                            torch.zeros((N, nu), **kw), S, P_term,
                            torch.zeros((nx,), **kw))
    P_next = P[1:]
    Bt = _t(B)
    Quu = Ruu + Bt @ P_next @ B
    Qux = S + Bt @ P_next @ A
    K = -_solve(Quu, Qux)
    chol, _ = torch.linalg.cholesky_ex(Quu)
    return riccati_seq.RiccatiFactors(P=P, K=K, Quu_chol=chol)
