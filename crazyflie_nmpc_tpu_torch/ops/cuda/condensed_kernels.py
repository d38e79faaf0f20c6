"""Sweeps of the block-2 condensed QP (K2, K3) and the expansion (K4).

Counterparts of `crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py`:
`kkt_sweep_c2`, `corrector_sweep_c2` and `expand2` (its `even_only=True`
form, fed by `prep_condense2`).  Each wrapper launches its kernel in
`csrc/condensed_c2.cu` for CUDA tensors and runs its `*_ref` plain
PyTorch version for CPU tensors.

Layout: batch-last, contiguous, B last.  M condensed stages with 13
states and 8 stacked inputs; L is the packed column-major lower Cholesky
factor of the 8x8 Quu (36 entries, `_pk`).
"""

from __future__ import annotations

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build

NX = 13
NU = 4
NUC = 2 * NU
NLC = NUC * (NUC + 1) // 2
_SOURCE = "condensed_c2.cu"


# --- small batch-last algebra on (n, m, B) tiles ---------------------------

def _mm(a, b):
    return torch.einsum("ikb,kjb->ijb", a, b)


def _mtm(a, b):
    return torch.einsum("kib,kjb->ijb", a, b)


def _mv(a, v):
    return torch.einsum("ikb,kb->ib", a, v)


def _mtv(a, v):
    return torch.einsum("kib,kb->ib", a, v)


def _pk(i, j, n):
    """Packed index of L[i, j] (i >= j), column-major lower."""
    return j * n - j * (j - 1) // 2 + (i - j)


def _chol_n(Q, n):
    """n x n Cholesky of (n, n, B) -> packed lower (n(n+1)/2, B), with
    L_jj = s * rsqrt(s) and the columns scaled by rsqrt(s)."""
    L = [None] * (n * (n + 1) // 2)
    for j in range(n):
        s = Q[j, j]
        for t in range(j):
            s = s - L[_pk(j, t, n)] * L[_pk(j, t, n)]
        inv = torch.rsqrt(s)
        L[_pk(j, j, n)] = s * inv
        for i in range(j + 1, n):
            s = Q[i, j]
            for t in range(j):
                s = s - L[_pk(i, t, n)] * L[_pk(j, t, n)]
            L[_pk(i, j, n)] = s * inv
    return torch.stack(L)


def _cho_solve_n_vec(L, y, n):
    """Solve (L L^T) x = y; y (n, ...) with trailing batch axes."""
    inv = [1.0 / L[_pk(i, i, n)] for i in range(n)]
    z = [None] * n
    for i in range(n):
        s = y[i]
        for t in range(i):
            s = s - L[_pk(i, t, n)] * z[t]
        z[i] = s * inv[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = z[i]
        for t in range(i + 1, n):
            s = s - L[_pk(t, i, n)] * x[t]
        x[i] = s * inv[i]
    return torch.stack(x)


def _cho_solve_n(L, Y, n):
    """Solve (L L^T) X = Y for Y (n, m, B): each packed entry broadcasts
    over the m columns."""
    return _cho_solve_n_vec(L[:, None, :], Y, n)


def _rollout_ref(Abar, Bbar, cbar, K, kff, dx0):
    M = Abar.shape[0]
    dx, du = [], []
    x = dx0
    for k in range(M):
        u = _mv(K[k], x) + kff[k]
        dx.append(x)
        du.append(u)
        x = _mv(Abar[k], x) + _mv(Bbar[k], u) + cbar[k]
    dx.append(x)
    return torch.stack(dx).contiguous(), torch.stack(du).contiguous()


# --- plain PyTorch versions ----------------------------------------------

def kkt_sweep_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru,
                     pT, p_term, dx0):
    """Plain PyTorch `kkt_sweep_c2` (stage loop in Python)."""
    M, _, _, B = Abar.shape
    eye = torch.eye(NX, dtype=Abar.dtype, device=Abar.device)[:, :, None]
    eye8 = torch.eye(NUC, dtype=Abar.dtype, device=Abar.device)[:, :, None]
    P = eye * pT[None]
    p = p_term
    Ks, kffs, Ls, Pcs = [None] * M, [None] * M, [None] * M, [None] * M
    for k in range(M - 1, -1, -1):
        A, Bm, c = Abar[k], Bbar[k], cbar[k]
        PA = _mm(P, A)
        PB = _mm(P, Bm)
        Pc = _mv(P, c)
        m = p + Pc
        R00p = Abar.new_zeros((NUC, NUC, B))
        R00p[:NU, :NU] = R00[k]
        Quu = _mtm(Bm, PB) + R00p + eye8 * ruu_shift[k][None]
        SxT = torch.cat([S1T[k], torch.zeros_like(S1T[k])], dim=0)
        Qux = SxT + _mtm(Bm, PA)
        Qu = ru[k] + _mtv(Bm, m)
        L = _chol_n(Quu, NUC)
        K = -_cho_solve_n(L, Qux, NUC)
        kff = -_cho_solve_n_vec(L, Qu, NUC)
        P_new = Qbar[k] + _mtm(A, PA) + _mtm(Qux, K)
        P = 0.5 * (P_new + P_new.transpose(0, 1))
        p = qx[k] + _mtv(A, m) + _mtv(K, Qu)
        Ks[k], kffs[k], Ls[k], Pcs[k] = K, kff, L, Pc
    K, kff = torch.stack(Ks).contiguous(), torch.stack(kffs).contiguous()
    dx, du = _rollout_ref(Abar, Bbar, cbar, K, kff, dx0)
    return (K, kff, torch.stack(Ls).contiguous(),
            torch.stack(Pcs).contiguous(), dx, du)


def corrector_sweep_c2_ref(Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0):
    """Plain PyTorch `corrector_sweep_c2`."""
    M = Abar.shape[0]
    p = p_term
    kffs = [None] * M
    for k in range(M - 1, -1, -1):
        m = p + Pc[k]
        Qu = ru[k] + _mtv(Bbar[k], m)
        kffs[k] = -_cho_solve_n_vec(L[k], Qu, NUC)
        p = qx[k] + _mtv(Abar[k], m) + _mtv(K[k], Qu)
    return _rollout_ref(Abar, Bbar, cbar, K, torch.stack(kffs), dx0)


def expand2_ref(Ae, Be, c, dx_even, du0):
    """Plain PyTorch `expand2` (even_only)."""
    return (torch.einsum("sijb,sjb->sib", Ae, dx_even)
            + torch.einsum("sijb,sjb->sib", Be, du0) + c[0::2]).contiguous()


# --- CUDA kernel wrappers ------------------------------------------------

def _sfx(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def kkt_sweep_c2(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru, pT,
                 p_term, dx0):
    """Dense-cost Riccati factorization + forward rollout over the condensed
    horizon.  ruu_shift (M,8,B) is R̄'s diagonal incl. the barrier shift;
    pT (13,B) the terminal Hessian diagonal.  Returns (K (M,8,13,B),
    kff (M,8,B), L (M,36,B), Pc (M,13,B), dx (M+1,13,B), du (M,8,B))."""
    if Abar.device.type == "cpu":
        return kkt_sweep_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx,
                                ruu_shift, ru, pT, p_term, dx0)
    M, _, _, B = Abar.shape
    dev, dt = Abar.device, Abar.dtype
    ins = dict(Abar=Abar, Bbar=Bbar, cbar=cbar, Qbar=Qbar, S1T=S1T, R00=R00,
               qx=qx, ruu_shift=ruu_shift, ru=ru, pT=pT, p_term=p_term,
               dx0=dx0)
    _build.check("kkt_sweep_c2", ins, dict(
        Abar=(M, NX, NX, B), Bbar=(M, NX, NUC, B), cbar=(M, NX, B),
        Qbar=(M, NX, NX, B), S1T=(M, NU, NX, B), R00=(M, NU, NU, B),
        qx=(M, NX, B), ruu_shift=(M, NUC, B), ru=(M, NUC, B), pT=(NX, B),
        p_term=(NX, B), dx0=(NX, B)), dt, dev)
    new = lambda *s: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    outs = (new(M, NUC, NX, B), new(M, NUC, B), new(M, NLC, B),
            new(M, NX, B), new(M + 1, NX, B), new(M, NUC, B))
    _build.launch(_SOURCE, f"kkt_sweep_c2_{_sfx(dt)}",
                  list(ins.values()) + list(outs), [M, B])
    kkt_sweep_c2.launches += 1
    return outs


def corrector_sweep_c2(Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0):
    """Backward vector pass on the stored factorization (K, L, Pc) +
    forward rollout.  Returns (dx (M+1,13,B), du (M,8,B))."""
    if Abar.device.type == "cpu":
        return corrector_sweep_c2_ref(Abar, Bbar, cbar, qx, ru, K, L, Pc,
                                      p_term, dx0)
    M, _, _, B = Abar.shape
    dev, dt = Abar.device, Abar.dtype
    ins = dict(Abar=Abar, Bbar=Bbar, cbar=cbar, qx=qx, ru=ru, K=K, L=L,
               Pc=Pc, p_term=p_term, dx0=dx0)
    _build.check("corrector_sweep_c2", ins, dict(
        Abar=(M, NX, NX, B), Bbar=(M, NX, NUC, B), cbar=(M, NX, B),
        qx=(M, NX, B), ru=(M, NUC, B), K=(M, NUC, NX, B), L=(M, NLC, B),
        Pc=(M, NX, B), p_term=(NX, B), dx0=(NX, B)), dt, dev)
    dx = torch.empty((M + 1, NX, B), dtype=dt, device=dev)
    du = torch.empty((M, NUC, B), dtype=dt, device=dev)
    _build.launch(_SOURCE, f"corrector_sweep_c2_{_sfx(dt)}",
                  list(ins.values()) + [dx, du], [M, B])
    corrector_sweep_c2.launches += 1
    return dx, du


def expand2(Ae, Be, c, dx_even, du0):
    """Eliminated states: dx_odd[k] = Ae[k] dx_even[k] + Be[k] du0[k]
    + c[2k], with Ae/Be the even-stage Jacobians (M,13,13,B)/(M,13,4,B)
    and c the full-horizon defect (N,13,B).  Returns (M,13,B)."""
    if Ae.device.type == "cpu":
        return expand2_ref(Ae, Be, c, dx_even, du0)
    M, _, _, B = Ae.shape
    dev, dt = Ae.device, Ae.dtype
    ins = dict(Ae=Ae, Be=Be, c=c, dx_even=dx_even, du0=du0)
    _build.check("expand2", ins, dict(
        Ae=(M, NX, NX, B), Be=(M, NX, NU, B), c=(2 * M, NX, B),
        dx_even=(M, NX, B), du0=(M, NU, B)), dt, dev)
    out = torch.empty((M, NX, B), dtype=dt, device=dev)
    _build.launch(_SOURCE, f"expand2_{_sfx(dt)}",
                  list(ins.values()) + [out], [M, B])
    expand2.launches += 1
    return out


kkt_sweep_c2.launches = 0
corrector_sweep_c2.launches = 0
expand2.launches = 0
