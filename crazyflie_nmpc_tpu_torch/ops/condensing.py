"""Partial condensing: N stages to N/b blocks with b*nu-wide inputs
(PyTorch counterpart of `ops/condensing.py`).

Within each block of `b` consecutive stages the intermediate states are
eliminated by forward substitution,

    dx_j = Phi_j dx + Gamma_j v + h_j,    v = [du_0; ...; du_{b-1}],

which leaves a multistage QP with N/b stages, state dim nx and input dim
b*nu, solved by the same interior-point method (`ops.ipm` is
dimension-agnostic); the full-horizon solution comes back by block-local
expansion.  All blocks are condensed at once (the block axis is a batch
axis of every product).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.ops.qp import QPData


class BlockMaps(NamedTuple):
    """Per-block substitution maps for the expansion.

    Shapes (M blocks, b stages/block): Phi (M, b, nx, nx),
    Gamma (M, b, nx, b*nu), h (M, b, nx).
    """

    Phi: torch.Tensor
    Gamma: torch.Tensor
    h: torch.Tensor


def _t(m):
    return m.transpose(-1, -2)


def _mv(a, v):
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def _condense_blocks(A, B, c, Qxx, qx, Ruu, ru, S):
    """Condense every block; inputs are (M, b, ...) block-stacked."""
    M, b, nx, nu = B.shape
    nv = b * nu
    dtype, dev = A.dtype, A.device

    # forward substitution maps for dx_j, j = 0..b (j = b: the block exit)
    Phi = torch.eye(nx, dtype=dtype, device=dev).expand(M, nx, nx)
    Gamma = torch.zeros((M, nx, nv), dtype=dtype, device=dev)
    h = torch.zeros((M, nx), dtype=dtype, device=dev)
    Phis, Gammas, hs = [], [], []
    for j in range(b):
        Phis.append(Phi)
        Gammas.append(Gamma)
        hs.append(h)
        A_j = A[:, j]
        Gamma_n = A_j @ Gamma
        # column block j of Gamma is B_j
        Gamma = torch.cat([Gamma_n[..., :j * nu], B[:, j],
                           Gamma_n[..., (j + 1) * nu:]], dim=-1)
        Phi = A_j @ Phi
        h = _mv(A_j, h) + c[:, j]

    # the condensed cost blocks, accumulated over the b interior stages
    Qbar = torch.zeros((M, nx, nx), dtype=dtype, device=dev)
    Rbar = torch.zeros((M, nv, nv), dtype=dtype, device=dev)
    Sbar = torch.zeros((M, nv, nx), dtype=dtype, device=dev)
    qbar = torch.zeros((M, nx), dtype=dtype, device=dev)
    rbar = torch.zeros((M, nv), dtype=dtype, device=dev)
    for j in range(b):
        Phi_j, Gamma_j, h_j = Phis[j], Gammas[j], hs[j]
        Q_j, S_j = Qxx[:, j], S[:, j]
        QPhi = Q_j @ Phi_j
        QGam = Q_j @ Gamma_j
        Qh_q = _mv(Q_j, h_j) + qx[:, j]
        Qbar = Qbar + _t(Phi_j) @ QPhi
        Rbar = Rbar + _t(Gamma_j) @ QGam
        Sbar = Sbar + _t(Gamma_j) @ QPhi
        qbar = qbar + _mv(_t(Phi_j), Qh_q)
        rbar = rbar + _mv(_t(Gamma_j), Qh_q)
        # du_j' S_j dx_j  and  1/2 du_j' R_j du_j + r_j' du_j
        rows = slice(j * nu, (j + 1) * nu)
        Sbar = Sbar.clone()
        Sbar[:, rows] = Sbar[:, rows] + S_j @ Phi_j
        cross = torch.zeros((M, nv, nv), dtype=dtype, device=dev)
        cross[:, rows] = S_j @ Gamma_j
        Rbar = Rbar + cross + _t(cross)
        Rblk = torch.zeros((M, nv, nv), dtype=dtype, device=dev)
        Rblk[:, rows, rows] = Ruu[:, j]
        Rbar = Rbar + Rblk
        rbar = rbar.clone()
        rbar[:, rows] = rbar[:, rows] + (ru[:, j] + _mv(S_j, h_j))

    return (Phi, Gamma, h, Qbar, qbar, Rbar, rbar, Sbar,
            torch.stack(Phis, dim=1), torch.stack(Gammas, dim=1),
            torch.stack(hs, dim=1))


def condense(qp: QPData, block: int):
    """Partially condense `qp` with block size b (must divide N).

    Returns (reduced QPData with N/b stages and b*nu-wide inputs,
    BlockMaps for the expansion).
    """
    N = qp.c.shape[0]
    nu = qp.ru.shape[-1]
    if N % block != 0:
        raise ValueError(f"block {block} must divide horizon {N}")
    M = N // block

    def blocks(x):
        return x.reshape((M, block) + tuple(x.shape[1:]))

    (Ab, Bb, cb, Qb, qb, Rb, rb, Sb, Phis, Gammas, hs) = _condense_blocks(
        blocks(qp.A), blocks(qp.B), blocks(qp.c), blocks(qp.Qxx),
        blocks(qp.qx), blocks(qp.Ruu), blocks(qp.ru), blocks(qp.S))
    reduced = QPData(A=Ab, B=Bb, c=cb, Qxx=Qb, qx=qb, Ruu=Rb, ru=rb, S=Sb,
                     P=qp.P, p=qp.p, lb=qp.lb.reshape(M, block * nu),
                     ub=qp.ub.reshape(M, block * nu), dx0=qp.dx0)
    return reduced, BlockMaps(Phi=Phis, Gamma=Gammas, h=hs)


def expand(maps: BlockMaps, dx_red: torch.Tensor, v_red: torch.Tensor):
    """Recover the full-horizon solution from the reduced one: dx_red
    (M+1, nx) block entry states (and the final one), v_red (M, b*nu).
    Returns (dx (N+1, nx), du (N, nu))."""
    M, b, nx = maps.Phi.shape[0], maps.Phi.shape[1], maps.Phi.shape[2]
    nu = maps.Gamma.shape[-1] // b
    dx_inner = (torch.einsum("mjab,mb->mja", maps.Phi, dx_red[:-1])
                + torch.einsum("mjav,mv->mja", maps.Gamma, v_red) + maps.h)
    dx_full = torch.cat([dx_inner.reshape(M * b, nx), dx_red[-1:]], dim=0)
    return dx_full, v_red.reshape(M * b, nu)


def solve_partial(qp: QPData, block: int, config=None):
    """Solve `qp` by partial condensing + the interior-point method +
    expansion: `ipm.solve`'s IPMSolution contract, the bound duals
    reshaped back to per-stage (N, nu)."""
    from crazyflie_nmpc_tpu_torch.ops import ipm

    config = config or ipm.IPMConfig()
    N = qp.c.shape[0]
    nu = qp.ru.shape[-1]
    reduced, maps = condense(qp, block)
    sol = ipm.solve(reduced, config)
    dx_full, du_full = expand(maps, sol.dx, sol.du)
    return ipm.IPMSolution(dx=dx_full, du=du_full,
                           lam_l=sol.lam_l.reshape(N, nu),
                           lam_u=sol.lam_u.reshape(N, nu), stats=sol.stats)
