"""Block-2 condensing, the sweeps of the condensed QP and the expansion.

Counterparts of `crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py`:
`condense2` (K6), `kkt_sweep_c2` (K2), `corrector_sweep_c2` (K3),
`expand2` (K4: stride 1 is the `even_only=True` form fed by
`prep_condense2`, stride 2 reads the full-horizon A/B), the split
long-horizon sweeps `kkt_sweep_c2_win` / `corrector_sweep_c2_win` (K5: the
kernels `bwd_c2`, `fwd_c2`, `bwd_vec_c2`) and the one-launch Mehrotra
iteration `iter_sweep_c2` (K10).  Each kernel wrapper launches its kernel in
`csrc/kkt_sweep_c2.cu` (K2, and K5a `bwd_c2`: K2's factorization alone),
`csrc/corrector_sweep_c2.cu` (K3, K5b `fwd_c2`: K3's rollout alone, and
K5c `bwd_vec_c2`: K3's vector pass alone) or `csrc/iter_c2.cu` (K10), a
group of threads per lane each (their launch shapes are
`kkt_launch_geometry`'s, `bwd_launch_geometry`'s,
`corr_launch_geometry`'s, `fwd_launch_geometry`'s,
`bwd_vec_launch_geometry`'s and `iter_launch_geometry`'s), or
`csrc/condensed_c2.cu` (K4 one thread per lane and pair; K6 on K1's block
of 32 lanes and 8 threads a lane, `condense_launch_geometry`'s) for CUDA
tensors, and runs its `*_ref` plain PyTorch version for CPU tensors.

Layout: batch-last, contiguous, B last.  M condensed stages with 13
states and 8 stacked inputs; L is the packed column-major lower Cholesky
factor of the 8x8 Quu (36 entries, `_pk`).

Compressed streams (`IPMConfig.compress_gains` / `compress_ab`, the JAX
module's note): `kkt_sweep_c2(gains_dtype=torch.bfloat16)` writes K, L
and Pc in bfloat16 for `corrector_sweep_c2` to re-read, while kff and the
rollout stay in the compute dtype (the rollout uses the full-precision K);
`a_dev=True` marks the stage stream as deviation-coded: Abar - I, Bbar and
cbar arrive in bfloat16 and the identity is added back at load.  All
arithmetic stays in the compute dtype, the dtype of Qbar (K2) or qx (K3).
A float64 value rounds to bfloat16 through float32, in the kernels as in
PyTorch's casts.
"""

from __future__ import annotations

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build

NX = 13
NU = 4
NUC = 2 * NU
NLC = NUC * (NUC + 1) // 2
_SOURCE = "condensed_c2.cu"
_KKT_SOURCE = "kkt_sweep_c2.cu"
# K2's launch shape (csrc/kkt_sweep_c2.cu's kGroup, kThreads and kStride,
# which its launch checks): KKT_GROUP threads per lane, KKT_LANES lanes a
# block, KKT_LANE_VALUES values of the compute dtype in shared memory per
# lane
KKT_GROUP = 16
KKT_THREADS = 128
KKT_LANES = KKT_THREADS // KKT_GROUP
KKT_LANE_VALUES = 1548
# K5a's (bwd_c2, in K2's source): K2's group and block, and a second set of
# two cost inputs a lane
BWD_LANE_VALUES = 1740
# K3's, from csrc/corrector_sweep_c2.cu in the same way
_CORR_SOURCE = "corrector_sweep_c2.cu"
CORR_GROUP = 16
CORR_THREADS = 256
CORR_LANES = CORR_THREADS // CORR_GROUP
CORR_LANE_VALUES = 996
# K5b's (fwd_c2, in K3's source): K3's group and block, a lane of its own
FWD_GROUP = 16
FWD_THREADS = 256
FWD_LANES = FWD_THREADS // FWD_GROUP
FWD_LANE_VALUES = 856  # kFwdLaneValues
# K5c's (bwd_vec_c2, K3's body without its rollout): K3's group and block,
# a lane of its own
BWD_VEC_GROUP = 16
BWD_VEC_THREADS = 256
BWD_VEC_LANES = BWD_VEC_THREADS // BWD_VEC_GROUP
BWD_VEC_LANE_VALUES = 954  # kVecLaneValues
_ITER_SOURCE = "iter_c2.cu"
# K10's (csrc/iter_c2.cu's kGroup, kThreads and kStride): K2's group and
# block, a lane of its own
ITER_GROUP = 16
ITER_THREADS = 128
ITER_LANES = ITER_THREADS // ITER_GROUP
ITER_LANE_VALUES = 1612
# K6's (csrc/condensed_c2.cu's kLanes, kThreads and kLaneValues, K1's
# block): CONDENSE_LANES lanes of one stage pair a block,
# CONDENSE_THREADS // CONDENSE_LANES threads (workers) a lane
CONDENSE_LANES = 32
CONDENSE_THREADS = 256
CONDENSE_LANE_VALUES = 299
# fraction-to-boundary ratio of a non-binding entry (the Pallas kernel's)
_BIG = 3.4e38


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


# --- plain PyTorch versions ----------------------------------------------

def fwd_c2_ref(Abar, Bbar, cbar, K, kff, dx0):
    """Plain PyTorch `_fwd_c2_kernel`: the rollout du_k = K_k dx_k + kff_k,
    dx_{k+1} = A dx + B du + c.  Returns (dx (M+1,13,B), du (M,8,B)); any
    input width (the uncondensed sweeps' rollout is this one with 4)."""
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


def c2_stage_ref(P, p, A, Bm, c, Q, S1T, R00, qx, ruu_shift, ru):
    """One backward stage of the dense-cost Riccati recursion on the
    cost-to-go (P, p) of the next stage, for one stage's (n, m, B) data.
    Returns this stage's (P, p, K, kff, L, Pc)."""
    B = A.shape[-1]
    eye8 = torch.eye(NUC, dtype=A.dtype, device=A.device)[:, :, None]
    PA = _mm(P, A)
    PB = _mm(P, Bm)
    Pc = _mv(P, c)
    m = p + Pc
    R00p = A.new_zeros((NUC, NUC, B))
    R00p[:NU, :NU] = R00
    Quu = _mtm(Bm, PB) + R00p + eye8 * ruu_shift[None]
    SxT = torch.cat([S1T, torch.zeros_like(S1T)], dim=0)
    Qux = SxT + _mtm(Bm, PA)
    Qu = ru + _mtv(Bm, m)
    L = _chol_n(Quu, NUC)
    K = -_cho_solve_n(L, Qux, NUC)
    kff = -_cho_solve_n_vec(L, Qu, NUC)
    P_new = Q + _mtm(A, PA) + _mtm(Qux, K)
    return (0.5 * (P_new + P_new.transpose(0, 1)),
            qx + _mtv(A, m) + _mtv(K, Qu), K, kff, L, Pc)


def bwd_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru, pT,
               p_term):
    """Plain PyTorch `_bwd_c2_kernel`: the backward factorization.
    Returns (K (M,8,13,B), kff (M,8,B), L (M,36,B), Pc (M,13,B))."""
    M = Abar.shape[0]
    eye = torch.eye(NX, dtype=Abar.dtype, device=Abar.device)[:, :, None]
    P = eye * pT[None]
    p = p_term
    Ks, kffs, Ls, Pcs = [None] * M, [None] * M, [None] * M, [None] * M
    for k in range(M - 1, -1, -1):
        P, p, Ks[k], kffs[k], Ls[k], Pcs[k] = c2_stage_ref(
            P, p, Abar[k], Bbar[k], cbar[k], Qbar[k], S1T[k], R00[k], qx[k],
            ruu_shift[k], ru[k])
    return tuple(torch.stack(z).contiguous() for z in (Ks, kffs, Ls, Pcs))


def bwd_vec_c2_ref(Abar, Bbar, qx, ru, K, L, Pc, p_term):
    """Plain PyTorch `_bwd_vec_c2_kernel`: the backward vector pass on the
    stored factorization.  Returns kff (M,8,B); any input width, as
    `fwd_c2_ref`."""
    M, nu = Abar.shape[0], Bbar.shape[2]
    p = p_term
    kffs = [None] * M
    for k in range(M - 1, -1, -1):
        m = p + Pc[k]
        Qu = ru[k] + _mtv(Bbar[k], m)
        kffs[k] = -_cho_solve_n_vec(L[k], Qu, nu)
        p = qx[k] + _mtv(Abar[k], m) + _mtv(K[k], Qu)
    return torch.stack(kffs).contiguous()


def _load_stream(Abar, Bbar, cbar, dtype, a_dev):
    """The stage stream in the compute dtype: bfloat16 entries upcast, the
    identity added back to a deviation-coded Abar (`_ld_A`)."""
    A, Bm, c = (t.to(dtype) for t in (Abar, Bbar, cbar))
    if a_dev:
        A = A + torch.eye(NX, dtype=dtype, device=A.device)[:, :, None]
    return A, Bm, c


def kkt_sweep_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru,
                     pT, p_term, dx0, gains_dtype=None, a_dev=False):
    """Plain PyTorch `kkt_sweep_c2` (stage loop in Python), compressed
    forms included: the rollout runs on the full-precision gains, which are
    then rounded to `gains_dtype`."""
    A, Bm, c = _load_stream(Abar, Bbar, cbar, Qbar.dtype, a_dev)
    K, kff, L, Pc = bwd_c2_ref(A, Bm, c, Qbar, S1T, R00, qx, ruu_shift, ru,
                               pT, p_term)
    dx, du = fwd_c2_ref(A, Bm, c, K, kff, dx0)
    if gains_dtype is not None:
        K, L, Pc = (t.to(gains_dtype) for t in (K, L, Pc))
    return K, kff, L, Pc, dx, du


def corrector_sweep_c2_ref(Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0,
                           a_dev=False):
    """Plain PyTorch `corrector_sweep_c2`, compressed forms included (every
    stream upcast to qx's dtype at load)."""
    dtype = qx.dtype
    A, Bm, c = _load_stream(Abar, Bbar, cbar, dtype, a_dev)
    K, L, Pc = (t.to(dtype) for t in (K, L, Pc))
    kff = bwd_vec_c2_ref(A, Bm, qx, ru, K, L, Pc, p_term)
    return fwd_c2_ref(A, Bm, c, K, kff, dx0)


def _min_ratio(pairs):
    """Per-lane fraction-to-boundary minimum over the (M, 8) entries of
    every (v, dv) pair: -v/dv where dv < 0, else BIG."""
    ratio = None
    for v, dv in pairs:
        r = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), _BIG)
        ratio = r if ratio is None else torch.minimum(ratio, r)
    return torch.amin(ratio, dim=(0, 1))


def iter_sweep_c2_ref(Abar, Bbar, c_res, Qbar, S1T, R00, qx, ruu, r1u,
                      s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, z_dx, z_du,
                      pT, r1x_T, dx0_res, z_dxT, n_ineq, has_ineq,
                      tau: float):
    """Plain PyTorch `_iter_c2_kernel`: one Mehrotra iteration, written
    from the Pallas kernel's phases (the recursions are the stage loops
    above, the barrier algebra is elementwise over the horizon).  Pure:
    returns the 16 outputs of `iter_sweep_c2` as new tensors."""
    finfo = torch.finfo(c_res.dtype)
    mu_floor = 100.0 * finfo.eps ** 2
    n = n_ineq[0]

    # phase 0: barrier shift, affine right-hand side, factorization
    r5l, r5u = lam_l * s_l, lam_u * s_u
    S0 = (r5l + r5u).sum(dim=(0, 1))
    ruu_shift = ruu + lam_l / s_l + lam_u / s_u
    rt1u = r1u + (r5l + lam_l * r3) / s_l - (r5u + lam_u * r4) / s_u
    K, kff, L, Pc = bwd_c2_ref(Abar, Bbar, c_res, Qbar, S1T, R00, qx,
                               ruu_shift, rt1u, pT, r1x_T)
    # phase 1: affine rollout, directions, mu_aff sums -> sigma mu
    _, du_a = fwd_c2_ref(Abar, Bbar, c_res, K, kff, dx0_res)
    ds_l = m_l * (du_a + r3)
    ds_u = m_u * (r4 - du_a)
    dl_l = -(lam_l * s_l + lam_l * ds_l) / s_l
    dl_u = -(lam_u * s_u + lam_u * ds_u) / s_u
    S1 = (lam_l * ds_l + s_l * dl_l + lam_u * ds_u + s_u * dl_u).sum(
        dim=(0, 1))
    S2 = (dl_l * ds_l + dl_u * ds_u).sum(dim=(0, 1))
    a = torch.clamp(_min_ratio(((s_l, ds_l), (s_u, ds_u), (lam_l, dl_l),
                                (lam_u, dl_u))), max=1.0)
    mu = S0 / n
    mu_aff = (S0 + a * S1 + a * a * S2) / n
    sig = mu_aff / torch.clamp(mu, min=finfo.tiny)
    sigmu = torch.clamp(sig * sig * sig, 0.0, 1.0) * mu
    # phase 2: corrected right-hand side, vector pass
    r5c_l = r5l - sigmu + ds_l * dl_l
    r5c_u = r5u - sigmu + ds_u * dl_u
    rt1u_c = (r1u + m_l * (r5c_l + lam_l * r3) / s_l
              - m_u * (r5c_u + lam_u * r4) / s_u)
    kff_c = bwd_vec_c2_ref(Abar, Bbar, qx, rt1u_c, K, L, Pc, r1x_T)
    # phase 3: corrector rollout, directions, step length
    ddx, du = fwd_c2_ref(Abar, Bbar, c_res, K, kff_c, dx0_res)
    ds_l = m_l * (du + r3)
    ds_u = m_u * (r4 - du)
    dl_l = -m_l * (r5c_l + lam_l * ds_l) / s_l
    dl_u = -m_u * (r5c_u + lam_u * ds_u) / s_u
    alpha = torch.clamp(tau * _min_ratio(((s_l, ds_l), (s_u, ds_u),
                                          (lam_l, dl_l), (lam_u, dl_u))),
                        max=1.0)
    alpha = torch.where((has_ineq[0] > 0) & (mu <= mu_floor), 0.0, alpha)
    # phase 4: update
    shrink = 1.0 - alpha
    return (z_dx + alpha * ddx[:-1], z_du + alpha * du,
            s_l + alpha * ds_l, s_u + alpha * ds_u,
            lam_l + alpha * dl_l, lam_u + alpha * dl_u,
            shrink * qx, shrink * r1u, shrink * c_res,
            shrink * r3, shrink * r4,
            shrink * r1x_T, shrink * dx0_res, z_dxT + alpha * ddx[-1],
            alpha[None], mu[None])


def condense2_ref(A, Bm, c, qxx, qx, ru):
    """Plain PyTorch `condense2` (all pairs at once)."""
    A0, A1, B0, B1 = A[0::2], A[1::2], Bm[0::2], Bm[1::2]
    c0, c1 = c[0::2], c[1::2]
    q1 = qxx[1::2]                  # the eliminated state's cost diagonal
    qA = q1[:, :, None] * A0
    qB = q1[:, :, None] * B0
    eye = torch.eye(NX, dtype=A.dtype, device=A.device)[:, :, None]
    h = q1 * c0 + qx[1::2]
    cnd = dict(
        Abar=torch.einsum("sikb,skjb->sijb", A1, A0),
        Bbar=torch.cat([torch.einsum("sikb,skjb->sijb", A1, B0), B1], dim=2),
        cbar=torch.einsum("sikb,skb->sib", A1, c0) + c1,
        Qbar=(torch.einsum("skib,skjb->sijb", A0, qA)
              + eye * qxx[0::2][:, None]),
        S1T=torch.einsum("skib,skjb->sijb", B0, qA),
        R00=torch.einsum("skib,skjb->sijb", B0, qB),
        qbar=qx[0::2] + torch.einsum("skib,skb->sib", A0, h),
        rbar=torch.cat([ru[0::2] + torch.einsum("skib,skb->sib", B0, h),
                        ru[1::2]], dim=1))
    return {k: v.contiguous() for k, v in cnd.items()}


def expand2_ref(Ae, Be, c, dx_even, du0, stride=1):
    """Plain PyTorch `expand2`: stride 1 takes the even-stage Ae/Be
    (even_only), stride 2 the full-horizon A/B."""
    return (torch.einsum("sijb,sjb->sib", Ae[0::stride], dx_even)
            + torch.einsum("sijb,sjb->sib", Be[0::stride], du0)
            + c[0::2]).contiguous()


# --- CUDA kernel wrappers ------------------------------------------------

def _shapes(M, B):
    """The expected shape of every named kernel argument at (M, B)."""
    s8, s13, t13 = (M, NUC, B), (M, NX, B), (NX, B)
    return dict(
        Ae=(M, NX, NX, B), Be=(M, NX, NU, B), c=(2 * M, NX, B),
        dx_even=s13, du0=(M, NU, B),
        Abar=(M, NX, NX, B), Bbar=(M, NX, NUC, B), Qbar=(M, NX, NX, B),
        S1T=(M, NU, NX, B), R00=(M, NU, NU, B), K=(M, NUC, NX, B),
        L=(M, NLC, B), K_all=(M, NUC, NX, B), L_all=(M, NLC, B),
        n_ineq=(1, B), has_ineq=(1, B),
        **dict.fromkeys(("cbar", "c_res", "qx", "Pc", "z_dx", "Pc_all",
                         "ddx_all"), s13),
        **dict.fromkeys(("ruu_shift", "ruu", "ru", "r1u", "kff", "s_l",
                         "s_u", "lam_l", "lam_u", "r3", "r4", "m_l", "m_u",
                         "z_du", "kff_all", "dua_all", "du_all"), s8),
        **dict.fromkeys(("pT", "p_term", "dx0", "r1x_T", "dx0_res",
                         "z_dxT"), t13))


def stage_shapes(N, B):
    """The expected shape of every named argument of the uncondensed
    stage-wise kernels (`condense2`'s inputs, `riccati_kernels`) at
    (N, B): 13 states, 4 inputs, L the packed 4x4 Cholesky factor."""
    s4, s13, t13 = (N, NU, B), (N, NX, B), (NX, B)
    return dict(
        A=(N, NX, NX, B), Bm=(N, NX, NU, B), K=(N, NU, NX, B),
        L=(N, NU * (NU + 1) // 2, B),
        **dict.fromkeys(("c", "qxx", "qx", "Pc"), s13),
        **dict.fromkeys(("ruu", "ru", "kff"), s4),
        **dict.fromkeys(("pT", "p_term", "dx0"), t13))


_STREAM = ("Abar", "Bbar", "cbar")
_GAINS = ("K", "L", "Pc")


def _form(a_dev, stream, gains):
    """The compressed form's symbol suffix: "_g" with bfloat16 gains, "_a"
    with the deviation-coded bfloat16 stage stream, "_ga" with both, ""
    with neither; and the names of its bfloat16 inputs.  Raises ValueError
    for a mix the kernels do not take (a_dev with a full-precision stream,
    or a bfloat16 stream without a_dev)."""
    bf = [t.dtype == torch.bfloat16 for t in stream]
    if not (all(bf) if a_dev else not any(bf)):
        raise ValueError("a_dev=True takes the deviation-coded stream (Abar "
                         "- I, Bbar, cbar) in bfloat16, a_dev=False the "
                         "full-precision one")
    tag = "g" * bool(gains) + "a" * bool(a_dev)
    return ("_" + tag if tag else ""), _STREAM * bool(a_dev)


def _empty(like, *shape):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def kkt_launch_geometry(B: int, dtype) -> dict:
    """K2's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, KKT_LANES, KKT_THREADS,
                                KKT_LANE_VALUES)


def bwd_launch_geometry(B: int, dtype) -> dict:
    """K5a's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, KKT_LANES, KKT_THREADS,
                                BWD_LANE_VALUES)


def corr_launch_geometry(B: int, dtype) -> dict:
    """K3's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, CORR_LANES, CORR_THREADS,
                                CORR_LANE_VALUES)


def fwd_launch_geometry(B: int, dtype) -> dict:
    """K5b's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, FWD_LANES, FWD_THREADS,
                                FWD_LANE_VALUES)


def bwd_vec_launch_geometry(B: int, dtype) -> dict:
    """K5c's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, BWD_VEC_LANES, BWD_VEC_THREADS,
                                BWD_VEC_LANE_VALUES)


def iter_launch_geometry(B: int, dtype) -> dict:
    """K10's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, ITER_LANES, ITER_THREADS,
                                ITER_LANE_VALUES)


def condense_launch_geometry(B: int, dtype) -> dict:
    """K6's launch at B lanes of `dtype` (`_build.lane_geometry`; the
    grid's second axis is the M stage pairs)."""
    return _build.lane_geometry(B, dtype, CONDENSE_LANES, CONDENSE_THREADS,
                                CONDENSE_LANE_VALUES)


def kkt_blocks_per_sm(dtype=torch.float32) -> int:
    """K2's resident blocks per SM (KKT_LANES lanes each)."""
    return _build.blocks_per_sm(_KKT_SOURCE, "kkt_sweep_c2_occupancy",
                                dtype)


def corr_blocks_per_sm(dtype=torch.float32) -> int:
    """K3's resident blocks per SM (CORR_LANES lanes each)."""
    return _build.blocks_per_sm(_CORR_SOURCE, "corrector_sweep_c2_occupancy",
                                dtype)


def bwd_blocks_per_sm(dtype=torch.float32) -> int:
    """K5a's resident blocks per SM (KKT_LANES lanes each)."""
    return _build.blocks_per_sm(_KKT_SOURCE, "bwd_c2_occupancy", dtype)


def fwd_blocks_per_sm(dtype=torch.float32) -> int:
    """K5b's resident blocks per SM (FWD_LANES lanes each)."""
    return _build.blocks_per_sm(_CORR_SOURCE, "fwd_c2_occupancy", dtype)


def bwd_vec_blocks_per_sm(dtype=torch.float32) -> int:
    """K5c's resident blocks per SM (BWD_VEC_LANES lanes each)."""
    return _build.blocks_per_sm(_CORR_SOURCE, "bwd_vec_c2_occupancy", dtype)


def condense_blocks_per_sm(dtype=torch.float32) -> int:
    """K6's resident blocks per SM (CONDENSE_LANES lanes each)."""
    return _build.blocks_per_sm(_SOURCE, "condense2_occupancy", dtype)


def iter_blocks_per_sm(dtype=torch.float32) -> int:
    """K10's resident blocks per SM (ITER_LANES lanes each)."""
    return _build.blocks_per_sm(_ITER_SOURCE, "iter_sweep_c2_occupancy",
                                dtype)


def kkt_sweep_c2(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru, pT,
                 p_term, dx0, gains_dtype=None, a_dev: bool = False):
    """Dense-cost Riccati factorization + forward rollout over the condensed
    horizon.  ruu_shift (M,8,B) is R̄'s diagonal incl. the barrier shift;
    pT (13,B) the terminal Hessian diagonal.  Returns (K (M,8,13,B),
    kff (M,8,B), L (M,36,B), Pc (M,13,B), dx (M+1,13,B), du (M,8,B)).

    Compressed streams (module note): gains_dtype=torch.bfloat16 returns
    K, L and Pc in bfloat16; a_dev=True takes Abar - I, Bbar and cbar in
    bfloat16."""
    if gains_dtype not in (None, torch.bfloat16):
        raise ValueError(f"gains_dtype {gains_dtype} (None or bfloat16)")
    form, bf16 = _form(a_dev, (Abar, Bbar, cbar), gains_dtype)
    if Abar.device.type == "cpu":
        return kkt_sweep_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx,
                                ruu_shift, ru, pT, p_term, dx0, gains_dtype,
                                a_dev)
    M, B = Abar.shape[0], Abar.shape[-1]
    gdt = gains_dtype or Qbar.dtype
    new = lambda *s, dt=Qbar.dtype: torch.empty(  # noqa: E731
        s, dtype=dt, device=Qbar.device)
    outs = (new(M, NUC, NX, B, dt=gdt), new(M, NUC, B), new(M, NLC, B, dt=gdt),
            new(M, NX, B, dt=gdt), new(M + 1, NX, B), new(M, NUC, B))
    # the compressed forms take Kf, the full-precision K their rollout
    # reads: with bf16 gains a scratch (the Pallas kernel's K_all), else
    # the K output itself, which the kernel then ignores
    kf = ((new(M, NUC, NX, B) if gains_dtype is not None else outs[0],)
          if form else ())
    geo = kkt_launch_geometry(B, Qbar.dtype)
    _build.run(kkt_sweep_c2, _KKT_SOURCE, dict(
        Abar=Abar, Bbar=Bbar, cbar=cbar, Qbar=Qbar, S1T=S1T, R00=R00, qx=qx,
        ruu_shift=ruu_shift, ru=ru, pT=pT, p_term=p_term, dx0=dx0),
        outs + kf, _shapes(M, B),
        [M, B, geo["grid"], geo["threads"], geo["smem"]], form=form,
        bf16=bf16)
    return outs


def corrector_sweep_c2(Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0,
                       a_dev: bool = False):
    """Backward vector pass on the stored factorization (K, L, Pc) +
    forward rollout.  Returns (dx (M+1,13,B), du (M,8,B)).  K, L and Pc
    may be bfloat16 (all three or none), and a_dev=True takes the
    deviation-coded stream, as in `kkt_sweep_c2`."""
    gains = K.dtype == torch.bfloat16
    if any((t.dtype == torch.bfloat16) != gains for t in (L, Pc)):
        raise ValueError("K, L and Pc are all bfloat16 or none is")
    form, bf16 = _form(a_dev, (Abar, Bbar, cbar), gains)
    if Abar.device.type == "cpu":
        return corrector_sweep_c2_ref(Abar, Bbar, cbar, qx, ru, K, L, Pc,
                                      p_term, dx0, a_dev)
    M, B = Abar.shape[0], Abar.shape[-1]
    outs = (_empty(qx, M + 1, NX, B), _empty(qx, M, NUC, B))
    geo = corr_launch_geometry(B, qx.dtype)
    _build.run(corrector_sweep_c2, _CORR_SOURCE, dict(
        Abar=Abar, Bbar=Bbar, cbar=cbar, qx=qx, ru=ru, K=K, L=L, Pc=Pc,
        p_term=p_term, dx0=dx0), outs, _shapes(M, B),
        [M, B, geo["grid"], geo["threads"], geo["smem"]], form=form,
        bf16=bf16 + _GAINS * gains)
    return outs


def bwd_c2(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru, pT,
           p_term):
    """The backward factorization of `kkt_sweep_c2` alone: K5a, K2's
    kernel body without its rollout (`csrc/kkt_sweep_c2.cu`,
    `bwd_launch_geometry`).  Float32 or float64 only.  Returns (K, kff, L, Pc)."""
    if Abar.device.type == "cpu":
        return bwd_c2_ref(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift,
                          ru, pT, p_term)
    M, B = Abar.shape[0], Abar.shape[-1]
    outs = (_empty(Abar, M, NUC, NX, B), _empty(Abar, M, NUC, B),
            _empty(Abar, M, NLC, B), _empty(Abar, M, NX, B))
    geo = bwd_launch_geometry(B, Abar.dtype)
    _build.run(bwd_c2, _KKT_SOURCE, dict(
        Abar=Abar, Bbar=Bbar, cbar=cbar, Qbar=Qbar, S1T=S1T, R00=R00, qx=qx,
        ruu_shift=ruu_shift, ru=ru, pT=pT, p_term=p_term), outs,
        _shapes(M, B), [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def bwd_vec_c2(Abar, Bbar, qx, ru, K, L, Pc, p_term):
    """The backward vector pass of `corrector_sweep_c2` alone: K5c, K3's
    kernel body without its rollout (`csrc/corrector_sweep_c2.cu`,
    `bwd_vec_launch_geometry`).  Float32 or float64 only.  Returns
    kff (M,8,B)."""
    if Abar.device.type == "cpu":
        return bwd_vec_c2_ref(Abar, Bbar, qx, ru, K, L, Pc, p_term)
    M, B = Abar.shape[0], Abar.shape[-1]
    kff = _empty(Abar, M, NUC, B)
    geo = bwd_vec_launch_geometry(B, Abar.dtype)
    _build.run(bwd_vec_c2, _CORR_SOURCE, dict(
        Abar=Abar, Bbar=Bbar, qx=qx, ru=ru, K=K, L=L, Pc=Pc, p_term=p_term),
        (kff,), _shapes(M, B),
        [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return kff


def fwd_c2(Abar, Bbar, cbar, K, kff, dx0):
    """The forward rollout from stored gains (K, kff): K5b
    (`csrc/corrector_sweep_c2.cu`, `fwd_launch_geometry`).  Float32 or float64 only.
    Returns (dx (M+1,13,B), du (M,8,B))."""
    if Abar.device.type == "cpu":
        return fwd_c2_ref(Abar, Bbar, cbar, K, kff, dx0)
    M, B = Abar.shape[0], Abar.shape[-1]
    outs = (_empty(Abar, M + 1, NX, B), _empty(Abar, M, NUC, B))
    geo = fwd_launch_geometry(B, Abar.dtype)
    _build.run(fwd_c2, _CORR_SOURCE, dict(Abar=Abar, Bbar=Bbar, cbar=cbar,
                                         K=K, kff=kff, dx0=dx0), outs,
               _shapes(M, B),
               [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def kkt_sweep_c2_win(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift, ru,
                     pT, p_term, dx0):
    """`kkt_sweep_c2` as two launches, `bwd_c2` then `fwd_c2`, the gains
    through device memory (the JAX package's windowed long-horizon form).
    Same arguments and outputs."""
    K, kff, L, Pc = bwd_c2(Abar, Bbar, cbar, Qbar, S1T, R00, qx, ruu_shift,
                           ru, pT, p_term)
    return (K, kff, L, Pc) + tuple(fwd_c2(Abar, Bbar, cbar, K, kff, dx0))


def corrector_sweep_c2_win(Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term,
                           dx0):
    """`corrector_sweep_c2` as two launches, `bwd_vec_c2` then `fwd_c2`.
    Same arguments and outputs."""
    kff = bwd_vec_c2(Abar, Bbar, qx, ru, K, L, Pc, p_term)
    return fwd_c2(Abar, Bbar, cbar, K, kff, dx0)


# outputs 0..13 of iter_sweep_c2 are these inputs, updated in place
_ITER_CARRIED = ("z_dx", "z_du", "s_l", "s_u", "lam_l", "lam_u", "qx", "r1u",
                 "c_res", "r3", "r4", "r1x_T", "dx0_res", "z_dxT")


def iter_scratch(M, B, dtype, device):
    """`iter_sweep_c2`'s device-memory scratch (the Pallas kernel's VMEM
    K_all, kff_all, L_all, Pc_all, du_aff, du, ddx), allocated once per
    solve and reused by every iteration."""
    return dict(K_all=torch.empty((M, NUC, NX, B), dtype=dtype,
                                  device=device),
                **{k: torch.empty((M, n, B), dtype=dtype, device=device)
                   for k, n in (("kff_all", NUC), ("L_all", NLC),
                                ("Pc_all", NX), ("dua_all", NUC),
                                ("du_all", NUC), ("ddx_all", NX))})


def iter_sweep_c2(Abar, Bbar, c_res, Qbar, S1T, R00, qx, ruu, r1u,
                  s_l, s_u, lam_l, lam_u, r3, r4, m_l, m_u, z_dx, z_du,
                  pT, r1x_T, dx0_res, z_dxT, n_ineq, has_ineq, tau: float,
                  scratch: dict):
    """One Mehrotra iteration on the condensed problem in one launch.

    Arguments as the JAX package's `iter_sweep_c2`: the condensed QP data,
    ruu (M,8,B) R̄'s diagonal without the barrier shift, the carried
    iterate and residuals (z_dx (M,13,B) / z_dxT (13,B), z_du, s/lam,
    r1u, r3/r4 (M,8,B), the linear terms qx (M,13,B) / r1x_T (13,B), the
    dynamics residuals c_res (M,13,B) / dx0_res (13,B)), the masks m_l/m_u
    (1 at a finite bound, else 0, with s=1, lam=r3=r4=0 there), and
    n_ineq/has_ineq as (1,B) tensors of the working dtype.

    The 14 carried tensors are updated IN PLACE (the Pallas kernel's
    input_output_aliases); the return value is the JAX package's 16
    outputs: those 14 tensors, then alpha and mu (1,B).  `scratch` is
    `iter_scratch(M, B, ...)`, which the caller allocates once per solve
    (the CPU path does not use it)."""
    ins = dict(Abar=Abar, Bbar=Bbar, c_res=c_res, Qbar=Qbar, S1T=S1T,
               R00=R00, qx=qx, ruu=ruu, r1u=r1u, s_l=s_l, s_u=s_u,
               lam_l=lam_l, lam_u=lam_u, r3=r3, r4=r4, m_l=m_l, m_u=m_u,
               z_dx=z_dx, z_du=z_du, pT=pT, r1x_T=r1x_T, dx0_res=dx0_res,
               z_dxT=z_dxT, n_ineq=n_ineq, has_ineq=has_ineq)
    carried = tuple(ins[k] for k in _ITER_CARRIED)
    if Abar.device.type == "cpu":
        outs = iter_sweep_c2_ref(*ins.values(), tau)
        for dst, src in zip(carried, outs):
            dst.copy_(src)
        return carried + outs[-2:]
    M, B = Abar.shape[0], Abar.shape[-1]
    alpha, mu = _empty(Abar, 1, B), _empty(Abar, 1, B)
    finfo = torch.finfo(Abar.dtype)
    geo = iter_launch_geometry(B, Abar.dtype)
    _build.run(iter_sweep_c2, _ITER_SOURCE, dict(ins, **scratch),
               (alpha, mu), _shapes(M, B),
               [M, B, geo["grid"], geo["threads"], geo["smem"]],
               floats=(tau, 100.0 * finfo.eps ** 2, finfo.tiny))
    return carried + (alpha, mu)


def condense2(A, Bm, c, qxx, qx, ru):
    """Block-2 condensing of stage-wise diagonal-cost QP data (N even):
    A (N,13,13,B), Bm (N,13,4,B), c/qxx/qx (N,13,B), ru (N,4,B) -> the
    dict `prep_condense2` returns (Abar (M,13,13,B), Bbar (M,13,8,B),
    cbar (M,13,B), Qbar (M,13,13,B), S1T (M,4,13,B), R00 (M,4,4,B),
    qbar (M,13,B), rbar (M,8,B)).  qxx is read at both stages of a pair:
    the odd one is the eliminated state's cost, the even one Qbar's
    diagonal.  The kernel runs K1's block (`condense_launch_geometry`):
    32 lanes of one pair, 8 threads a lane, row jobs of A1 and the cost
    columns of [A0 | B0] dealt between them."""
    N, B = A.shape[0], A.shape[-1]
    if N % 2 != 0:
        raise ValueError("condense2 needs even N")
    if A.device.type == "cpu":
        return condense2_ref(A, Bm, c, qxx, qx, ru)
    M = N // 2
    outs = (_empty(A, M, NX, NX, B), _empty(A, M, NX, NUC, B),
            _empty(A, M, NX, B), _empty(A, M, NX, NX, B),
            _empty(A, M, NU, NX, B), _empty(A, M, NU, NU, B),
            _empty(A, M, NX, B), _empty(A, M, NUC, B))
    geo = condense_launch_geometry(B, A.dtype)
    _build.run(condense2, _SOURCE, dict(A=A, Bm=Bm, c=c, qxx=qxx, qx=qx,
                                        ru=ru), outs, stage_shapes(N, B),
               [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return dict(zip(("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar",
                     "rbar"), outs))


def expand2(Ae, Be, c, dx_even, du0, stride=1):
    """Eliminated states: dx_odd[k] = Ae[s k] dx_even[k] + Be[s k] du0[k]
    + c[2k] for stride s, with c the full-horizon defect (N,13,B).
    stride 1: Ae/Be are the even-stage Jacobians (M,13,13,B)/(M,13,4,B)
    (`prep_condense2`'s); stride 2: the full-horizon A/B (N,...), read in
    place at their even stages.  Returns (M,13,B)."""
    if Ae.device.type == "cpu":
        return expand2_ref(Ae, Be, c, dx_even, du0, stride)
    if stride not in (1, 2):
        raise ValueError(f"expand2: stride {stride} (1 or 2)")
    M, B = dx_even.shape[0], dx_even.shape[-1]
    out = _empty(Ae, M, NX, B)
    shapes = dict(_shapes(M, B), Ae=(stride * M, NX, NX, B),
                  Be=(stride * M, NX, NU, B))
    _build.run(expand2, _SOURCE, dict(Ae=Ae, Be=Be, c=c, dx_even=dx_even,
                                      du0=du0), (out,), shapes,
               [M, B, stride])
    return out


for _fn in (kkt_sweep_c2, corrector_sweep_c2, bwd_c2, bwd_vec_c2, fwd_c2,
            iter_sweep_c2, condense2, expand2):
    _fn.launches = 0
del _fn
