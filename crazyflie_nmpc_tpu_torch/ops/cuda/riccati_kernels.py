"""Sweeps of the uncondensed diagonal-cost QP (K8, K9), CUDA and plain
PyTorch.

Counterparts of `crazyflie_nmpc_tpu/ops/pallas/riccati_kernels.py`:
`kkt_sweep` (Riccati factorization with the 4x4 rsqrt Cholesky, then the
forward rollout) and `corrector_sweep` (the backward vector pass on the
stored factorization, then the rollout), the sweeps of `condense=1` and of
every odd horizon; and their split forms, the sweeps of
`solve_batched(fused=False)`: `backward_sweep` (the factorization alone),
`forward_sweep` (the rollout alone) and `backward_vector_sweep` (the
vector pass alone).  Each wrapper launches its kernel in
`csrc/riccati.cu` for CUDA tensors and runs its `*_ref` plain PyTorch
version for CPU tensors.  Every kernel gives each lane a group of threads
and takes its wrapper's launch shape: `kkt_sweep` and `backward_sweep`
(K8a, K9a) `riccati_launch_geometry`'s, `forward_sweep` (K9b)
`forward_launch_geometry`'s, `corrector_sweep` and `backward_vector_sweep`
(K8b, K9c, one body on K9b's group and block: K3's vector pass at 4
inputs, then for K8b K9b's rollout) `vector_launch_geometry`'s.  What
bounds K8b and K9c on the H100 is bytes: per stage and lane K8b reads 313
values in the vector pass and 290 in the rollout and writes 17, K9c reads
313 and writes 4 (281 MB and 260 MB at N=50, B=4096 in float32: 0.084 and
0.078 ms at 3.35 TB/s).  One thread a lane, their form before, ran 64 of
the 132 SMs at B=4096, each thread's loads of a stage one dependent chain:
0.70 and 0.58 ms; the group kernels take 0.187 and 0.099 ms there
(`roofline/kkt_variants.py`, PERF.md).

Layout: batch-last, contiguous, B last.  N stages with 13 states and 4
inputs; the cost is diagonal (qxx (N,13,B), ruu (N,4,B) including the
barrier shift, pT (13,B)); L is the packed column-major lower Cholesky
factor of the 4x4 Quu (10 entries, `condensed_kernels._pk`).  Every sweep
with a rollout returns all of it, its last state dx[N] included.
"""

from __future__ import annotations

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build
from crazyflie_nmpc_tpu_torch.ops.cuda.condensed_kernels import (
    _chol_n,
    _cho_solve_n,
    _cho_solve_n_vec,
    _empty,
    _mm,
    _mtm,
    _mtv,
    _mv,
    bwd_vec_c2_ref,
    fwd_c2_ref,
    stage_shapes,
)

NX = 13
NU = 4
NL = NU * (NU + 1) // 2
_SOURCE = "riccati.cu"
# K8a's and K9a's launch shape (csrc/riccati.cu's kGroup, kThreads and
# kStride, which their launch checks): RICCATI_GROUP threads per lane,
# RICCATI_LANES lanes a block, RICCATI_LANE_VALUES values of the compute
# dtype in shared memory per lane
RICCATI_GROUP = 16
RICCATI_THREADS = 128
RICCATI_LANES = RICCATI_THREADS // RICCATI_GROUP
RICCATI_LANE_VALUES = 1004
# K9b's (csrc/riccati.cu's kFwdGroup, kFwdThreads and kFwdLaneValues, K5b's
# group and block at 4 inputs)
FORWARD_GROUP = 16
FORWARD_THREADS = 256
FORWARD_LANES = FORWARD_THREADS // FORWARD_GROUP
FORWARD_LANE_VALUES = 636
# K8b's and K9c's (K9b's group and block; csrc/riccati.cu's kVecLaneValues)
VECTOR_GROUP = FORWARD_GROUP
VECTOR_THREADS = FORWARD_THREADS
VECTOR_LANES = FORWARD_LANES
VECTOR_LANE_VALUES = 1059


def riccati_launch_geometry(B: int, dtype) -> dict:
    """K8a's and K9a's launch at B lanes of `dtype`
    (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, RICCATI_LANES, RICCATI_THREADS,
                                RICCATI_LANE_VALUES)


def riccati_blocks_per_sm(dtype=torch.float32, kernel="kkt_sweep") -> int:
    """Resident blocks per SM of K8a (`kernel="kkt_sweep"`) or K9a
    (`"backward_sweep"`), RICCATI_LANES lanes each."""
    return _build.blocks_per_sm(_SOURCE, f"{kernel}_occupancy", dtype)


def forward_launch_geometry(B: int, dtype) -> dict:
    """K9b's launch at B lanes of `dtype` (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, FORWARD_LANES, FORWARD_THREADS,
                                FORWARD_LANE_VALUES)


def forward_blocks_per_sm(dtype=torch.float32) -> int:
    """K9b's resident blocks per SM (FORWARD_LANES lanes each)."""
    return _build.blocks_per_sm(_SOURCE, "forward_sweep_occupancy", dtype)


def vector_launch_geometry(B: int, dtype) -> dict:
    """K8b's and K9c's launch at B lanes of `dtype`
    (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, VECTOR_LANES, VECTOR_THREADS,
                                VECTOR_LANE_VALUES)


def vector_blocks_per_sm(dtype=torch.float32,
                         kernel="corrector_sweep") -> int:
    """Resident blocks per SM of K8b (`kernel="corrector_sweep"`) or K9c
    (`"backward_vector_sweep"`), VECTOR_LANES lanes each."""
    return _build.blocks_per_sm(_SOURCE, f"{kernel}_occupancy", dtype)


def _geometry_ints(N, B, dtype, geometry=riccati_launch_geometry):
    geo = geometry(B, dtype)
    return [N, B, geo["grid"], geo["threads"], geo["smem"]]


def backward_sweep_ref(A, Bm, c, qxx, qx, ruu, ru, pT, p_term):
    """Plain PyTorch `backward_sweep` (stage loop in Python).  Returns
    (K (N,4,13,B), kff (N,4,B), L (N,10,B), Pc (N,13,B))."""
    N = A.shape[0]
    eye = torch.eye(NX, dtype=A.dtype, device=A.device)[:, :, None]
    eye4 = torch.eye(NU, dtype=A.dtype, device=A.device)[:, :, None]
    P = eye * pT[None]
    p = p_term
    Ks, kffs, Ls, Pcs = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[k], Bm[k]
        PA = _mm(P, Ak)
        Pc = _mv(P, c[k])
        m = p + Pc
        Quu = _mtm(Bk, _mm(P, Bk)) + eye4 * ruu[k][None]
        Qux = _mtm(Bk, PA)                            # S = 0
        Qu = ru[k] + _mtv(Bk, m)
        L = _chol_n(Quu, NU)
        K = -_cho_solve_n(L, Qux, NU)
        kff = -_cho_solve_n_vec(L, Qu, NU)
        P_new = _mtm(Ak, PA) + _mtm(Qux, K) + eye * qxx[k][None]
        P = 0.5 * (P_new + P_new.transpose(0, 1))
        p = qx[k] + _mtv(Ak, m) + _mtv(K, Qu)
        Ks[k], kffs[k], Ls[k], Pcs[k] = K, kff, L, Pc
    return tuple(torch.stack(z).contiguous() for z in (Ks, kffs, Ls, Pcs))


def forward_sweep_ref(A, Bm, c, K, kff, dx0):
    """Plain PyTorch `forward_sweep`: the condensed rollout's plain version
    at 4 inputs.  Returns (dx (N+1,13,B), du (N,4,B))."""
    return fwd_c2_ref(A, Bm, c, K, kff, dx0)


def backward_vector_sweep_ref(A, Bm, qx, ru, K, L, Pc, p_term):
    """Plain PyTorch `backward_vector_sweep`: the condensed vector pass's
    plain version at 4 inputs.  Returns kff (N,4,B)."""
    return bwd_vec_c2_ref(A, Bm, qx, ru, K, L, Pc, p_term)


def kkt_sweep_ref(A, Bm, c, qxx, qx, ruu, ru, pT, p_term, dx0):
    """Plain PyTorch `kkt_sweep`: `backward_sweep_ref`, then
    `forward_sweep_ref`.  Returns (K (N,4,13,B), kff (N,4,B), L (N,10,B),
    Pc (N,13,B), dx (N+1,13,B), du (N,4,B))."""
    K, kff, L, Pc = backward_sweep_ref(A, Bm, c, qxx, qx, ruu, ru, pT,
                                       p_term)
    return (K, kff, L, Pc) + forward_sweep_ref(A, Bm, c, K, kff, dx0)


def corrector_sweep_ref(A, Bm, c, qx, ru, K, L, Pc, p_term, dx0):
    """Plain PyTorch `corrector_sweep`: `backward_vector_sweep_ref`, then
    `forward_sweep_ref`.  Returns (dx (N+1,13,B), du (N,4,B))."""
    kff = backward_vector_sweep_ref(A, Bm, qx, ru, K, L, Pc, p_term)
    return forward_sweep_ref(A, Bm, c, K, kff, dx0)


def kkt_sweep(A, Bm, c, qxx, qx, ruu, ru, pT, p_term, dx0):
    """Diagonal-cost Riccati factorization + forward rollout in one launch
    (K8a, `riccati_launch_geometry`).  A (N,13,13,B), Bm (N,13,4,B),
    c/qxx/qx (N,13,B), ruu/ru (N,4,B) (ruu with the barrier shift),
    pT/p_term/dx0 (13,B).  Returns (K, kff, L, Pc, dx (N+1,13,B),
    du (N,4,B))."""
    if A.device.type == "cpu":
        return kkt_sweep_ref(A, Bm, c, qxx, qx, ruu, ru, pT, p_term, dx0)
    N, B = A.shape[0], A.shape[-1]
    outs = (_empty(A, N, NU, NX, B), _empty(A, N, NU, B), _empty(A, N, NL, B),
            _empty(A, N, NX, B), _empty(A, N + 1, NX, B), _empty(A, N, NU, B))
    _build.run(kkt_sweep, _SOURCE, dict(
        A=A, Bm=Bm, c=c, qxx=qxx, qx=qx, ruu=ruu, ru=ru, pT=pT,
        p_term=p_term, dx0=dx0), outs, stage_shapes(N, B),
        _geometry_ints(N, B, A.dtype))
    return outs


def corrector_sweep(A, Bm, c, qx, ru, K, L, Pc, p_term, dx0):
    """Backward vector pass on the stored factorization (K, L, Pc) +
    forward rollout in one launch (K8b, `vector_launch_geometry`).
    Returns (dx (N+1,13,B), du (N,4,B)); the kernel writes dx[N]
    itself."""
    if A.device.type == "cpu":
        return corrector_sweep_ref(A, Bm, c, qx, ru, K, L, Pc, p_term, dx0)
    N, B = A.shape[0], A.shape[-1]
    outs = (_empty(A, N + 1, NX, B), _empty(A, N, NU, B))
    _build.run(corrector_sweep, _SOURCE, dict(
        A=A, Bm=Bm, c=c, qx=qx, ru=ru, K=K, L=L, Pc=Pc, p_term=p_term,
        dx0=dx0), outs, stage_shapes(N, B),
        _geometry_ints(N, B, A.dtype, vector_launch_geometry))
    return outs


def backward_sweep(A, Bm, c, qxx, qx, ruu, ru, pT, p_term):
    """`kkt_sweep`'s factorization alone (fused=False; K9a, K8a's kernel
    body without its rollout).  Returns (K, kff, L, Pc)."""
    if A.device.type == "cpu":
        return backward_sweep_ref(A, Bm, c, qxx, qx, ruu, ru, pT, p_term)
    N, B = A.shape[0], A.shape[-1]
    outs = (_empty(A, N, NU, NX, B), _empty(A, N, NU, B), _empty(A, N, NL, B),
            _empty(A, N, NX, B))
    _build.run(backward_sweep, _SOURCE, dict(
        A=A, Bm=Bm, c=c, qxx=qxx, qx=qx, ruu=ruu, ru=ru, pT=pT,
        p_term=p_term), outs, stage_shapes(N, B),
        _geometry_ints(N, B, A.dtype))
    return outs


def forward_sweep(A, Bm, c, K, kff, dx0):
    """The rollout from stored gains (K, kff) alone (K9b,
    `forward_launch_geometry`).  Returns (dx (N+1,13,B), du (N,4,B)); the
    kernel writes dx[N] itself."""
    if A.device.type == "cpu":
        return forward_sweep_ref(A, Bm, c, K, kff, dx0)
    N, B = A.shape[0], A.shape[-1]
    outs = (_empty(A, N + 1, NX, B), _empty(A, N, NU, B))
    _build.run(forward_sweep, _SOURCE, dict(A=A, Bm=Bm, c=c, K=K, kff=kff,
                                            dx0=dx0), outs,
               stage_shapes(N, B),
               _geometry_ints(N, B, A.dtype, forward_launch_geometry))
    return outs


def backward_vector_sweep(A, Bm, qx, ru, K, L, Pc, p_term):
    """`corrector_sweep`'s vector pass on the stored factorization alone
    (K9c, K8b's kernel body without its rollout).  Returns kff (N,4,B)."""
    if A.device.type == "cpu":
        return backward_vector_sweep_ref(A, Bm, qx, ru, K, L, Pc, p_term)
    N, B = A.shape[0], A.shape[-1]
    kff = _empty(A, N, NU, B)
    _build.run(backward_vector_sweep, _SOURCE, dict(
        A=A, Bm=Bm, qx=qx, ru=ru, K=K, L=L, Pc=Pc, p_term=p_term), (kff,),
        stage_shapes(N, B),
        _geometry_ints(N, B, A.dtype, vector_launch_geometry))
    return kff


for _fn in (kkt_sweep, corrector_sweep, backward_sweep, forward_sweep,
            backward_vector_sweep):
    _fn.launches = 0
del _fn
