"""Speed-of-light probes of the condensed sweeps (P1, P2), CUDA and plain
PyTorch.

Counterparts of the two Pallas kernels of `tools/ipm_iter_sol.py`:
`fma_chain` (P1, `measure_fma_rate`'s kernel: `reps` chained 13x13x13
products c <- (c b) 7.6e-4 + b) and `stage_replay` (P2,
`measure_stage_replay`'s kernel: `reps` backward stages of `kkt_sweep_c2`
on constant stage data).  Each wrapper launches its kernel in
`csrc/sol_probes.cu` for CUDA tensors and runs its `*_plain` PyTorch
version for CPU tensors.  Nothing on the solver's path calls them: they
are the yardsticks of `roofline.ipm_iter_sol`.

Layout: batch-last, contiguous, B last, as the sweeps.  `fma_chain` runs
`reps // UNROLL * UNROLL` products (its kernel runs them in groups of
UNROLL), `stage_replay` `reps` stages.  Both kernels give each lane a
group of threads, as the sweeps do: `fma_chain` row i of c on thread i
(`fma_launch_geometry`), `stage_replay` K2's group stage on K2's group
and block, its stage inputs landed once in shared memory
(`replay_launch_geometry`).
"""

from __future__ import annotations

import ctypes

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build
from crazyflie_nmpc_tpu_torch.ops.cuda.condensed_kernels import (
    NU,
    NUC,
    NX,
    _empty,
    _mm,
    c2_stage_ref,
)

_SOURCE = "sol_probes.cu"
UNROLL = 16
FMA_SCALE = 7.6e-4
# fma_chain's launch shape (csrc/sol_probes.cu's kFmaGroup, kFmaThreads and
# kFmaLaneValues, which its launch checks): FMA_GROUP threads a lane (K2's
# G; thread i < 13 holds row i of c), FMA_LANES lanes a block (K2's
# block), FMA_LANE_VALUES values of the dtype in shared memory a lane (b)
FMA_GROUP = 16
FMA_THREADS = 128
FMA_LANES = FMA_THREADS // FMA_GROUP
FMA_LANE_VALUES = 212
# stage_replay's launch shape, K2's (csrc/sol_probes.cu's kGroup, kThreads
# and kStride, which its launch checks): REPLAY_GROUP threads a lane,
# REPLAY_LANES lanes a block, REPLAY_LANE_VALUES values of the dtype in
# shared memory a lane (K2's slots)
REPLAY_GROUP = 16
REPLAY_THREADS = 128
REPLAY_LANES = REPLAY_THREADS // REPLAY_GROUP
REPLAY_LANE_VALUES = 1548


def fma_chain_plain(a, b, reps: int = 512):
    """Plain PyTorch `fma_chain`: c = a, then c <- (c b) 7.6e-4 + b,
    reps // UNROLL * UNROLL times; a, b (13,13,B)."""
    c = a
    for _ in range(reps // UNROLL * UNROLL):
        c = _mm(c, b) * FMA_SCALE + b
    return c


def stage_replay_plain(A, Bm, c, Q, S1T, R00, qx, ruu, ru, P0, p0,
                       reps: int = 60):
    """Plain PyTorch `stage_replay`: `reps` backward stages of
    `kkt_sweep_c2` (`c2_stage_ref`, its K, kff, L and Pc dropped) from
    (P0, p0) on the same stage data.  Returns (P (13,13,B), p (13,B))."""
    P, p = P0, p0
    for _ in range(reps):
        P, p = c2_stage_ref(P, p, A, Bm, c, Q, S1T, R00, qx, ruu, ru)[:2]
    return P.contiguous(), p.contiguous()


def _shapes(B):
    t13 = (NX, B)
    return dict(a=(NX, NX, B), b=(NX, NX, B), A=(NX, NX, B),
                Bm=(NX, NUC, B), Q=(NX, NX, B), S1T=(NU, NX, B),
                R00=(NU, NU, B), P0=(NX, NX, B), ruu=(NUC, B), ru=(NUC, B),
                **dict.fromkeys(("c", "qx", "p0"), t13))


def _check_reps(name, reps):
    if not 0 < reps < 2**31:
        raise ValueError(f"{name}: reps {reps} out of range")


def fma_launch_geometry(B: int, dtype) -> dict:
    """fma_chain's launch at B lanes of `dtype`
    (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, FMA_LANES, FMA_THREADS,
                                FMA_LANE_VALUES)


def replay_launch_geometry(B: int, dtype) -> dict:
    """stage_replay's launch at B lanes of `dtype`
    (`_build.lane_geometry`)."""
    return _build.lane_geometry(B, dtype, REPLAY_LANES, REPLAY_THREADS,
                                REPLAY_LANE_VALUES)


def fma_chain(a, b, reps: int = 512):
    """`reps // UNROLL * UNROLL` chained products c <- (c b) 7.6e-4 + b
    from c = a; a, b (13,13,B).  Returns c (13,13,B).  The kernel gives
    each lane a group of FMA_GROUP threads, row i of c on thread i
    (`fma_launch_geometry`)."""
    _check_reps("fma_chain", reps)
    if a.device.type == "cpu":
        return fma_chain_plain(a, b, reps)
    B = a.shape[-1]
    out = _empty(a, NX, NX, B)
    geo = fma_launch_geometry(B, a.dtype)
    _build.run(fma_chain, _SOURCE, dict(a=a, b=b), (out,), _shapes(B),
               [reps, B, geo["grid"], geo["threads"], geo["smem"]])
    return out


def stage_replay(A, Bm, c, Q, S1T, R00, qx, ruu, ru, P0, p0,
                 reps: int = 60):
    """`reps` backward stages of `kkt_sweep_c2` on the same stage data (A,
    Bm (13,8,B), c, Q, S1T, R00, qx, ruu (8,B) with the barrier shift, ru)
    from the cost-to-go (P0, p0).  Returns (P (13,13,B), p (13,B)).  The
    kernel runs K2's group stage on K2's group and block, the stage data
    landed once in shared memory (`replay_launch_geometry`)."""
    _check_reps("stage_replay", reps)
    if A.device.type == "cpu":
        return stage_replay_plain(A, Bm, c, Q, S1T, R00, qx, ruu, ru, P0,
                                  p0, reps)
    B = A.shape[-1]
    outs = (_empty(A, NX, NX, B), _empty(A, NX, B))
    geo = replay_launch_geometry(B, A.dtype)
    _build.run(stage_replay, _SOURCE, dict(
        A=A, Bm=Bm, c=c, Q=Q, S1T=S1T, R00=R00, qx=qx, ruu=ruu, ru=ru,
        P0=P0, p0=p0), outs, _shapes(B),
        [reps, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def blocks_per_sm(name: str, dtype=torch.float32) -> int:
    """Resident blocks per SM of the kernel of `name` ("fma_chain": blocks
    of its launch geometry, FMA_LANES lanes each; "stage_replay": blocks
    of its launch geometry, K2's REPLAY_LANES lanes each), from the CUDA
    occupancy API for its registers and shared memory (builds the kernels
    first)."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(_build.load(_SOURCE), f"{name}_occupancy_{sfx}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} occupancy: CUDA error {err}")
    return blocks.value


# the probes' launch counters, apart from the solver's kernels
# (`ops.cuda.KERNELS`); read and reset them with
# `ops.cuda.launch_counts(PROBES)` / `reset_launch_counts(PROBES)`
PROBES = {"fma_chain": fma_chain, "stage_replay": stage_replay}
for _fn in PROBES.values():
    _fn.launches = 0
del _fn

