"""Frozen yardsticks: the H100's published peaks, and the operations and
bytes that each kernel of the batched RTI tick needs, counted from the
algorithm and from the documented shapes of its inputs and outputs at a
cell's B and N, never from what an implementation issues or passes.

Operations count 2 per multiply-add and 1 per other operation.  A
kernel's roofline time is the larger of its operations over the fp32
peak and its bytes over the HBM bandwidth; bytes count each input read
once and each output written once.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

NX, NU = 13, 4
NUC = 2 * NU                 # inputs of a condensed stage (two stages)
NLC = NUC * (NUC + 1) // 2   # packed Cholesky factor of an 8x8 Hessian
NY = NX + NU
NPARAM = 9                   # the quadrotor's 8 constants and dt

# --- operations ----------------------------------------------------------
# K1 per pair of stages: two ERK4 VDE stages (sparse J with ~60 nonzeros
# times the 13+4 tangent columns at 3 RK stages, 4 dynamics and 4
# Jacobian evaluations, the RK4 combinations) and the condensing
# products (Abar 13^3, A1 B0 13^2 4, Qbar 13^3, S1T 13^2 4, R00 13 4^2,
# vectors).
_VDE = 3 * 60 * 17 + 4 * 100 + 4 * 150 + 6 * (169 + 52)
_COND = 2 * (2197 + 676 + 2197 + 169 + 676 + 208 + 169 + 52 + 169)
# K2 per condensed stage: PA, A'PA 2 x 13^3; PB, B'PA, Qux'K 3 x 13^2 8;
# B'PB 8^2 13; the 8x8 Cholesky and 14 solves; vectors and the rollout
# (Kx, Ax, Bu: 377 multiply-adds).  K3: B'm, A'm, K'Qu, one solve and
# the rollout.  K4 per pair: 13^2 + 13 4 multiply-adds.
PER_PAIR = {
    "prep_condense2": 2 * (2 * _VDE) + _COND,
    "kkt_sweep_c2": 2 * (2 * 2197 + 3 * 1352 + 832 + 84 + 14 * 64 + 169
                         + 273 + 104 + 377) + 36,
    "corrector_sweep_c2": 2 * (104 + 64 + 273 + 377),
    "expand2": 2 * (169 + 52) + 13,
}
# The Mehrotra iteration's barrier algebra between the sweeps, per
# condensed stage (8 inputs) and iteration: shift and affine right-hand
# side (16 an input), affine directions and ratios (35), corrected
# residuals and right-hand side (24), directions and ratios (34), update
# (38), and 52 a stage for the state-sized updates.
BARRIER_PER_STAGE_ITER = NUC * (16 + 35 + 24 + 34 + 38) + 52
# The plant: one ERK4 step, 4 evaluations of the ODE (~100 operations
# each) and the stage combinations (10 per state).
PLANT_PER_LANE = 4 * 100 + 10 * NX


def flops(kernel: str, B: int, N: int) -> float:
    """Operations of one launch of `kernel` at B lanes and horizon N."""
    return float(PER_PAIR[kernel]) * (N // 2) * B


def tick_flops(B: int, N: int, iters: int) -> float:
    """Operations of one closed-loop tick: K1, `iters` x (K2 + K3 + the
    barrier algebra), K4 and the plant."""
    M = N // 2
    per_lane = (PER_PAIR["prep_condense2"] * M
                + iters * (PER_PAIR["kkt_sweep_c2"]
                           + PER_PAIR["corrector_sweep_c2"]
                           + BARRIER_PER_STAGE_ITER) * M
                + PER_PAIR["expand2"] * M + PLANT_PER_LANE)
    return float(per_lane) * B


# --- bytes ---------------------------------------------------------------

def _values(kernel: str, N: int) -> int:
    """Values a lane reads and writes in one launch (documented shapes)."""
    M = N // 2
    s13, s8 = M * NX, M * NUC
    if kernel == "prep_condense2":
        ins = ((N + 1) * NX + N * NU + N * NY + NX + 3 * NU + NPARAM)
        outs = (M * NX * NX + M * NX * NUC + s13 + M * NX * NX + M * NU * NX
                + M * NU * NU + s13 + s8 + M * NX * NX + M * NX * NU
                + N * NX + 2 * N * NU)
    elif kernel == "kkt_sweep_c2":
        ins = (M * NX * NX + M * NX * NUC + s13 + M * NX * NX + M * NU * NX
               + M * NU * NU + s13 + 2 * s8 + 3 * NX)
        outs = M * NUC * NX + s8 + M * NLC + s13 + (M + 1) * NX + s8
    elif kernel == "corrector_sweep_c2":
        ins = (M * NX * NX + M * NX * NUC + s13 + s13 + s8 + M * NUC * NX
               + M * NLC + s13 + 2 * NX)
        outs = (M + 1) * NX + s8
    elif kernel == "expand2":
        # Ae, Be at the even stages; c read at its even stages only
        ins = M * NX * NX + M * NX * NU + s13 + s13 + M * NU
        outs = s13
    else:
        raise KeyError(kernel)
    return ins + outs


def bytes_moved(kernel: str, B: int, N: int, itemsize: int = 4) -> float:
    """Bytes one launch of `kernel` must move at B lanes, horizon N."""
    return float(_values(kernel, N)) * B * itemsize


def roofline_s(kernel: str, B: int, N: int, itemsize: int = 4) -> float:
    """The least time one launch could take on the H100."""
    return max(flops(kernel, B, N) / PEAK_FP32_FLOPS,
               bytes_moved(kernel, B, N, itemsize) / HBM_BYTES_PER_S)


def roofline_share(ctx: dict, kernel: str):
    """A traced run's `<kernel>_roofline`: the kernel's roofline time at
    the cell's B and N over its mean traced device time a launch, %; None
    where the trace holds no launch of it."""
    events = ctx["trace"].kernels_named(kernel)
    if not events:
        return None
    mean_s = sum(e.dur for e in events) / len(events) * 1e-6
    cell = ctx["cell"]
    return 100.0 * roofline_s(kernel, cell.B, cell.N) / mean_s
