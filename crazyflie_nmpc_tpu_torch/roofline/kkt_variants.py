"""K2 `kkt_sweep_c2`, K3 `corrector_sweep_c2`, K1 `prep_condense2`, K5a
`bwd_c2`, K5b `fwd_c2`, K5c `bwd_vec_c2`, K10 `iter_sweep_c2`, K8a
`kkt_sweep`, K9a `backward_sweep`, K9b `forward_sweep`, K8b
`corrector_sweep`, K9c `backward_vector_sweep`, K6 `condense2` or the
probe P1 `fma_chain` in variants on the card: their launch shapes, and
the parts of their work cut out one at a time.

    python -m crazyflie_nmpc_tpu_torch.roofline.kkt_variants \
        [--kernel kkt_sweep_c2|corrector_sweep_c2|prep_condense2|bwd_c2|
                  fwd_c2|bwd_vec_c2|iter_sweep_c2|kkt_sweep|backward_sweep|
                  forward_sweep|corrector_sweep|backward_vector_sweep|
                  condense2|fma_chain]
        [--baseline DIR] [--variants NAME,...]

Each variant is the kernel's source (`csrc/kkt_sweep_c2.cu`, which holds
K5a too, `csrc/corrector_sweep_c2.cu`, which holds K5b and K5c,
`csrc/prep_condense2.cu`, `csrc/iter_c2.cu`, `csrc/riccati.cu`, which
holds K8a, K9a, K9b, K8b and K9c, `csrc/condensed_c2.cu`,
`csrc/sol_probes.cu`) with one edit (`VARIANTS`,
`CORR_VARIANTS`, `PREP_VARIANTS`, `BWD_VARIANTS`, `FWD_VARIANTS`,
`VEC_VARIANTS`, `ITER_VARIANTS`, `RICCATI_VARIANTS`, `BACKWARD_VARIANTS`,
`FORWARD_VARIANTS`, `CORRECTOR_VARIANTS`, `VECTOR_VARIANTS`,
`CONDENSE_VARIANTS`, `FMA_VARIANTS`).
K2: G = 8 or 32 threads per lane (128 threads a block, so 16 or 4 lanes),
the dot products on two accumulators, or one part of the stage removed
(the backward pass's loads, its phases A-D, its stores, the rollout). K3:
G = 8, or one part removed (the vector pass's loads, Qu, the kff solve,
the p update, the rollout), 128 threads a block (8 lanes), or
`__launch_bounds__` asking float32 for the 3 blocks an SM its shared
memory allows instead of 2 (80 registers a thread instead of 128). K1, in
both VDE orders (the order-2 entry under the variant's name + ORDER2): one
part removed (the even tangent chains, the odd ones, the Jacobian builds,
the cost products, the stores: every stored value summed into one that is
never stored), cached stores instead of evict-first ones, 8 or 16 lanes a
warp (the workers of a lane sharing a warp), 64 lanes a block, 4 or 16
workers a lane, or 3 blocks an SM (80 registers).  K5a: its cost inputs
loaded at a stage's top, as K2's, instead of while the stage before
computes, or one part removed (the loads, phases A-D, the stores).  K5b: a ring of 3 input sets
instead of 2, G = 8 (16 lanes a block), 32 lanes a block (G = 16 or 8), or
one part removed (the loads in the stage loop, the u phase, the dx phase,
the stores).  K5c: a ring of 3 input sets instead of 2, K5b's shapes
(G = 8, 32 lanes a block, both), or one part removed (the loads in the
stage loop, the m/Qu phase, the p update, the kff solve, the kff stores,
kept alive behind a B < 0 test).  K9b: K5b's variants at 4 inputs (its
own constants, `SHAPE_CONSTANTS`).  K8b and K9c (one body on K9b's
group and block, a ring of 3 sets): a ring of 2 sets, K5c's shapes at 4
inputs, or one part removed (the loads in the stage loops, the m/Qu
phase, the p update, the kff solve, the stores kept alive behind a B < 0
test, and K8b's rollout).  K6 (on K1's block): 4 or 16 workers a lane,
64 lanes a block, or one part removed (the loads, the row jobs, the cost
columns, the stores).  P1: the 13 rows packed flat (no idle thread) at
16 or 32 lanes a block, 16 or 32 lanes a block of 16 threads a lane,
half the blocks an SM, 2 or 4 rows of c a thread, on the study's inputs
(`ipm_iter_sol.probe_inputs`, 512 products).  K10: one of its five
phases removed, or the
barrier algebra of all five (`kAlgebra`); each launch on a copy of its
own of the carried inputs it updates in place (`calls`), all made before
the timing.  K8a:
G = 8 or 32 threads a lane (128 threads a block), 256 threads a block
(16 lanes), `__launch_bounds__` asking float32 for 8 blocks an SM (64
registers a thread) instead of 4, a ring of 2 rollout input sets
instead of 3, or one part
removed (the backward loads, phases A-D, the stores, the rollout); K9a
the same but the rollout's two.  Every
variant is built with the port's nvcc flags into
`build/torch_kernels/variants/`, launched through its float32 entry point
at its own launch shape, and timed at B = 1024, 4096 and 8192 (N=50, the
study's condensed data; K3 on K2's factorization of it; K1 on the warm
start the study condenses; K10 on the study's data with seeded slacks
and duals, every bound finite (`iter_inputs`); K5a, K5b and K5c at N=400, the
path that runs them,
the data's 25 condensed stages repeated 8 times, K5b on K2's gains of
them, K5c on K2's factorization; K8a and K9a on the stage QP that K6
condenses, N=50, K9b on K8a's gains of it, K8b and K9c on K8a's
factorization of it), all variants
in turn and then in reverse order; the unedited
kernel runs among them.  A time is the device time of
a launch, the mean over 20 traced launches (`roofline.device_ms`).  The
variants that compute the whole stage are also held against the plain
version at B=1024 and N=50 (relative 1e-4, as `chip_smoke.py`); the cut
ones compute garbage and are only timed. What a part costs is the kernel's
time less the time without it.
`--baseline DIR` adds the kernel's source as it stands in another
checkout's `csrc` (with that checkout's headers; say the parent commit,
unpacked with `git archive`) as the variant "baseline", timed and checked
among the others: the file of that checkout that defines the kernel
(`condensed_c2.cu` for a one-thread K5a, K5b or K5c, whose entries take
no launch shape, as the one-thread K10's in `iter_c2.cu` and K8a's, K9a's
and K9b's, K8b's and K9c's in `riccati.cu`, where K9a is
`kkt_sweep_kernel<T, false>`, and the one-thread K6's and P1's); the
whole variants' outputs are compared with the baseline's bit for bit;
for K10 also that
source with each of its phases cut (`BASELINE_VARIANTS`, the one-thread
kernel's phase blocks emptied), as "baseline no phase N".  Runs on the
CUDA device only: without one it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk
from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
from crazyflie_nmpc_tpu_torch.roofline import device_ms

BATCHES = (1024, 4096, 8192)
# P1's products a launch (the speed-of-light study's)
FMA_REPS = 512
_SOURCE = "kkt_sweep_c2.cu"
_ROLL_SWITCH = "  if constexpr (ROLL) {"
# K3's rollout, switched on with ROLL
_ROLLOUT = "  if constexpr (ROLL) {\n    // forward rollout: du_k"
# the horizon each kernel is timed at (the path that runs it)
HORIZON = {"bwd_c2": 400, "fwd_c2": 400, "bwd_vec_c2": 400}


def _cut(start, end, keep=""):
    """An edit removing the source between the marker `start` (included)
    and the first `end` after it (kept), leaving `keep` in its place."""
    def edit(src):
        a = src.index(start)
        b = src.index(end, a)
        return src[:a] + keep + src[b:]
    return edit


def _replace(old, new):
    def edit(src):
        if old not in src:
            raise ValueError(f"kkt_variants: {old!r} not in the source")
        return src.replace(old, new)
    return edit


_BARRIER = "    __syncthreads();\n\n"
_DOT = """  T s = x[0] * y[0];
#pragma unroll
  for (int i = 1; i < n; ++i) s = s + x[i] * y[i];
  return s;"""
_DOT2 = """  T s[2] = {x[0] * y[0], x[1] * y[1]};
#pragma unroll
  for (int i = 2; i < n; ++i) s[i % 2] = s[i % 2] + x[i] * y[i];
  return s[0] + s[1];"""

def _then(*edits):
    """The edits applied in turn."""
    def edit(src):
        for e in edits:
            src = e(src)
        return src
    return edit


_G8 = _replace("constexpr int kGroup = 16;", "constexpr int kGroup = 8;")

# name: edit of the source, or None (the group size and block size of each
# variant are its source's kGroup and kThreads)
VARIANTS = {
    "kernel": None,
    "G=8": _G8,
    "G=32": _replace("constexpr int kGroup = 16;",
                     "constexpr int kGroup = 32;"),
    "two accumulators": _replace(_DOT, _DOT2),
    "no backward loads": _cut(
        "    stage_in<T, DEV, NX, RW, LS>(sh, AT, Abar", "    copy_wait();"),
    "no phase A": _cut("    // P [A | B | c]", "    // B' times", _BARRIER),
    "no phase B": _cut("    // B' times", "    // K5a: stage k-1's", _BARRIER),
    "no phase C": _cut("    // L = chol(Quu)", "    // the stage's gains out",
                       _BARRIER),
    "no stores": _cut("    // the stage's gains out",
                      "    // X = Qbar + A'PA"),
    "no phase D": _cut("    // X = Qbar + A'PA", "  }\n\n" + _ROLL_SWITCH),
    "no rollout": _replace(_ROLL_SWITCH, "  if constexpr (false) {"),
}

# K5a's, on the same source (its body is K2's with the rollout switched
# off): its cost inputs loaded at a stage's top, as K2's, or a part
# removed
_NO_PREFETCH = _replace("constexpr bool kPrefetch = true;",
                        "constexpr bool kPrefetch = false;")
BWD_VARIANTS = {
    "kernel": None,
    "top-of-stage loads": _NO_PREFETCH,
    "no loads": _then(VARIANTS["no backward loads"], _NO_PREFETCH),
    **{name: VARIANTS[name] for name in ("no phase A", "no phase B",
                                         "no phase C", "no stores",
                                         "no phase D")},
}

# K5b's, on K3's source (K3's group and block edited with it)
_SETS = "constexpr int kSets = 2;"
_FWD_THREADS = "constexpr int kThreads = 256;"
_FWD_DX = "    // K5b's dx_{k+1} = A x + B u + c"
FWD_VARIANTS = {
    "kernel": None,
    "3 sets": _then(_replace(_SETS, _SETS.replace("2", "3")),
                    _replace("kFwdLaneValues == 856",
                             "kFwdLaneValues == 1267")),
    "G=8": _then(_G8, _replace(_FWD_THREADS,
                               _FWD_THREADS.replace("256", "128"))),
    "32 lanes": _replace(_FWD_THREADS, _FWD_THREADS.replace("256", "512")),
    "G=8, 32 lanes": _G8,
    "no loads": _replace(
        "    if (k + kSets - 1 < M) roll_in(k + kSets - 1);\n", ""),
    "no u phase": _cut("    // K5b's u = K x + kff", "    // K5b's x_k out"),
    "no dx phase": _cut(_FWD_DX, "    cp_wait_group<kSets - 2>();"),
    "no stores": _then(
        _replace("      w[(U + a) * kLanes] = u;\n      if (valid) du[",
                 "      w[(U + a) * kLanes] = u;\n      if (false) du["),
        _cut("    // K5b's x_k out", "    __syncthreads();\n" + _FWD_DX)),
}

# K3's, on csrc/corrector_sweep_c2.cu (its body `sweep<..., ROLL>`)
_CORR_TURN = "    if constexpr (ROLL)\n      cp_wait();"
_BLOCKS = "  return std::min(2, (227 * 1024) / smem_bytes<T, ROLL>());"
_QU = "    // vector-pass Qu: m = p + Pc"
_P_UPDATE = "    // vector-pass p update"
_KFF_SOLVE = "    // vector-pass kff solve"
CORR_VARIANTS = {
    "kernel": None,
    "G=8": _G8,
    "128 threads": _replace("constexpr int kThreads = 256;",
                            "constexpr int kThreads = 128;"),
    "no vector-pass loads": _cut("      if (k > 0)\n        vec_in(k - 1);",
                                 "    } else {\n      // K5c: stage"),
    "no Qu": _cut("      if (t < NUC) {\n        T m[NX];",
                  "    }\n    __syncthreads();\n\n" + _P_UPDATE),
    "no kff solve": _cut(_KFF_SOLVE, _CORR_TURN),
    "no p update": _cut(_P_UPDATE, _KFF_SOLVE),
    "no rollout": _replace(_ROLLOUT,
                           _ROLLOUT.replace("(ROLL)", "(false)")),
    "3 blocks an SM": _replace(_BLOCKS, _BLOCKS.replace("2,", "3,")),
}

# K5c's, on the same source (K3's body with the rollout switched off; K3's
# group and block edited with it): a ring of 3 sets, the shapes of K5b's
# study, or a part removed (the kff stores kept alive behind B < 0)
_VEC_SETS = "constexpr int kVecSets = 2;"
VEC_VARIANTS = {
    "kernel": None,
    "3 sets": _then(_replace(_VEC_SETS, _VEC_SETS.replace("2", "3")),
                    _replace("kVecLaneValues == 954",
                             "kVecLaneValues == 1414")),
    "G=8": FWD_VARIANTS["G=8"],
    "32 lanes": FWD_VARIANTS["32 lanes"],
    "G=8, 32 lanes": _G8,
    "no loads": _replace(
        "      if (k - kVecSets + 1 >= 0) vec_in(k - kVecSets + 1);\n", ""),
    "no m/Qu phase": _cut(_QU, _P_UPDATE, _BARRIER),
    "no p update": CORR_VARIANTS["no p update"],
    "no kff solve": CORR_VARIANTS["no kff solve"],
    "no stores": _replace("        if (valid) kff[",
                          "        if (valid && B < 0) kff["),
}

# K1's, on csrc/prep_condense2.cu; each variant runs in both VDE orders,
# its order-2 entry (vde_order=2) under its name + ORDER2
ORDER2 = " (order 2)"
_EVEN_A = ("      chain_x<ORDER>(p, sh, 0, l, v, v);  "
           "// the even chain of an A column\n")
_CHAIN_U = "      chain_u<ORDER>(p, sh, even ? 0 : sets, l, uc, col, v);"
_ODD = ("    if (job <= kJobC) chain_x<ORDER>(p, sh, sets, l, v, v);  "
        "// odd chain")
_ROW_LANES = "constexpr int kRowLanes = 32;"
_PREP_LAUNCH = "template <typename T, int ORDER>\nint set_smem()"
_PREP_END = "  }\n}\n\n" + _PREP_LAUNCH
PREP_VARIANTS = {
    "kernel": None,
    "no even chains": _then(
        _replace(_EVEN_A, ""),
        _replace(_CHAIN_U, "      if (even) ju_col(p, uc, col, v);\n"
                           "      else chain_u<ORDER>(p, sh, sets, l, uc, "
                           "col, v);")),
    "no odd chains": _then(
        _replace(_ODD, ""),
        _replace(_CHAIN_U, "      if (!even) ju_col(p, uc, col, v);\n"
                           "      else chain_u<ORDER>(p, sh, 0, l, uc, col, "
                           "v);")),
    "no Jacobian builds": _cut("  // 2. each stage Jacobian built once",
                               "  if (w == 2) {"),
    "no cost products": _cut("  // 4. the cost jobs", _PREP_LAUNCH,
                             "}\n\n"),
    # every stored value summed into one that is never stored: the
    # arithmetic stays, the stores go
    "no stores": _then(
        _replace("  const auto put = [&](T* base, int r, T v) {\n"
                 "    if (valid) __stcs(base + (size_t)r * B + b, v);\n  };",
                 "  T sink = T(0);\n"
                 "  const auto put = [&](T*, int, T v) { sink = sink + v; };"),
        _replace(_PREP_END, "  }\n  if (valid && B < 0) c[b] = sink;\n}\n\n"
                 + _PREP_LAUNCH)),
    "cached stores": _replace(
        "    if (valid) __stcs(base + (size_t)r * B + b, v);",
        "    if (valid) base[(size_t)r * B + b] = v;"),
    "8-lane rows": _replace(_ROW_LANES, _ROW_LANES.replace("32", "8")),
    "16-lane rows": _replace(_ROW_LANES, _ROW_LANES.replace("32", "16")),
    "64 lanes": _then(_replace("constexpr int kLanes = 32;",
                               "constexpr int kLanes = 64;"),
                      _replace("constexpr int kThreads = 256;",
                               "constexpr int kThreads = 512;")),
    "4 warps": _replace("constexpr int kThreads = 256;",
                        "constexpr int kThreads = 128;"),
    "16 warps": _replace("constexpr int kThreads = 256;",
                         "constexpr int kThreads = 512;"),
    "3 blocks an SM": _replace("std::min(512 / kThreads,",
                               "std::min(768 / kThreads,"),
}

# K10's, on csrc/iter_c2.cu: each of its five phases cut in turn (its
# call in the kernel), or the barrier algebra of all five alone
_ITER_PHASES = {"no phase 0": "  backward_affine(g, sh, M, B);\n",
                "no phase 1": "  forward<false>(g, sh, M, B);\n",
                "no phase 2": "  backward_corrector(g, sh, M, B);\n",
                "no phase 3": "  forward<true>(g, sh, M, B);\n",
                "no phase 4": "  update(g, sh, M, B);\n"}
ITER_VARIANTS = {
    "kernel": None,
    **{name: _replace(call, "") for name, call in _ITER_PHASES.items()},
    "no barrier algebra": _replace("constexpr bool kAlgebra = true;",
                                   "constexpr bool kAlgebra = false;"),
}
_XT = "    for (int i = 0; i < NX; ++i) xT[i] = dx0_res[i * B + b];\n"
# the same phase cuts on the one-thread K10 (the kernel before its
# redesign, a `--baseline` source): each phase's block emptied
_ITER_ONE_THREAD_PHASES = {
    "no phase 0": _cut("    T P[NX][NX], p[NX];",
                       "  }\n\n  // ---- phase 1"),
    "no phase 1": _cut("    T x[NX];\n    {\n      auto x0 = lane(",
                       "  }\n  const T nin"),
    "no phase 2": _cut("    T p[NX];\n    {\n      auto pt = lane(",
                       "  }\n\n  // ---- phase 3"),
    "no phase 3": _cut(_XT, "  }\n  T alpha = tmin", _XT),
    "no phase 4": _cut("  const T shrink = T(1) - alpha;\n",
                       "}\n\n}  // namespace"),
}

# K8a's and K9a's, on csrc/riccati.cu (one body, `sweep<T, ROLL>`)
_RIC_ROLL = "  if constexpr (ROLL) {"
_RIC_SETS = "constexpr int kSets = 3;"
_RIC_END = "  }\n\n" + _RIC_ROLL
BACKWARD_VARIANTS = {
    "kernel": None,
    "G=8": _G8,
    "G=32": VARIANTS["G=32"],
    "256 threads": _replace("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 256;"),
    "8 blocks an SM": _replace("(sizeof(T) == 4 ? 512 : 256) / kThreads",
                               "(sizeof(T) == 4 ? 1024 : 256) / kThreads"),
    "no backward loads": _cut("    stage_in<NX, RW>(sh, AT, A,",
                              "    copy_wait();"),
    "no phase A": _cut("    // P [A | B | c] (phase A)", "    // B' [PA | m",
                       _BARRIER),
    "no phase B": _cut("    // B' [PA | m", "    // L = chol(Quu)", _BARRIER),
    "no phase C": _cut("    // L = chol(Quu)", "    // the stage's gains out",
                       _BARRIER),
    "no stores": _cut("    // the stage's gains out", "    // X = A'PA"),
    "no phase D": _cut("    // X = A'PA", _RIC_END),
}
RICCATI_VARIANTS = {
    **BACKWARD_VARIANTS,
    "2 sets": _replace(_RIC_SETS, _RIC_SETS.replace("3", "2")),
    "no rollout": _replace(_RIC_ROLL, "  if constexpr (false) {"),
}

# K9b's, on the same source (its own constants): K5b's study at 4 inputs
_K9B_GROUP = "constexpr int kFwdGroup = 16;"
_K9B_THREADS = "constexpr int kFwdThreads = 256;"
_K9B_SETS = "constexpr int kFwdSets = 2;"
_K9B_DX = "    // K9b's dx_{k+1} = A x + B u + c"
FORWARD_VARIANTS = {
    "kernel": None,
    "3 sets": _then(_replace(_K9B_SETS, _K9B_SETS.replace("2", "3")),
                    _replace("kFwdLaneValues == 636",
                             "kFwdLaneValues == 939")),
    "G=8": _then(_replace(_K9B_GROUP, _K9B_GROUP.replace("16", "8")),
                 _replace(_K9B_THREADS, _K9B_THREADS.replace("256", "128"))),
    "32 lanes": _replace(_K9B_THREADS, _K9B_THREADS.replace("256", "512")),
    "G=8, 32 lanes": _replace(_K9B_GROUP, _K9B_GROUP.replace("16", "8")),
    "no loads": _replace(
        "    if (k + kFwdSets - 1 < N) roll_in(k + kFwdSets - 1);\n", ""),
    "no u phase": _cut("    // K9b's u = K x + kff", "    // K9b's x_k out"),
    "no dx phase": _cut(_K9B_DX, "    cp_wait_group<kFwdSets - 2>();"),
    "no stores": _then(
        _replace("      if (valid) du[((size_t)k * NU + a)",
                 "      if (valid && B < 0) du[((size_t)k * NU + a)"),
        _cut("    // K9b's x_k out", "    __syncthreads();\n" + _K9B_DX)),
}

# K8b's and K9c's, on the same source (one body, `vec_sweep_group<T,
# ROLLOUT>`, on K9b's constants): K5c's study at 4 inputs, the stores kept
# alive behind B < 0; K8b's "no loads" cuts both passes' stage-loop loads
_VEC_DX = "      // K8b's dx_{k+1} = A x + B u + c"
_VEC_ROLL = "  if constexpr (ROLLOUT) {\n    // K8b's rollout."
_VEC_P = "    // K8b's and K9c's p update"
_VEC_KFF = "    // K8b's and K9c's kff solve"
VECTOR_VARIANTS = {
    "kernel": None,
    "2 sets": _then(_replace("constexpr int kVecSets = 3;",
                             "constexpr int kVecSets = 2;"),
                    _replace("kVecLaneValues == 1059",
                             "kVecLaneValues == 716")),
    **{name: FORWARD_VARIANTS[name]
       for name in ("G=8", "32 lanes", "G=8, 32 lanes")},
    "no loads": _then(
        _replace("      vec_in(k - kVecSets + 1);\n", ""),
        _replace("      if (k + kVecSets - 1 < N) "
                 "roll_in(k + kVecSets - 1);\n", "")),
    "no m/Qu phase": _cut("    // K8b's and K9c's m = p + Pc", _VEC_P,
                          _BARRIER),
    "no p update": _cut(_VEC_P, _VEC_KFF),
    "no kff solve": _cut(_VEC_KFF, "    cp_wait_group<kVecSets - 2>();"),
    "no stores": _then(
        _replace("        if (valid) kff[",
                 "        if (valid && B < 0) kff["),
        _replace("        if (valid) du[((size_t)k * NU + a) * B + b0 + l] "
                 "= u;  // K8b's du",
                 "        if (valid && B < 0) du[((size_t)k * NU + a) * B "
                 "+ b0 + l] = u;"),
        _cut("      // K8b's x_k out", "      __syncthreads();\n" + _VEC_DX)),
}
CORRECTOR_VARIANTS = {
    **VECTOR_VARIANTS,
    "no rollout": _replace(_VEC_ROLL, _VEC_ROLL.replace("ROLLOUT", "false")),
}

# K6's, on csrc/condensed_c2.cu (K1's block): 4 or 16 workers a lane, 64
# lanes a block, or one part removed (every global load, each value then
# made from its lane and index; the row jobs; the cost columns; the
# stores: every stored value summed into one that is never stored)
_C2_THREADS = "constexpr int kThreads = 256;"
_C2_END = "  }\n}\n\n// dx_odd[k]"
CONDENSE_VARIANTS = {
    "kernel": None,
    "4 workers": _replace(_C2_THREADS, _C2_THREADS.replace("256", "128")),
    "16 workers": _replace(_C2_THREADS, _C2_THREADS.replace("256", "512")),
    "64 lanes": _then(
        _replace("constexpr int kLanes = 32;", "constexpr int kLanes = 64;"),
        _replace(_C2_THREADS, _C2_THREADS.replace("256", "512"))),
    "no loads": _replace("    return base[(size_t)r * B + b];",
                         "    return T(b + r);"),
    "no row jobs": _cut("  // 2. the row jobs", "  // 3. the cost columns"),
    "no cost columns": _cut("  // 3. the cost columns", "// dx_odd[k]",
                            "}\n\n"),
    "no stores": _then(
        _replace("  const auto put = [&](T* base, int r, T v) {\n"
                 "    if (valid) __stcs(base + (size_t)r * B + b, v);\n  };",
                 "  T sink = T(0);\n"
                 "  const auto put = [&](T*, int, T v) { sink = sink + v; };"),
        _replace(_C2_END, "  }\n  if (valid && B < 0) Abar[b] = sink;\n}\n\n"
                 "// dx_odd[k]")),
}

# P1's, on csrc/sol_probes.cu: 16 or 32 lanes a block, `__launch_bounds__`
# asking float32 for half the blocks an SM (128 registers a row instead of
# 64), the 13 rows packed flat (thread t of a block is lane t / 13, row t
# % 13: no idle thread) at 16 or 32 lanes a block, or 2 or 4 rows of c a
# thread (8 or 4 threads a lane, each b entry it loads used 2 or 4 times)
_FMA_ROWS = "constexpr int kFmaRows = 1;"
_FMA_GROUP = "constexpr int kFmaGroup = 16;"
_FMA_THREADS = "constexpr int kFmaThreads = 128;"


def _fma_shape(group, threads, rows=1):
    return _then(_replace(_FMA_ROWS, _FMA_ROWS.replace("1", str(rows))),
                 _replace(_FMA_GROUP, _FMA_GROUP.replace("16", str(group))),
                 _replace(_FMA_THREADS,
                          _FMA_THREADS.replace("128", str(threads))))


FMA_VARIANTS = {
    "kernel": None,
    "16 lanes": _fma_shape(16, 256),
    "32 lanes": _fma_shape(16, 512),
    "2 blocks an SM": _replace("(sizeof(T) == 4 ? 1024 : 512)",
                               "(sizeof(T) == 4 ? 512 : 256)"),
    "packed 13": _fma_shape(13, 208),
    "packed 13, 32 lanes": _fma_shape(13, 416),
    "2 rows a thread": _fma_shape(8, 64, rows=2),
    "4 rows a thread": _fma_shape(4, 32, rows=4),
}

# kernel: (source, variants, mangled name of its float32 exact form, or
# the names of its forms in this source and in the `--baseline` one)
KERNELS = {
    "kkt_sweep_c2": (_SOURCE, VARIANTS, "kkt_sweep_c2_kernelIfffLb0E"),
    "corrector_sweep_c2": ("corrector_sweep_c2.cu", CORR_VARIANTS,
                           "corrector_sweep_c2_kernelIfffLb0E"),
    "prep_condense2": ("prep_condense2.cu", PREP_VARIANTS,
                       "prep_condense2_kernelIfLi4E"),
    "bwd_c2": (_SOURCE, BWD_VARIANTS, "bwd_c2_kernelIfE"),
    "fwd_c2": ("corrector_sweep_c2.cu", FWD_VARIANTS, "fwd_c2_kernelIfE"),
    "iter_sweep_c2": ("iter_c2.cu", ITER_VARIANTS, "iter_sweep_c2_kernelIfE"),
    "kkt_sweep": ("riccati.cu", RICCATI_VARIANTS,
                  ("kkt_sweep_kernelIfE", "kkt_sweep_kernelIfLb1E")),
    "backward_sweep": ("riccati.cu", BACKWARD_VARIANTS,
                       ("backward_sweep_kernelIfE", "kkt_sweep_kernelIfLb0E")),
    "bwd_vec_c2": ("corrector_sweep_c2.cu", VEC_VARIANTS,
                   "bwd_vec_c2_kernelIfE"),
    "forward_sweep": ("riccati.cu", FORWARD_VARIANTS,
                      "forward_sweep_kernelIfE"),
    "corrector_sweep": ("riccati.cu", CORRECTOR_VARIANTS,
                        "corrector_sweep_kernelIfE"),
    "backward_vector_sweep": ("riccati.cu", VECTOR_VARIANTS,
                              "backward_vector_sweep_kernelIfE"),
    "condense2": ("condensed_c2.cu", CONDENSE_VARIANTS,
                  "condense2_kernelIfE"),
    "fma_chain": ("sol_probes.cu", FMA_VARIANTS, "fma_chain_kernelIfE"),
}
# the constants of a kernel's launch shape (threads a lane, a block) where
# its source names them otherwise (K9b, K8b and K9c beside K8a's kGroup
# and kThreads)
SHAPE_CONSTANTS = {
    **dict.fromkeys(("forward_sweep", "corrector_sweep",
                     "backward_vector_sweep"), ("kFwdGroup", "kFwdThreads")),
    "fma_chain": ("kFmaGroup", "kFmaThreads")}
# the CUDA function of a kernel, where the one-thread source named it
# otherwise (K9a: `kkt_sweep_kernel<T, false>`)
SYMBOLS = {"backward_sweep": r"(?:backward|kkt)_sweep_kernel"}
# the variants of a kernel's `--baseline` source besides the source itself
BASELINE_VARIANTS = {"iter_sweep_c2": _ITER_ONE_THREAD_PHASES}
# the sweeps' float32 entries: (input pointers, output shapes at (M, B),
# the name of the constant holding the values a lane in shared memory)
_NX, _NU, _NL = ck.NX, ck.NUC, ck.NLC
_GAINS = lambda M, B: ((M, _NU, _NX, B), (M, _NU, B), (M, _NL, B),  # noqa
                       (M, _NX, B))
_ROLL = lambda M, B: ((M + 1, _NX, B), (M, _NU, B))  # noqa: E731
# the uncondensed sweeps' (4 inputs)
_UGAINS = lambda N, B: ((N, rk.NU, _NX, B), (N, rk.NU, B),  # noqa: E731
                        (N, rk.NL, B), (N, _NX, B))
_UROLL = lambda N, B: ((N + 1, _NX, B), (N, rk.NU, B))  # noqa: E731
SWEEPS = {
    "kkt_sweep_c2": (12, lambda M, B: _GAINS(M, B) + _ROLL(M, B), "kStride"),
    "corrector_sweep_c2": (10, _ROLL, "kLaneValues"),
    "bwd_c2": (11, _GAINS, "kBwdStride"),
    "fwd_c2": (6, _ROLL, "kFwdLaneValues"),
    # the 25 inputs and the 7 scratch arrays of iter_sweep_c2's scratch,
    # out alpha and mu (the 14 carried inputs are outputs too)
    "iter_sweep_c2": (32, lambda M, B: ((1, B), (1, B)), "kStride"),
    "kkt_sweep": (10, lambda N, B: _UGAINS(N, B) + _UROLL(N, B), "kStride"),
    "backward_sweep": (9, _UGAINS, "kStride"),
    "bwd_vec_c2": (8, lambda M, B: ((M, _NU, B),), "kVecLaneValues"),
    "forward_sweep": (6, _UROLL, "kFwdLaneValues"),
    "corrector_sweep": (10, _UROLL, "kVecLaneValues"),
    "backward_vector_sweep": (8, lambda N, B: ((N, rk.NU, B),),
                              "kVecLaneValues"),
    # K6's at M = N/2 stage pairs: the condensed stage (condense2_ref's
    # dict, in order)
    "condense2": (6, lambda M, B: (
        (M, _NX, _NX, B), (M, _NX, _NU, B), (M, _NX, B), (M, _NX, _NX, B),
        (M, rk.NU, _NX, B), (M, rk.NU, rk.NU, B), (M, _NX, B), (M, _NU, B)),
        "kLaneValues"),
    # P1's: c (13,13,B) after FMA_REPS products
    "fma_chain": (2, lambda M, B: ((_NX, _NX, B),), "kFmaLaneValues"),
}
# K10's carried inputs (condensed_kernels._ITER_CARRIED) by position, its
# fraction to the boundary and its float arguments in float32 (tau, the
# mu floor, the smallest normal)
_ITER_CARRIED = (17, 18, 9, 10, 11, 12, 6, 8, 2, 13, 14, 20, 21, 22)
_ITER_TAU = 0.995
_ITER_FLOATS = (_ITER_TAU, 100.0 * torch.finfo(torch.float32).eps ** 2,
                torch.finfo(torch.float32).tiny)


def sources(kernel="kkt_sweep_c2") -> dict:
    """{variant name: its source text} of `kernel`."""
    source, variants, _ = KERNELS[kernel]
    src = (_build.CSRC / source).read_text()
    return {name: edit(src) if edit else src
            for name, edit in variants.items()}


def prep_lane_values(text) -> dict:
    """{vde_order: values a lane in shared memory} of a K1 source text
    (its static_assert), {} for the one-thread source."""
    m = re.search(r"kLaneValues<4> == (\d+) && kLaneValues<2> == (\d+)",
                  text)
    return {4: int(m.group(1)), 2: int(m.group(2))} if m else {}


def shape(text, kernel=None) -> tuple:
    """(threads per lane, threads a block) of a variant's source text (K1's:
    kThreads / kLanes threads a lane; K9b's its SHAPE_CONSTANTS; (1, 128)
    for a one-thread source, which has neither)."""
    group_c, threads_c = SHAPE_CONSTANTS.get(kernel, ("kGroup", "kThreads"))
    const = {name: int(m.group(1)) for name in (group_c, "kLanes", threads_c)
             if (m := re.search(rf"constexpr int {name} = (\d+);", text))}
    if threads_c not in const:
        return 1, 128
    group = const.get(group_c) or const[threads_c] // const["kLanes"]
    return group, const[threads_c]


def lane_values(kernel, text):
    """Values a lane in shared memory of a sweep's source `text` (the
    static_assert on its geometry constant), None for a one-thread
    source."""
    m = re.search(rf"static_assert\({SWEEPS[kernel][2]} == (\d+),", text)
    return int(m.group(1)) if m else None


def symbol(kernel) -> str:
    """A regular expression that finds `kernel`'s CUDA function (in this
    source or a `--baseline` one) in a source or a trace."""
    return SYMBOLS.get(kernel, rf"{kernel}_kernel")


def baseline_source(kernel, csrc) -> str:
    """The file of the `csrc` directory that defines `kernel`'s CUDA
    function: its source here, or the one-thread kernels'
    `condensed_c2.cu`."""
    for name in (KERNELS[kernel][0], "condensed_c2.cu"):
        path = Path(csrc) / name
        if path.exists() and re.search(symbol(kernel), path.read_text()):
            return name
    raise ValueError(f"kkt_variants: no source in {csrc} defines {kernel}")


def baseline_texts(kernel, csrc) -> dict:
    """{variant name: source text} of `kernel`'s source in the `csrc`
    directory (`baseline_source`): "baseline", and each of its
    `BASELINE_VARIANTS` as "baseline <name>"."""
    text = (Path(csrc) / baseline_source(kernel, csrc)).read_text()
    return {"baseline": text,
            **{f"baseline {name}": edit(text) for name, edit in
               BASELINE_VARIANTS.get(kernel, {}).items()}}


def bitwise_report(got, base) -> str:
    """"True" when every output equals the baseline's bit for bit, else
    "False" with, for each output that differs, its position among the
    outputs, the entries that differ and the largest difference relative
    to max(1, max |baseline|)."""
    diffs = [(i, int((g != w).sum()), g.numel(), float(
        (g.double() - w.double()).abs().max()) / max(1.0, float(
            w.abs().max()))) for i, (g, w) in enumerate(zip(got, base))]
    parts = [f"output {i}: {n} of {size} entries, {rel:.1e}"
             for i, n, size, rel in diffs if n]
    return "True" if not parts else "False (" + "; ".join(parts) + ")"


def _whole(name) -> bool:
    """Whether the variant `name` computes the whole kernel (no part cut
    out: it is checked against the plain version)."""
    return re.search(r"(^| )no ", name) is None


def _stem(kernel, name):
    return f"{kernel}_" + re.sub(r"\W+", "_", name).strip("_")


def build(texts, kernel="kkt_sweep_c2", baseline=None) -> dict:
    """Compile every variant at once, the texts named "baseline..."
    (`baseline_texts`) with the headers of the `csrc` directory
    `baseline`; {name: (library, ptxas lines of its float32 exact-form
    instance)}."""
    out_dir = _build.BUILD_DIR / "variants"
    dirs = {name: out_dir / "baseline" if name.startswith("baseline")
            else out_dir for name in texts}
    for d, csrc in ((out_dir, _build.CSRC),
                    (out_dir / "baseline", baseline)):
        if csrc is not None:
            d.mkdir(parents=True, exist_ok=True)
            for h in Path(csrc).glob("*.cuh"):
                shutil.copy(h, d / h.name)
    jobs = {}
    for name, text in texts.items():
        cu = dirs[name] / f"{_stem(kernel, name)}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kkt_variants: {name} failed to build:\n{log}")
        lines, on = [], False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                on = any(m in line for m in mangled_forms(kernel))
                form = "order 2: " if on and "Li2E" in line else ""
            elif on and ("spill" in line or "Used " in line):
                lines.append(form + line.split(":", 1)[-1].strip())
        built[name] = (ctypes.CDLL(str(lib)), lines)
    return built


def mangled_forms(kernel):
    """The mangled names whose `ptxas -v` lines `build` keeps: the float32
    exact form's (K1's in both VDE orders)."""
    mangled = KERNELS[kernel][2]
    if isinstance(mangled, tuple):
        return mangled
    if kernel == "prep_condense2":
        return mangled, mangled.replace("Li4E", "Li2E")
    return (mangled,)


def prep_launcher(lib, text, order=4):
    """f(args) -> outputs: a K1 variant's float32 entry of VDE order `order`
    on K1's 8 inputs, at the launch shape of its source `text`; the
    one-thread source's entry takes no geometry."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk

    group, threads = shape(text)
    values = prep_lane_values(text)
    fn = getattr(lib, f"prep_condense2{'_o2' if order == 2 else ''}_f32")
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * (
        5 if values else 2) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lanes = threads // group
    nx, nu = pk.NX, pk.NU

    def run(args):
        N, B = args[1].shape[0], args[1].shape[-1]
        M = N // 2
        outs = tuple(torch.empty(s, dtype=torch.float32, device=args[0].device)
                     for s in ((M, nx, nx, B), (M, nx, 2 * nu, B), (M, nx, B),
                               (M, nx, nx, B), (M, nu, nx, B), (M, nu, nu, B),
                               (M, nx, B), (M, 2 * nu, B), (M, nx, nx, B),
                               (M, nx, nu, B), (N, nx, B), (N, nu, B),
                               (N, nu, B)))
        geo = [math.ceil(B / lanes), threads,
               lanes * values[order] * 4] if values else []
        err = fn(*[t.data_ptr() for t in (*args, *outs)], M, B, *geo,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kkt_variants: CUDA error {err}")
        return outs
    return run


def launcher(lib, text, kernel="kkt_sweep_c2"):
    """f(args) -> outputs: the variant's float32 exact form on the sweep's
    inputs (`SWEEPS`; K1's 8 through `prep_launcher`), at the launch shape
    of its source `text` (none for a one-thread source)."""
    if kernel == "prep_condense2":
        return prep_launcher(lib, text)
    group, threads = shape(text, kernel)
    values = lane_values(kernel, text)
    n_in, shapes, _ = SWEEPS[kernel]
    iteration = kernel == "iter_sweep_c2"
    floats = _ITER_FLOATS if iteration else ()
    fn = getattr(lib, f"{kernel}_f32")
    n_out = len(shapes(1, 1))
    fn.argtypes = ([ctypes.c_void_p] * (n_in + n_out)
                   + [ctypes.c_double] * len(floats)
                   + [ctypes.c_int] * (5 if values else 2) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lanes = threads // group

    def run(args):
        M, B = args[0].shape[0], args[0].shape[-1]
        # K6's M stage pairs of its N stages; P1's entry takes its reps
        M = M // 2 if kernel == "condense2" else M
        lead = FMA_REPS if kernel == "fma_chain" else M
        outs = tuple(torch.empty(s, dtype=torch.float32, device=args[0].device)
                     for s in shapes(M, B))
        geo = [math.ceil(B / lanes), threads,
               lanes * values * 4] if values else []
        err = fn(*[t.data_ptr() for t in (*args, *outs)], *floats, lead, B,
                 *geo, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kkt_variants: CUDA error {err}")
        if iteration:   # the carried inputs, updated in place, come first
            return tuple(args[i] for i in _ITER_CARRIED) + outs
        return outs
    return run


def fresh(kernel, args):
    """`args` with a copy of each input the kernel updates in place (K10's
    carried ones), so that every launch starts from the same iterate."""
    if kernel != "iter_sweep_c2":
        return args
    return tuple(a.clone() if i in _ITER_CARRIED else a
                 for i, a in enumerate(args))


def calls(kernel, run, args, n):
    """f() -> run's outputs on `args`, for n calls; for K10 each call on a
    copy of its own (`fresh`), all made here, before any call is timed."""
    if kernel != "iter_sweep_c2":
        return lambda: run(args)
    copies = iter([fresh(kernel, args) for _ in range(n)])
    return lambda: run(next(copies))


def rel_err(got, want):
    """max over outputs of max |got - want| / max(1, max |want|)."""
    return max(float((g.double() - w.double()).abs().max())
               / max(1.0, float(w.abs().max())) for g, w in zip(got, want))


def _plain(kernel, order=4):
    """The plain version of `kernel`'s float32 exact form (of VDE order
    `order` for K1), flattened to its list of outputs."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk

    if kernel == "prep_condense2":
        def ref(*args):
            cnd, *rest = pk.prep_condense2_ref(*args, vde_order=order)
            return [*cnd.values(), *rest]
        return ref
    if kernel == "iter_sweep_c2":
        return lambda *args: ck.iter_sweep_c2_ref(*args[:25], _ITER_TAU)
    if kernel == "bwd_vec_c2":   # one output, as a list
        return lambda *args: [ck.bwd_vec_c2_ref(*args)]
    if kernel == "backward_vector_sweep":
        return lambda *args: [rk.backward_vector_sweep_ref(*args)]
    if kernel == "condense2":
        return lambda *args: list(ck.condense2_ref(*args).values())
    if kernel == "fma_chain":
        return lambda *args: [sk.fma_chain_plain(*args, reps=FMA_REPS)]
    return {"kkt_sweep_c2": ck.kkt_sweep_c2_ref,
            "corrector_sweep_c2": ck.corrector_sweep_c2_ref,
            "bwd_c2": ck.bwd_c2_ref, "fwd_c2": ck.fwd_c2_ref,
            "kkt_sweep": rk.kkt_sweep_ref,
            "backward_sweep": rk.backward_sweep_ref,
            "forward_sweep": rk.forward_sweep_ref,
            "corrector_sweep": rk.corrector_sweep_ref}[kernel]


def iter_inputs(d, B, device):
    """K10's 25 inputs on the study's condensed data `d` (ipm_iter_sol's
    `condensed_data`: its dynamics and cost, R̄'s diagonal as ruu), with
    seeded slacks, duals and residuals and every bound finite (as on the
    main path: [0, 22] kRPM on every input), then the 7 arrays of its
    scratch (`condensed_kernels.iter_scratch`)."""
    rng = np.random.default_rng(1)
    c = d["cnd"]
    M = c["Abar"].shape[0]

    def seeded(lo, hi, *shape, normal=False):
        a = (hi * rng.standard_normal(shape) if normal
             else rng.uniform(lo, hi, shape))
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    s8 = (M, ck.NUC, B)
    lam_l, lam_u = seeded(0.05, 1.5, *s8), seeded(0.05, 1.5, *s8)
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    ins = (c["Abar"], c["Bbar"], c["cbar"], c["Qbar"], c["S1T"], c["R00"],
           c["qbar"], d["ruu"], c["rbar"] - lam_l + lam_u,
           seeded(0.1, 2.0, *s8), seeded(0.1, 2.0, *s8), lam_l, lam_u,
           seeded(0, 0.05, *s8, normal=True),
           seeded(0, 0.05, *s8, normal=True), ones(*s8), ones(*s8),
           seeded(0, 0.01, M, ck.NX, B, normal=True),
           seeded(0, 0.01, *s8, normal=True), d["pT"], d["p_term"],
           d["dx0"], seeded(0, 0.01, ck.NX, B, normal=True),
           2.0 * ck.NUC * M * ones(1, B), ones(1, B))
    return (tuple(a.contiguous() for a in ins)
            + tuple(ck.iter_scratch(M, B, torch.float32, device).values()))


def inputs(kernel, B, device, n=50):
    """`kernel`'s inputs at horizon n and B lanes: the study's condensed
    data (N=50; K2's and K5a's), K3's on K2's factorization of it, K5b's
    on K2's gains, K1's from the same warm start (the states before K7 and
    K6 condensed them), K8a's and K9a's K7's stage QP before K6 condensed
    it, K9b's on K8a's gains of it, K8b's and K9c's on K8a's factorization
    of it.  At n > 50 (K5a, K5b) every stage-wise input is
    the N=50 one repeated n/50 times along the stages."""
    from crazyflie_nmpc_tpu_torch.roofline.ipm_iter_sol import (
        condensed_data, probe_inputs)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import prep_tiles

    if kernel == "fma_chain":
        return probe_inputs(B, torch.float32, device)[0]
    d = condensed_data(B, device)
    if kernel == "condense2":
        return d["stage"]
    if kernel == "prep_condense2":
        st = d["states"]
        yb = d["yref"][:, :, None].expand(*d["yref"].shape, B).contiguous()
        return (st.x_traj.contiguous(), st.u_traj.contiguous(), yb,
                *prep_tiles(d["spec"], B, torch.float32, device))
    if kernel == "iter_sweep_c2":
        return iter_inputs(d, B, device)
    if kernel in ("kkt_sweep", "backward_sweep", "forward_sweep",
                  "corrector_sweep", "backward_vector_sweep"):
        A, Bm, c, qxx, qx, ru = d["stage"]
        k8 = (A, Bm, c, qxx, qx, d["ruu_stage"], ru, d["pT"], d["p_term"],
              d["dx0"])
        if kernel in ("kkt_sweep", "backward_sweep"):
            return k8 if kernel == "kkt_sweep" else k8[:-1]
        K, kff, L, Pc = rk.kkt_sweep_ref(*k8)[:4]
        return {"forward_sweep": (A, Bm, c, K, kff, d["dx0"]),
                "corrector_sweep": (A, Bm, c, qx, ru, K, L, Pc, d["p_term"],
                                    d["dx0"]),
                "backward_vector_sweep": (A, Bm, qx, ru, K, L, Pc,
                                          d["p_term"])}[kernel]
    c = d["cnd"]
    k2 = (c["Abar"], c["Bbar"], c["cbar"], c["Qbar"], c["S1T"], c["R00"],
          c["qbar"], d["ruu"], c["rbar"], d["pT"], d["p_term"], d["dx0"])
    if kernel == "kkt_sweep_c2":
        return k2
    K, kff, L, Pc, _, _ = ck.kkt_sweep_c2_ref(*k2)
    args = {"bwd_c2": k2[:-1],
            "fwd_c2": (c["Abar"], c["Bbar"], c["cbar"], K, kff, d["dx0"]),
            "corrector_sweep_c2": (c["Abar"], c["Bbar"], c["cbar"],
                                   c["qbar"], c["rbar"], K, L, Pc,
                                   d["p_term"], d["dx0"]),
            "bwd_vec_c2": (c["Abar"], c["Bbar"], c["qbar"], c["rbar"], K, L,
                           Pc, d["p_term"])}[kernel]
    reps = n // 50
    return tuple(a.repeat(reps, *[1] * (a.dim() - 1)) if a.dim() >= 3
                 else a for a in args)


def study(device=None, log=print, kernel="kkt_sweep_c2",
          baseline=None, variants=None) -> dict:
    """Build, check and time every variant of `kernel` (those named in
    `variants`, when given; and `baseline`, as `build`; K1's in both VDE
    orders); returns {name: {B: [ms, ms]}}, the device time of a launch
    (`device_ms`) in each of two passes.  Raises RuntimeError when a
    whole-stage variant disagrees with the plain version."""
    device = torch.device(device or "cuda")
    texts = sources(kernel)
    if variants is not None:
        texts = {name: texts[name] for name in variants}
    if baseline is not None:
        texts.update(baseline_texts(kernel, baseline))
    built = build(texts, kernel, baseline)
    for name, (_, lines) in built.items():
        log(f"ptxas {kernel} {name}: " + "; ".join(lines))
    runs = {name: launcher(lib, texts[name], kernel)
            for name, (lib, _) in built.items()}
    refs = dict.fromkeys(runs, _plain(kernel))
    if kernel == "prep_condense2":
        for name, (lib, _) in built.items():
            runs[name + ORDER2] = prep_launcher(lib, texts[name], order=2)
            refs[name + ORDER2] = _plain(kernel, order=2)
    check = inputs(kernel, BATCHES[0], device)
    base = (runs["baseline"](fresh(kernel, check)) if "baseline" in runs
            else None)
    for name, run in runs.items():
        if _whole(name):
            got = run(fresh(kernel, check))
            e = rel_err(got, refs[name](*check))
            same = ("" if base is None or name.endswith(ORDER2) else
                    f"; bitwise equal to the baseline: "
                    f"{bitwise_report(got, base)}")
            log(f"{kernel} {name}: rel err {e:.3e} against the plain version "
                f"at B={BATCHES[0]}, N=50{same}")
            if not e <= 1e-4:
                raise RuntimeError(f"kkt_variants: {kernel} {name} "
                                   f"disagrees ({e})")
    n = HORIZON.get(kernel, 50)
    data = {B: inputs(kernel, B, device, n) for B in BATCHES}
    log(f"{kernel}: timed at N={n}")
    times = {name: {B: [] for B in BATCHES} for name in runs}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        for B in BATCHES:
            # 21 calls: device_ms' warm-up and 20 traced launches
            times[name][B].append(device_ms(
                calls(kernel, runs[name], data[B], 21), 20,
                kernel=symbol(kernel))[0])
    for name, by_b in times.items():
        log(f"{kernel} {name}: " + ", ".join(
            f"B={B} " + " / ".join(f"{ms:.4f}" if ms is not None
                                   else "not measured" for ms in t) + " ms"
            for B, t in by_b.items()))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(KERNELS),
                    default="kkt_sweep_c2")
    ap.add_argument("--baseline", metavar="DIR",
                    help="a csrc directory whose copy of the kernel's "
                         "source runs as the variant 'baseline'")
    ap.add_argument("--variants", metavar="NAME,...",
                    help="the variants to run (default: all of the kernel's)")
    args = ap.parse_args(argv)
    variants = args.variants.split(",") if args.variants else None
    unknown = set(variants or ()) - set(KERNELS[args.kernel][1])
    if unknown:
        ap.error(f"no variant {', '.join(sorted(unknown))} of {args.kernel}")
    if not torch.cuda.is_available():
        print("kkt_variants: no CUDA device (the variants run on the card)",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    study(kernel=args.kernel, baseline=args.baseline, variants=variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
