#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crazyflie_nmpc_tpu_torch/csrc` (one
nvcc per source, all started together), holds each against its plain
PyTorch version at the main path's shapes (N=50, M=25; the uncondensed
preparation and sweeps at N=51 too) in float64 and float32, and drives
nine paths of the batched RTI step (`rti_step_batched`,
IPMConfig(iters=8) unless named, batch-last, float32), 20 chained steps
each, with launch counters proving which kernels ran:

  [main]         the default path at N=50, B = 1024, 4096 and 8192;
  [fused_iter]   fused_iter=True (one iter_sweep_c2 launch per
                 iteration), N=50, the same batches;
  [long]         N=400 (tf=6.0), B=4096, windowed=True (the split sweeps)
                 and windowed=None (the fused sweeps);
  [uncondensed]  condense=1 (prep_sweep, then kkt_sweep/corrector_sweep)
                 at N=50, the same batches, and the odd horizon N=51 with
                 the default condense at B=4096;
  [unfused_prep] fused_prep_condense=False (prep_sweep, condense2, the
                 condensed sweeps, the stride-2 expand2), N=50, B=4096;
  [split]        the stage QP of prepare_qp(fused_condense=False) solved
                 by solve_batched(fused=False) (backward_sweep,
                 forward_sweep, backward_vector_sweep) with the step's
                 update, N=50 and N=51, B=4096;
  [gondzio]      IPMConfig(iters=6, gondzio_correctors=1), N=50 and N=51,
                 B=4096;
  [throughput_mode] IPMConfig(iters=8, compress_gains=True,
                 compress_ab=True) with prep_vde_order=2 (the bf16-stream
                 forms of kkt_sweep_c2 / corrector_sweep_c2 and the
                 order-2 prep_condense2), N=50, B = 2048 and 4096;
  [xla_prep]     fused_prep=False (the jacfwd preparation in plain
                 PyTorch, then condense2, the condensed sweeps and the
                 stride-2 expand2), N=50, B=4096, held against [main]'s
                 step 1 too, and a sim_steps=2 spec at B=1024 (its bars
                 shown to catch faults planted in the preparation).

and seventeen paths of their own:

  [single]       the single-instance rti_step (plain PyTorch), N=50, 20
                 closed-loop ticks from a 1.5 m offset, and one certified
                 tick;
  [swarm]        runtime.batch.monte_carlo_hover (the Monte-Carlo closed
                 loop on rti_step_batched: K1-K4 every tick), N=50,
                 B=4096, float32, 150 ticks, held to the JAX package's
                 lane bar (every lane within 0.02 m of its set-point);
  [closed_loop]  runtime.closed_loop's single-vehicle loops on the card
                 (hover_regulation under both predictors,
                 estimator_in_the_loop, cmd_vel_loop with the motvel
                 predictor and lag gains), N=50, float64, 5 ticks each,
                 held against the port's CPU run;
  [flight]       flight_configuration (the paper's flown configuration:
                 helix, estimator chain, 60 ms delay, cmd_vel predictor,
                 onboard cascade), N=50, float64, 200 ticks, held to the
                 JAX package's tracking bars;
  [serving]      runtime.serving.ServingLoop (the default certified
                 config) at 66.6 Hz, N=50, float32, a batched RK4 plant on
                 the card: B=256 synchronous and pipelined (depth 2), B=1
                 synchronous, 200 ticks each, held to the JAX package's
                 lane bar (0.02 m) and tick 1 to the CPU float64 run;
  [swarm_wire]   bringup.swarm_serving: 16 cascade-plant vehicles over
                 the native UDP link in lockstep for 220 ticks (the JAX
                 package's bars), 2 vehicles in real time at 20 Hz for
                 80 ticks, and SwarmNMPC.step alone at 256 lanes; both
                 serving phases under the sync debug mode with their
                 host syncs counted (the emit and the escalation check);
                 the swarm's IPM algebra replayed from CUDA graphs
                 against the op-by-op steps, bit for bit;
  [tuning]       differentiable MPC (runtime.tuning, float64, the detuned
                 OCP of tests/test_tuning.py): the gradient through 20
                 hover ticks at N=15 (the JAX bars, and against the CPU)
                 and remat against stored gradients (12 ticks);
  [tuning_adam]  tune_diagonal_cost (8 Adam steps of 30 ticks, the JAX
                 bars);
  [tuning_wide]  one value and gradient at N=20, 45 ticks, stored and
                 remat: ms, launches a tick, host syncs, peak memory;
  [cartpole]     the custom-ODE path: sqp_solve's swing-up plan at N=40
                 (the JAX bars, f_max=40 too, 3 iterates against the CPU),
                 20 closed-loop swing-up ticks, simulate with delay 2;
  [client]       MissionClient.takeoff flown on rti_step, N=50, 160 ticks
                 (the JAX bars);
  [pod]          parallel.pod_rti_step on a one-rank NCCL group, N=50,
                 B=4096, float32, 20 chained steps beside the unsharded
                 step (equal to 1e-6, bitwise in practice), K1-K4 in its
                 counts and trace, fleet_metrics over the group;
  [pod_ranks]    the multi-rank pod path: 4 gloo ranks (processes)
                 sharing the card: pod_rti_step on 2 ranks x 2048 lanes
                 against the unsharded step; stage_sharded_rti_step at
                 N=50 (2 ranks) and N=400 (4 ranks), float64, against
                 rti_step, and at N=800, float32, against the windowed
                 rti_step_batched (K5a/b/c);
  [certified_loops] tests/test_certification.py's loops (hover from 0.3
                 m saturating, 24 ticks; the helix, 96 ticks; the batched
                 path, 5 ticks at B=3), float64, N=50, every tick's plan
                 within 1e-4 of the numpy oracle tests/_reference_rti.py;
  [pscan]        ops/riccati_pscan.py (the associative-scan Riccati):
                 float64 at N=50 and 200 against the sequential
                 ops.riccati on the card and against its own CPU run
                 (tests/test_riccati.py's bars), with no host sync; then
                 the B=1 float32 crossover against the sequential sweep
                 at N = 50 / 200 / 800 (ms, host issue, launches,
                 accuracy: reported, no bar);
  [bringup]      the launch layer (bringup, tools), every UDP port 0:
                 nmpc_predictor (30 ticks, both actuations) and
                 nmpc_attitude_bench (60 ticks, its bag replayed) held
                 against the port's CPU runs, pid_waypoints (its steps
                 equal to the CPU run's), the host-side compositions at
                 tests/test_bringup.py's bars, a session with a
                 swarm_serving pane (4 vehicles, 60 ticks: K1-K4 every
                 tick) beside telemetry and teleop panes and one with a
                 crashing pane, the CLI tools and `python -m
                 crazyflie_nmpc_tpu_torch.bringup teleop`;
  [roofline]     the speed-of-light probes fma_chain and stage_replay
                 against their plain versions (on inputs whose output
                 depends on every product and stage; both at B = 1024,
                 1000, 1003 and 1), then the study of
                 crazyflie_nmpc_tpu_torch/roofline/ipm_iter_sol.py at N=50,
                 B=4096 (its table on the lines it prints).

Each path's step 1 is held against the port's float64 CPU run, and the
sweeps of [long] against their plain versions at N=400 too; [split]'s
against the fused sweeps on the same QP, [throughput_mode]'s against the
uncompressed float64 answer as well.  It also
checks the certified path's per-lane escalation on a 1.5 m step transient,
times each kernel at the shapes of the path that runs it (its device time
from a profiler trace of 20 launches, beside the CUDA-event window around
them, which holds the host's issue too), times K1, K2, K3, K5c, K8a,
K9a, K9b, K8b, K9c, K10 and K6 (the kernels that split a lane over
several threads: csrc/prep_condense2.cu in both VDE orders,
csrc/kkt_sweep_c2.cu and csrc/corrector_sweep_c2.cu in their four forms,
the latter's bwd_vec_c2, csrc/riccati.cu's kkt_sweep, backward_sweep,
forward_sweep, corrector_sweep and backward_vector_sweep,
csrc/iter_c2.cu, csrc/condensed_c2.cu's condense2) at every B
of [main] with their occupancy, waves and bound, K5a/b/c, K2 and K3 at
N=400 too, and traces a few steps of [main]
(every B), [fused_iter], [uncondensed], [unfused_prep], [split],
[gondzio], [throughput_mode] and [xla_prep] ([single] its own ticks) with
torch.profiler.  [pod] runs in a child process of its own after
[swarm_wire]; the host-bound loops
([tuning] to [client], [closed_loop], [flight]), [pod_ranks] and
[certified_loops] and [bringup] run last, at once, each group in a
child process of its own (CONCURRENT).
Exits non-zero if any phase fails, or when no CUDA device is present.

The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import re
import subprocess
import sys
import time

# the H100's published peaks and the CUDA-event timer, shared with the
# speed-of-light study (fails outside the repo: the port is needed)
from crazyflie_nmpc_tpu_torch.roofline import (HBM_BYTES_PER_S,
                                               PEAK_FP32_FLOPS, device_ms,
                                               time_events, traced_kernels)

# main path: the reference OCP at full width
N = 50
M = N // 2
TF = 0.75             # horizon [s] at N: 15 ms stages
ITERS = 8
STEPS = 20
B_MAIN = (1024, 4096, 8192)
B_CHECK = 1024        # kernel-vs-plain checks
B_RAGGED = 1000       # K1's check on a ragged last tile (31 x 32 + 8)
K1_FORMS = ("prep_condense2", "prep_condense2 vde_order=2")
B_TIME = 4096         # per-kernel timing
N_REF_LANES = 64      # lanes held against the CPU float64 run
# long horizon (bench.py's N=400, tf=6.0 parity cell)
N_LONG = 400
B_LONG = 4096
N_LONG_REF_LANES = 8
N_ODD = N + 1         # the odd horizon of [uncondensed]

PHASES = ("build", "kernels", "main", "fused_iter", "long", "uncondensed",
          "unfused_prep", "split", "gondzio", "throughput_mode", "xla_prep",
          "single", "roofline", "certified", "timing", "pscan", "swarm",
          "closed_loop", "flight", "serving", "swarm_wire", "pod", "tuning",
          "tuning_adam", "tuning_wide", "cartpole", "client", "pod_ranks",
          "certified_loops", "bringup")
# Host-bound plain-PyTorch phases run last, each group of them in a child
# process of its own and the groups at once (the card idles > 0.9 of each
# one's time): in sequence they took ~1200 s of a slow host's run, the
# limit; five groups at once took 334.8 s, the longest group's time
# (PERF.md §6)
CONCURRENT = (("tuning", "client"), ("tuning_adam",), ("tuning_wide",),
              ("cartpole",), ("closed_loop",), ("flight",), ("pod_ranks",),
              ("certified_loops",), ("bringup",))
B_THROUGHPUT = (2048, 4096)   # bench.py's throughput-mode operating point
GONDZIO = dict(iters=6, gondzio_correctors=1)     # bench.py's 6+1 point
THROUGHPUT = dict(iters=8, compress_gains=True, compress_ab=True)
# the JAX package's own throughput-mode step on [throughput_mode]'s
# N_REF_LANES lanes (B=2048, seed 2048), Pallas in interpret mode on the
# CPU: `python tools/throughput_envelope.py` (its JSON line).  dev_*: max
# |du - du_exact| / max |du_exact| against the uncompressed float64 step;
# f32_vs_f64_*: its float32 run against its float64 one
JAX_THROUGHPUT = dict(du_exact_max=6.222269832743075,
                      dev_f64=0.15259322536710077,
                      dev_f32=0.1473521350790647,
                      f32_vs_f64_u0=0.03820863421097087,
                      f32_vs_f64_x_plan=0.2731285092978418)

# Tolerances of kernel vs plain version, as max |kernel - plain| over
# max(1, max |plain|), per output.  float64: both evaluate the same
# formulas in another order (FMA contraction, the tangent form of A1 A0 in
# K1, the one-launch iteration's stage-sequential sums), so they agree to
# a few hundred ulp even through the 25-stage Riccati recursion.  float32:
# the same reorderings at eps = 1.2e-7, grown by the sequential recursion
# (P reaches ~1e4 with W_e = 50 Q) and the 8x8 Cholesky.
TOL = {"float64": 1e-10, "float32": 1e-4}

_PALLAS = "crazyflie_nmpc_tpu/ops/pallas/"
KERNEL_INFO = {
    "prep_condense2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/prep_condense2.cu",
        replaces=_PALLAS + "prep_kernel.py:384"),
    "kkt_sweep_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/kkt_sweep_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:446"),
    "corrector_sweep_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/corrector_sweep_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:1206"),
    "expand2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/condensed_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:282"),
    "bwd_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/kkt_sweep_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:541"),
    "fwd_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/corrector_sweep_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:607"),
    "bwd_vec_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/corrector_sweep_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:589"),
    "iter_sweep_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/iter_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:1009"),
    "prep_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/prep_sweep.cu",
        replaces=_PALLAS + "prep_kernel.py:485"),
    "condense2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/condensed_c2.cu",
        replaces=_PALLAS + "condensed_kernels.py:209"),
    "kkt_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/riccati.cu",
        replaces=_PALLAS + "riccati_kernels.py:459"),
    "corrector_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/riccati.cu",
        replaces=_PALLAS + "riccati_kernels.py:584"),
    "backward_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/riccati.cu",
        replaces=_PALLAS + "riccati_kernels.py:233"),
    "forward_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/riccati.cu",
        replaces=_PALLAS + "riccati_kernels.py:327"),
    "backward_vector_sweep": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/riccati.cu",
        replaces=_PALLAS + "riccati_kernels.py:665"),
}
# the speed-of-light probes (ops.cuda.PROBES), on no solver path: checked,
# driven and timed by [roofline], listed in the kernels line after
# KERNEL_INFO's
PROBE_INFO = {
    "fma_chain": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/sol_probes.cu",
        replaces="tools/ipm_iter_sol.py:112"),
    "stage_replay": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/sol_probes.cu",
        replaces="tools/ipm_iter_sol.py:154"),
}
# the other forms of a kernel, each checked and timed under its own label:
# the expansion of the full-horizon A/B (fused_prep_condense=False), the
# bf16-stream forms of the condensed sweeps (compress_gains: bf16 K/L/Pc;
# compress_ab: the deviation-coded bf16 Abar - I, Bbar, cbar) and the
# order-2 VDE preparations (prep_vde_order=2)
FORMS = {"expand2 stride 2": "expand2",
         "kkt_sweep_c2 bf16 gains": "kkt_sweep_c2",
         "kkt_sweep_c2 bf16 stream": "kkt_sweep_c2",
         "kkt_sweep_c2 bf16 gains+stream": "kkt_sweep_c2",
         "corrector_sweep_c2 bf16 gains": "corrector_sweep_c2",
         "corrector_sweep_c2 bf16 stream": "corrector_sweep_c2",
         "corrector_sweep_c2 bf16 gains+stream": "corrector_sweep_c2",
         "prep_condense2 vde_order=2": "prep_condense2",
         "prep_sweep vde_order=2": "prep_sweep"}
# the bf16-gain forms of K2 and their full-precision twins on the same
# inputs: the factorization is the same code in both, so the bf16 K, L and
# Pc are the twin's rounded to bfloat16 through float32, exactly
BF16_TWINS = {"kkt_sweep_c2 bf16 gains": "kkt_sweep_c2",
              "kkt_sweep_c2 bf16 gains+stream": "kkt_sweep_c2 bf16 stream"}
# the kernels of the uncondensed path, checked at the odd horizon too
UNCONDENSED_KERNELS = ("prep_sweep", "kkt_sweep", "corrector_sweep",
                       "backward_sweep", "forward_sweep",
                       "backward_vector_sweep")
SPLIT_KERNELS = ("backward_sweep", "forward_sweep", "backward_vector_sweep")
# the split sweeps run on the long-horizon path: timed at its shapes
LONG_KERNELS = ("bwd_c2", "fwd_c2", "bwd_vec_c2")
# the sweeps of that path (windowed=True and None), checked at its N too
LONG_CHECKED = LONG_KERNELS + ("kkt_sweep_c2", "corrector_sweep_c2")
# K5a, K5b and K5c (a group of threads per lane), checked on a ragged last
# tile and at B=1 ([pod_ranks] (d)'s shape) too, and timed at N=400 at
# every B of B_MAIN beside K2 and K3
WIN_KERNELS = ("bwd_c2", "fwd_c2", "bwd_vec_c2")
LONG_GROUP_KERNELS = WIN_KERNELS + ("kkt_sweep_c2", "corrector_sweep_c2")
# the group kernels checked on a ragged last tile and at B=1 besides K1:
# K5a, K5b, K5c, K10, K8a, K9a, K9b, K8b, K9c and K6 (B=1 is a ragged tile
# of each); K6 also at one stage pair (N_PAIR) on the ragged tile
RAGGED_KERNELS = WIN_KERNELS + ("iter_sweep_c2", "kkt_sweep",
                                "backward_sweep", "forward_sweep",
                                "corrector_sweep", "backward_vector_sweep",
                                "condense2")
N_PAIR = 2


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def hover_batch(spec, B, seed):
    """x0s (B, 13) on the spec's device: hover plus seeded noise of 0.05 on
    every state."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.models import hover_state
    rng = np.random.default_rng(seed)
    x = hover_state(spec.params, dtype=torch.float64, device="cpu")
    x0s = x[None] + 0.05 * torch.as_tensor(rng.standard_normal((B, 13)))
    return x0s.to(device=spec.lbu.device, dtype=spec.lbu.dtype)


def kernel_inputs(B, dtype, device, seed=0, n=N, finite=0.9):
    """Inputs of every kernel at horizon n (m = n/2 condensed stages): K1's
    and K7's from perturbed hover trajectories; K2's and bwd_c2's from K1's
    outputs (condensed QP data plus a barrier shift); K3's and
    bwd_vec_c2's from K2's factorization; fwd_c2's from K2's gains; K4's
    from both; iter_sweep_c2's from K1's outputs plus seeded slacks, duals,
    residuals and masks (a share 1 - `finite` of the bounds infinite, with
    s=1, lam=r3=r4=0 there); K6's and K8's from K7's outputs (K8's plus a
    barrier shift, its corrector from its factorization), K4's stride-2
    form from K7's A/B; K9's from K8's (its factorization's, and the
    corrector's right-hand side); the bf16-stream forms of K2/K3 from K2's
    inputs and factorization rounded to bfloat16 (Abar - I, Bbar, cbar;
    K, L, Pc); the order-2 preparations from K1's.  At odd n only K7, K8
    and K9 (UNCONDENSED_KERNELS).  Returns {label: (kernel wrapper, plain
    version, args)}, labelled by kernel name or FORMS label."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prep_tiles,
                                                             to_batch_last)

    m = n // 2
    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    r = lambda *s: tensor(rng.standard_normal(s))  # noqa: E731
    spec = default_ocp(N=n, tf=TF * n / N, dtype=dtype, device=device)
    yref, yref_e = hover_yref(spec, device=device)
    st = to_batch_last(init_rti(spec, hover_batch(spec, B, seed),
                                device=device))
    x = st.x_traj
    u = (st.u_traj + 0.3 * r(n, 4, B)).contiguous()
    yb = yref[:, :, None].expand(n, 17, B).contiguous()
    k1_in = (x, u, yb) + prep_tiles(spec, B, dtype, device)
    pT = torch.diagonal(spec.cost.W_e)[:, None].expand(13, B).contiguous()
    p_term = (pT * (x[-1] - yref_e[:, None])).contiguous()
    dx0 = (0.01 * r(13, B)).contiguous()

    # the uncondensed path: K7, then K8 on its stage data
    A, Bm, c7, qx7, ru7, _, _ = pk.prep_sweep_ref(*k1_in)
    qxx = k1_in[3][None].expand(n, 13, B).contiguous()
    k8_in = (A, Bm, c7, qxx, qx7,
             (k1_in[4][None] + tensor(rng.uniform(0.01, 1.0, (n, 4, B))))
             .contiguous(), ru7, pT, p_term, dx0)
    K8, kff8, L8, Pc8, _, _ = rk.kkt_sweep_ref(*k8_in)
    k8c_in = (A, Bm, c7, qx7, (ru7 + 0.1 * r(n, 4, B)).contiguous(), K8, L8,
              Pc8, p_term, dx0)
    inputs = {"prep_sweep": (pk.prep_sweep, pk.prep_sweep_ref, k1_in),
              "kkt_sweep": (rk.kkt_sweep, rk.kkt_sweep_ref, k8_in),
              "corrector_sweep": (rk.corrector_sweep, rk.corrector_sweep_ref,
                                  k8c_in),
              "backward_sweep": (rk.backward_sweep, rk.backward_sweep_ref,
                                 k8_in[:-1]),
              "forward_sweep": (rk.forward_sweep, rk.forward_sweep_ref,
                                (A, Bm, c7, K8, kff8, dx0)),
              "backward_vector_sweep": (
                  rk.backward_vector_sweep, rk.backward_vector_sweep_ref,
                  k8c_in[:2] + k8c_in[3:9])}
    if n % 2:
        return inputs

    cnd, Ae, Be, c, lb, ub = pk.prep_condense2_ref(*k1_in)
    ruu = (torch.diagonal(spec.cost.W)[13:].repeat(2)[None, :, None]
           .expand(m, 8, B).contiguous())
    ruu_shift = (ruu + tensor(rng.uniform(0.01, 1.0, (m, 8, B))))
    k2_in = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["Qbar"], cnd["S1T"],
             cnd["R00"], cnd["qbar"], ruu_shift, cnd["rbar"], pT, p_term,
             dx0)
    K, kff, L, Pc, dx, du = ck.kkt_sweep_c2_ref(*k2_in)
    k3_in = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["qbar"],
             (cnd["rbar"] + 0.1 * r(m, 8, B)).contiguous(), K, L, Pc,
             p_term, dx0)
    k4_in = (Ae, Be, c, dx[:-1].contiguous(), du[:, :4].contiguous())

    mask = lambda: tensor(rng.uniform(size=(m, 8, B)) < finite)  # noqa: E731
    m_l, m_u = mask(), mask()
    s_l = torch.where(m_l > 0, tensor(rng.uniform(0.1, 2.0, (m, 8, B))), 1.0)
    s_u = torch.where(m_u > 0, tensor(rng.uniform(0.1, 2.0, (m, 8, B))), 1.0)
    lam_l = m_l * tensor(rng.uniform(0.05, 1.5, (m, 8, B)))
    lam_u = m_u * tensor(rng.uniform(0.05, 1.5, (m, 8, B)))
    n_fin = m_l.sum(dim=(0, 1)) + m_u.sum(dim=(0, 1))
    scratch = ck.iter_scratch(m, B, dtype, device)
    k10_in = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["Qbar"], cnd["S1T"],
              cnd["R00"], cnd["qbar"], ruu,
              (cnd["rbar"] - lam_l + lam_u).contiguous(), s_l, s_u, lam_l,
              lam_u, m_l * 0.05 * r(m, 8, B), m_u * 0.05 * r(m, 8, B), m_l,
              m_u, 0.01 * r(m, 13, B), 0.01 * r(m, 8, B), pT, p_term, dx0,
              0.01 * r(13, B), torch.clamp(n_fin, min=1)[None].contiguous(),
              (n_fin > 0).to(dtype)[None].contiguous(), 0.995)
    stride2 = (A, Bm, c7, k4_in[3], k4_in[4])
    # K6's state cost differs between the two stages of a pair (the odd
    # one eliminated, the even one on Qbar's diagonal), so a swap shows
    qxx6 = (qxx * tensor(rng.uniform(0.5, 1.5, (n, 13, B)))).contiguous()
    # the bf16-stream forms (compress_gains, compress_ab)
    bf = torch.bfloat16
    eye = torch.eye(13, dtype=dtype, device=device)[:, :, None]
    stream = ((cnd["Abar"] - eye).to(bf), cnd["Bbar"].to(bf),
              cnd["cbar"].to(bf))
    gains = tuple(t.to(bf) for t in (K, L, Pc))
    part = functools.partial
    forms = {
        "kkt_sweep_c2 bf16 gains": (
            part(ck.kkt_sweep_c2, gains_dtype=bf),
            part(ck.kkt_sweep_c2_ref, gains_dtype=bf), k2_in),
        "kkt_sweep_c2 bf16 stream": (
            part(ck.kkt_sweep_c2, a_dev=True),
            part(ck.kkt_sweep_c2_ref, a_dev=True), stream + k2_in[3:]),
        "kkt_sweep_c2 bf16 gains+stream": (
            part(ck.kkt_sweep_c2, gains_dtype=bf, a_dev=True),
            part(ck.kkt_sweep_c2_ref, gains_dtype=bf, a_dev=True),
            stream + k2_in[3:]),
        "corrector_sweep_c2 bf16 gains": (
            ck.corrector_sweep_c2, ck.corrector_sweep_c2_ref,
            k3_in[:5] + gains + k3_in[8:]),
        "corrector_sweep_c2 bf16 stream": (
            part(ck.corrector_sweep_c2, a_dev=True),
            part(ck.corrector_sweep_c2_ref, a_dev=True),
            stream + k3_in[3:]),
        "corrector_sweep_c2 bf16 gains+stream": (
            part(ck.corrector_sweep_c2, a_dev=True),
            part(ck.corrector_sweep_c2_ref, a_dev=True),
            stream + k3_in[3:5] + gains + k3_in[8:]),
        "prep_condense2 vde_order=2": (
            part(pk.prep_condense2, vde_order=2),
            part(pk.prep_condense2_ref, vde_order=2), k1_in),
        "prep_sweep vde_order=2": (part(pk.prep_sweep, vde_order=2),
                                   part(pk.prep_sweep_ref, vde_order=2),
                                   k1_in)}
    return {**inputs, **forms,
            "prep_condense2": (pk.prep_condense2, pk.prep_condense2_ref,
                               k1_in),
            "kkt_sweep_c2": (ck.kkt_sweep_c2, ck.kkt_sweep_c2_ref, k2_in),
            "corrector_sweep_c2": (ck.corrector_sweep_c2,
                                   ck.corrector_sweep_c2_ref, k3_in),
            "expand2": (ck.expand2, ck.expand2_ref, k4_in),
            "bwd_c2": (ck.bwd_c2, ck.bwd_c2_ref, k2_in[:-1]),
            "fwd_c2": (ck.fwd_c2, ck.fwd_c2_ref,
                       (cnd["Abar"], cnd["Bbar"], cnd["cbar"], K, kff, dx0)),
            "bwd_vec_c2": (ck.bwd_vec_c2, ck.bwd_vec_c2_ref,
                           k3_in[:2] + k3_in[3:9]),
            "iter_sweep_c2": (functools.partial(ck.iter_sweep_c2,
                                                scratch=scratch),
                              ck.iter_sweep_c2_ref, k10_in),
            "condense2": (ck.condense2, ck.condense2_ref,
                          (A, Bm, c7, qxx6, qx7, ru7)),
            "expand2 stride 2": (functools.partial(ck.expand2, stride=2),
                                 functools.partial(ck.expand2_ref, stride=2),
                                 stride2)}


def fresh(args):
    """A copy of every tensor argument: iter_sweep_c2 updates its carried
    inputs in place, so a comparison feeds the kernel copies."""
    import torch
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def flat(out):
    """Outputs of a kernel as a flat list of tensors."""
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    return [t for o in out for t in flat(o)]


def bytes_of(name, args, out):
    """Bytes one call must move: each input read once, each output written
    once (iter_sweep_c2's carried arrays are both; its device-memory
    scratch round trip is the kernel's cost above the bound, not part of
    it).  expand2 reads only the even stages c[2k] of c (N, 13, B), and in
    its stride-2 form only the even stages of A and B too."""
    import torch
    ins = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("expand2", "expand2 stride 2"):
        ins[2] = ins[2][0::2]
    if name == "expand2 stride 2":
        ins[0], ins[1] = ins[0][0::2], ins[1][0::2]
    return sum(t.numel() * t.element_size() for t in ins + flat(out))


def flops_of(name, B, n=N):
    """Operations each kernel needs for one call at horizon n and batch B
    (n/2 pairs or condensed stages, n stages), counted from the algorithm
    (2 per multiply-add, 1 per other operation), not from what the kernel
    issues.

    K1, per pair: two ERK4 VDE stages (sparse J with ~60 nonzeros times the
    13+4 tangent columns at 3 RK stages, 4 dynamics and 4 Jacobian
    evaluations, the RK4 combinations) and the condensing products (Abar
    13^3, A1 B0 13^2 4, Qbar 13^3, S1T 13^2 4, R00 13 4^2, vectors).
    K2, per stage: PA, A'PA 2 x 13^3; PB, B'PA, Qux'K 3 x 13^2 8; B'PB
    8^2 13; the 8x8 Cholesky and 14 solves; vectors and the rollout (Kx,
    Ax, Bu: 377 multiply-adds).  bwd_c2 is K2 without the rollout, fwd_c2
    the rollout alone.  K3, per stage: B'm, A'm, K'Qu, one solve and the
    rollout; bwd_vec_c2 is K3 without the rollout.  K4, per pair: 13^2 +
    13 4 multiply-adds.  iter_sweep_c2 is K2 + K3 plus the barrier algebra
    of its five phases, per (stage, input): 16 operations (shift, affine
    right-hand side, S0), 35 (directions, S1/S2, four ratios), 24
    (corrected residuals and right-hand side), 34 (directions, ratios)
    and 38 (directions, update), and per stage 52 (z_dx, qx, c_res
    updates).
    K7, per stage: one ERK4 VDE stage and the gradients and bounds (42).
    K6, per pair: K1's condensing products.  kkt_sweep, per stage: PA,
    A'PA 2 x 13^3; PB, B'PA, Qux'K 3 x 13^2 4; B'PB 4^2 13; the 4x4
    Cholesky (20) and 14 solves (16 each); Pc, A'm + K'Qu, B'm; the
    rollout (Kx, Ax, Bu: 273 multiply-adds).  corrector_sweep, per stage:
    B'm, one solve, A'm + K'Qu and the rollout.
    """
    vde = 3 * 60 * 17 + 4 * 100 + 4 * 150 + 6 * (169 + 52)
    vde2 = 60 * 13 + 60 * 4 + 4 * 100 + 150 + 2 * (169 + 52)
    cond = 2 * (2197 + 676 + 2197 + 169 + 676 + 208 + 169 + 52 + 169)
    k1 = 2 * (2 * vde) + cond
    fwd = 2 * 377
    k2 = 2 * (2 * 2197 + 3 * 1352 + 832 + 84 + 14 * 64 + 169 + 273 + 104
              + 377) + 36
    k3 = 2 * (104 + 64 + 273 + 377)
    k4 = 2 * (169 + 52) + 13
    barrier = 8 * (16 + 35 + 24 + 34 + 38) + 52
    per_pair = {"prep_condense2": k1, "kkt_sweep_c2": k2,
                "corrector_sweep_c2": k3, "expand2": k4,
                "expand2 stride 2": k4, "bwd_c2": k2 - fwd, "fwd_c2": fwd,
                "bwd_vec_c2": k3 - fwd, "iter_sweep_c2": k2 + k3 + barrier,
                "condense2": cond,
                "prep_condense2 vde_order=2": 2 * (2 * vde2) + cond}
    for label, base in FORMS.items():
        per_pair.setdefault(label, per_pair.get(base))
    rollout = 2 * 273
    kkt = 2 * (2 * 2197 + 3 * 676 + 208 + 20 + 14 * 16 + 169 + 221 + 52
               + 273) + 10
    corr = 2 * (52 + 16 + 221 + 273)
    per_stage = {
        "prep_sweep": 2 * vde + 42, "prep_sweep vde_order=2": 2 * vde2 + 42,
        "kkt_sweep": kkt, "corrector_sweep": corr,
        "backward_sweep": kkt - rollout, "forward_sweep": rollout,
        "backward_vector_sweep": corr - rollout}
    if name in per_stage:
        return float(per_stage[name]) * n * B
    return float(per_pair[name]) * (n // 2) * B


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from crazyflie_nmpc_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    names = "|".join(sorted({**KERNEL_INFO, **PROBE_INFO}, key=len,
                            reverse=True))
    print("[build] ptxas per kernel instance, its mangled template "
          "arguments in <>: f float, d double, 13__nv_bfloat16 (S0_ the "
          "same) bfloat16, Lb0/Lb1 a bool false/true, Li2/Li4 an int")
    for src, rec in info.items():
        print(f"[build] {src}: {rec['seconds']:.1f} s"
              f"{' (cached)' if rec['cached'] else ''} -> {rec['lib']}")
        fn = None
        for line in rec["ptxas"].splitlines():
            found = re.search(r"\d(%s)_kernelI(.*?)E+v" % names, line)
            if "Compiling entry function" in line and found:
                fn = f"{found.group(1)}<{found.group(2)}>"
            elif "spill stores" in line or "Used " in line:
                print(f"[ptxas] {fn}: {line.split(':', 1)[-1].strip()}")
    return info


def compare(a, b):
    """(max abs err, max over outputs of abs err / max(1, max |b_i|)) over
    matching lists of outputs.  A bfloat16 output (the compressed gains)
    is allowed one bf16 rounding step (2^-7 of the larger magnitude) per
    entry beyond that: the kernel and the plain version round values that
    differ in the last bits of the working dtype, which can straddle a
    rounding boundary.  The kernel's rounding itself is held exactly
    (BF16_TWINS, check_bf16_rounding)."""
    import torch

    err = rel = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            fail(f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if (x.dtype == torch.bfloat16) != (y.dtype == torch.bfloat16):
            fail(f"dtype {x.dtype} vs {y.dtype}")
        if not bool(x.isfinite().all()):
            fail("non-finite kernel output")
        d = (x.double() - y.double()).abs()
        if x.dtype == torch.bfloat16:
            step = 2.0**-7 * torch.maximum(x.double().abs(), y.double().abs())
            d = torch.clamp(d - step, min=0.0)
        e = float(d.max())
        err = max(err, e)
        rel = max(rel, e / max(1.0, float(y.abs().max())))
    return err, rel


def check_bf16_rounding(outs, dn):
    """The bf16 K, L, Pc (outputs 0, 2, 3) of each BF16_TWINS form equal
    its twin's full-precision ones rounded by PyTorch through float32,
    bit for bit: this pins the kernel's rounding mode (to nearest even,
    double through float), which compare()'s allowance would not."""
    import torch

    for label, twin in BF16_TWINS.items():
        got, full = outs[label], outs[twin]
        same = [bool(torch.equal(got[i], full[i].float().to(torch.bfloat16)))
                for i in (0, 2, 3)]
        print(f"[kernel] {label} {dn}: K, L, Pc bitwise equal to "
              f"{twin}'s rounded through float32: {same}")
        if not all(same):
            fail(f"{label} {dn}: the kernel's bf16 rounding differs")


def split_vs_fused(inputs):
    """K5a's gains against K2's, and K5b's rollout on K2's gains against
    K2's own, on K2's inputs of `inputs` (kernel_inputs): ((max abs, rel)
    of K, kff, L, Pc; (max abs, rel) of dx, du), as compare().  0 where
    the split kernels evaluate K2's sums in K2's order."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    args = inputs["kkt_sweep_c2"][2]
    fused = flat(ck.kkt_sweep_c2(*args))
    gains = flat(ck.bwd_c2(*args[:-1]))
    roll = flat(ck.fwd_c2(*args[:3], fused[0], fused[1], args[-1]))
    return compare(gains, fused[:4]), compare(roll, fused[4:])


def corr_split_vs_fused(inputs):
    """K5c's kff, then K5b's rollout on it, against K3's dx and du on K3's
    inputs of `inputs` (kernel_inputs): whether they are equal, bit for
    bit: K5c is K3's kernel body without its rollout, and K5b evaluates
    K3's rollout sums in K3's order."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    args = inputs["corrector_sweep_c2"][2]
    fused = flat(ck.corrector_sweep_c2(*args))
    kff = ck.bwd_vec_c2(*args[:2], *args[3:9])
    roll = flat(ck.fwd_c2(*args[:3], args[5], kff, args[-1]))
    return all(torch.equal(a, b) for a, b in zip(roll, fused))


def uncondensed_split_vs_fused(inputs):
    """K9a's gains against K8a's, K9b's rollout on K8a's gains against
    K8a's own, and K9c's kff then K9b's rollout on it against K8b's dx and
    du, on K8a's and K8b's inputs of `inputs` (kernel_inputs): (whether K,
    kff, L and Pc are equal, whether K8a's dx and du are, whether K8b's
    are), bit for bit: K9a is K8a's kernel body without its rollout, K9c
    K8b's, and K8a's and K8b's rollouts evaluate K9b's sums in K9b's
    order."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    args = inputs["kkt_sweep"][2]
    fused = flat(rk.kkt_sweep(*args))
    gains = flat(rk.backward_sweep(*args[:-1]))
    roll = flat(rk.forward_sweep(*args[:3], fused[0], fused[1], args[-1]))
    A, Bm, c, qx, ru, K, L, Pc, p_term, dx0 = inputs["corrector_sweep"][2]
    corr = flat(rk.corrector_sweep(A, Bm, c, qx, ru, K, L, Pc, p_term, dx0))
    kff = rk.backward_vector_sweep(A, Bm, qx, ru, K, L, Pc, p_term)
    split = flat(rk.forward_sweep(A, Bm, c, K, kff, dx0))
    return (all(torch.equal(a, b) for a, b in zip(gains, fused[:4])),
            all(torch.equal(a, b) for a, b in zip(roll, fused[4:])),
            all(torch.equal(a, b) for a, b in zip(split, corr)))


def phase_kernels(device):
    """Each kernel (and FORMS) against its plain version at N=50, float64
    then float32; K1's two forms and the group kernels of RAGGED_KERNELS
    again on a ragged last tile (B_RAGGED), RAGGED_KERNELS at B=1 too, K6
    at one stage pair (N_PAIR) on the ragged tile;
    the uncondensed kernels (UNCONDENSED_KERNELS) at the odd N=51 in both
    too, and at both N K9a's and K9b's outputs against K8a's and K9c then
    K9b against K8b, bit for bit (uncondensed_split_vs_fused); then the
    sweeps of the long-horizon path (LONG_CHECKED) at its N=400 in
    float64, where a fault in any of their 200 stages shows far above
    rounding (phase_timing holds them in float32 there), and K5a and K5b
    against K2 on the same inputs there (split_vs_fused); K5c then K5b
    against K3, bit for bit, at N=50 (both dtypes) and N=400
    (corr_split_vs_fused).
    Returns {(kernel name, dtype name): max abs err} at N=50 (a kernel's
    forms pooled)."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    kc.reset_launch_counts()
    errs = {}
    checked = tuple(KERNEL_INFO) + tuple(FORMS)
    for n, dtype, labels, B in (
            (N, torch.float64, checked, B_CHECK),
            (N, torch.float32, checked, B_CHECK),
            (N, torch.float64, K1_FORMS + RAGGED_KERNELS, B_RAGGED),
            (N, torch.float32, K1_FORMS + RAGGED_KERNELS, B_RAGGED),
            (N, torch.float64, RAGGED_KERNELS, 1),
            (N, torch.float32, RAGGED_KERNELS, 1),
            (N_PAIR, torch.float64, ("condense2",), B_RAGGED),
            (N_PAIR, torch.float32, ("condense2",), B_RAGGED),
            (N_ODD, torch.float64, UNCONDENSED_KERNELS, B_CHECK),
            (N_ODD, torch.float32, UNCONDENSED_KERNELS, B_CHECK),
            (N_LONG, torch.float64, LONG_CHECKED, B_CHECK)):
        dn = str(dtype).split(".")[1]
        inputs = kernel_inputs(B, dtype, device, n=n)
        outs = {}
        for label in labels:
            name = FORMS.get(label, label)
            kern, ref, args = inputs[label]
            before = kc.launch_counts()[name]
            got = outs[label] = flat(kern(*fresh(args)))
            torch.cuda.synchronize()
            want = flat(ref(*args))
            if kc.launch_counts()[name] != before + 1:
                fail(f"{label} did not launch its kernel once")
            abs_err, rel_err = compare(got, want)
            ok = rel_err <= TOL[dn]
            print(f"[kernel] {label} {dn} N={n} B={B}: max abs err "
                  f"{abs_err:.3e}, rel {rel_err:.3e} (tol {TOL[dn]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{label} {dn} N={n} disagrees with its plain version")
            if n == N:
                errs[(name, dn)] = max(errs.get((name, dn), 0.0), abs_err)
        if labels is checked:
            check_bf16_rounding(outs, dn)
        if "kkt_sweep" in labels and B == B_CHECK:
            same_gains, same_roll, same_corr = uncondensed_split_vs_fused(
                inputs)
            print(f"[kernel] backward_sweep vs kkt_sweep's K, kff, L, Pc "
                  f"{dn} N={n} B={B}: bitwise {same_gains}; forward_sweep "
                  f"on kkt_sweep's gains vs its dx, du: bitwise "
                  f"{same_roll}; backward_vector_sweep then forward_sweep "
                  f"vs corrector_sweep's dx, du: bitwise {same_corr}")
            if not (same_gains and same_roll and same_corr):
                fail(f"the split uncondensed sweeps differ from kkt_sweep "
                     f"at N={n} {dn}")
        if "corrector_sweep_c2" in labels and B == B_CHECK:
            same = corr_split_vs_fused(inputs)
            print(f"[kernel] bwd_vec_c2 then fwd_c2 vs corrector_sweep_c2's "
                  f"dx, du {dn} N={n} B={B}: bitwise {same}")
            if not same:
                fail(f"bwd_vec_c2 + fwd_c2 differ from corrector_sweep_c2 "
                     f"at N={n} {dn}")
        if n == N_LONG:
            (g_abs, g_rel), (r_abs, r_rel) = split_vs_fused(inputs)
            ok = max(g_rel, r_rel) <= TOL[dn]
            print(f"[kernel] bwd_c2 vs kkt_sweep_c2's K, kff, L, Pc {dn} "
                  f"N={n} B={B}: max abs diff {g_abs:.3e}; fwd_c2 on "
                  f"kkt_sweep_c2's gains vs its dx, du: {r_abs:.3e} (0 "
                  f"expected: the same sums in the same order; rel "
                  f"{max(g_rel, r_rel):.3e}, tol {TOL[dn]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the windowed kernels disagree with K2 at N={n}")
    print("[kernel] held against plain PyTorch in float64 and float32: "
          + ", ".join(checked) + f"; at B={B_RAGGED}: "
          + ", ".join(K1_FORMS + RAGGED_KERNELS) + "; at B=1: "
          + ", ".join(RAGGED_KERNELS) + f"; condense2 at N={N_PAIR}, "
          f"B={B_RAGGED}; at N={N_ODD}: "
          + ", ".join(UNCONDENSED_KERNELS)
          + f"; at N={N_LONG} in float64: " + ", ".join(LONG_CHECKED))
    return errs


def make_step(spec, x0s, yref, yref_e, cfg, fused=True, **opts):
    """One batch-last step of the path: `rti_step_batched` with the step
    options `opts`, or with fused=False the stage QP of
    prepare_qp(fused_condense=False) solved by
    solve_batched(fused=False) (the split uncondensed sweeps) with the
    step's update, `rti_update`."""
    from crazyflie_nmpc_tpu_torch.ops import ipm_fast
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
        prepare_qp, rti_step_batched, rti_update)

    if fused:
        return lambda st: rti_step_batched(spec, st, x0s, yref, yref_e, cfg,
                                           layout="batch_last", **opts)

    def split_step(st):
        x_bl, u_bl, qp = prepare_qp(spec, st, x0s, yref, yref_e, True,
                                    fused_condense=False)
        sol = ipm_fast.solve_batched(qp, cfg, fused=False)
        return rti_update(qp, sol, x_bl, u_bl, True)
    return split_step


def run_chain(B, device, n=N, cfg=None, fused=True, sim_steps=1, **opts):
    """20 chained batch-last steps at batch B and horizon n with the
    IPMConfig `cfg` (iters=8 by default) and the step options (`fused`,
    `opts`: make_step); returns the first step's output, the last state,
    ms per step and the launch counts.

    The steps run under torch.cuda.set_sync_debug_mode("error"), so any
    host-device synchronisation on the path fails the run.  ms is the
    whole window's time over its 20 steps; the median and max of the
    step-to-step gaps are extra statistics.  host_ms is the host's time
    to issue one step from an idle card (median of 5): where it is close
    to ms, the host's launch loop sets the step time."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import to_batch_last

    spec = default_ocp(N=n, tf=TF * n / N, sim_steps=sim_steps,
                       dtype=torch.float32, device=device)
    yref, yref_e = hover_yref(spec, device=device)
    x0s = hover_batch(spec, B, seed=B)
    st0 = to_batch_last(init_rti(spec, x0s, device=device))
    step = make_step(spec, x0s, yref, yref_e, cfg or IPMConfig(iters=ITERS),
                     fused, **opts)
    return dict(x0s=x0s, st0=st0, **chain_steps(step, st0))


def chain_steps(step, st0):
    """2 warm-up steps, then STEPS chained steps of `step` from st0 timed
    by CUDA events under the sync debug mode (run_chain), and the host's
    issue time of one step (median of 5)."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    for _ in range(2):                        # warm-up, not timed
        step(st0)
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    host = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        kc.reset_launch_counts()
        evs[0].record()
        st, first = step(st0)
        evs[1].record()
        for i in range(2, STEPS + 1):
            st, out = step(st)
            evs[i].record()
        counts = kc.launch_counts()
        for _ in range(5):
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            step(st)
            host.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gaps = sorted(a.elapsed_time(b) for a, b in zip(evs, evs[1:]))
    return dict(first=first, last=out, st=st,
                ms=evs[0].elapsed_time(evs[-1]) / STEPS,
                ms_median=gaps[STEPS // 2], ms_max=gaps[-1],
                host_ms=sorted(host)[2], counts=counts, step=step)


def cpu_reference_step(x0s, cfg, n=N, dtype=None, fused=True, sim_steps=1,
                       **opts):
    """The same lanes through the port's plain versions on the CPU, in
    `dtype` (float64 by default); returns the step's RTIOutput and its
    input state."""
    import torch

    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import to_batch_last

    dtype = dtype or torch.float64
    spec = default_ocp(N=n, tf=TF * n / N, sim_steps=sim_steps, dtype=dtype,
                       device="cpu")
    yref, yref_e = hover_yref(spec, device="cpu")
    x = x0s.to(device="cpu", dtype=dtype)
    st = to_batch_last(init_rti(spec, x, device="cpu"))
    return make_step(spec, x, yref, yref_e, cfg, fused, **opts)(st)[1], st


def check_chain(label, run, B, n, per_step):
    """The run's launch counts are exactly `per_step` per step (0 for every
    other kernel), and its outputs finite and of the right shapes; prints
    the run's times.  Returns the counts."""
    import torch

    check_tick_launches(f"[{label}] B={B}", run["counts"], STEPS, per_step)
    outputs = [(f"step 1 {k}", t) for k, t in run["first"]._asdict().items()]
    outputs += [(f"step {STEPS} {k}", t) for k, t in
                run["last"]._asdict().items()]
    outputs += [("x_traj", run["st"].x_traj), ("u_traj", run["st"].u_traj)]
    for key, t in outputs:
        if not bool(torch.isfinite(t).all()):
            fail(f"[{label}] B={B}: non-finite {key}")
    if tuple(run["last"].u0.shape) != (4, B) or tuple(
            run["last"].x_plan.shape) != (n + 1, 13, B):
        fail(f"[{label}] B={B}: output shapes "
             f"{tuple(run['last'].u0.shape)}, "
             f"{tuple(run['last'].x_plan.shape)}")
    print(f"[{label}] B={B} N={n}: {STEPS} steps, {run['ms']:.3f} ms/step "
          f"(window / {STEPS}), {B / run['ms'] * 1e3:.0f} solves/s; "
          f"step gaps median {run['ms_median']:.3f}, max "
          f"{run['ms_max']:.3f} ms; host issue {run['host_ms']:.3f} "
          f"ms/step; no host sync; launches per step "
          + ", ".join(f"{k}={v // STEPS}" for k, v in run["counts"].items()
                      if v))
    return run["counts"]


def check_tick_launches(label, counts, ticks, per_tick):
    """Each kernel of `counts` (launches over `ticks` steps or ticks) was
    launched exactly per_tick[name] times a tick, every other kernel
    never.  Returns the launches per tick of the kernels that ran."""
    for name, got in counts.items():
        want = per_tick.get(name, 0) * ticks
        if got != want:
            fail(f"{label}: {name} launched {got} times in {ticks} "
                 f"ticks, expected {want}")
    return {k: v // ticks for k, v in counts.items() if v}


def hold_close(label, got, want, tol):
    """max |got - want| over every entry (float64, on the CPU) within
    `tol`, or the run fails (a non-finite entry too).  Returns it."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)}, expected "
             f"{tuple(want.shape)}")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not err <= tol:
        fail(f"{label}: max |diff| {err:.3e} above {tol:g}")
    return err


def step1_error(run, ref, lanes):
    """max |du0| [kRPM] and max |dx_plan| of step 1 on `lanes` against a
    CPU float64 output."""
    first = run["first"]
    du0 = float((first.u0[:, lanes].double().cpu() - ref.u0).abs().max())
    dx = float((first.x_plan[..., lanes].double().cpu() - ref.x_plan)
               .abs().max())
    return du0, dx


def drive(label, device, per_step, batches=B_MAIN, n=N, cfg=None,
          fused=True, check_step1=True, **opts):
    """20 chained steps of one path at horizon n and each B of `batches`
    (check_chain), step 1 on N_REF_LANES lanes at the first B against the
    port's float64 CPU run of the same options (unless check_step1 is
    False: the caller holds it).  Returns (launch totals, {B: run})."""
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    cfg = cfg or IPMConfig(iters=ITERS)
    totals, runs = {}, {}
    for B in batches:
        run = run_chain(B, device, n=n, cfg=cfg, fused=fused, **opts)
        for name, v in check_chain(label, run, B, n, per_step).items():
            totals[name] = totals.get(name, 0) + v
        runs[B] = run
        if B == batches[0] and check_step1:
            lanes = slice(0, N_REF_LANES)
            ref, _ = cpu_reference_step(run["x0s"][lanes], cfg, n=n,
                                        fused=fused, **opts)
            du0, dx = step1_error(run, ref, lanes)
            # float32 on the card vs float64 on the CPU after 8 IPM
            # iterations: u0 [kRPM] to 1e-3 (the JAX package's own f32
            # cross-path bar, tests/test_pallas_kernels.py:621), the state
            # plan to 1e-3 (metres, unit quaternion, m/s, rad/s)
            print(f"[{label}] step 1, {N_REF_LANES} lanes vs CPU float64: "
                  f"max |du0| {du0:.3e} kRPM, max |dx_plan| {dx:.3e}")
            if not (du0 <= 1e-3 and dx <= 1e-3):
                fail(f"[{label}] step 1 disagrees with the CPU float64 run")
    return totals, runs


def phase_main(device):
    return drive("main", device, {"prep_condense2": 1,
                                  "kkt_sweep_c2": ITERS,
                                  "corrector_sweep_c2": ITERS,
                                  "expand2": 1})


def phase_fused_iter(device, main_runs):
    """fused_iter=True: one iter_sweep_c2 launch per iteration and no
    K2/K3 launch; its times beside [main]'s of this run."""
    totals, runs = drive("fused_iter", device, {"prep_condense2": 1,
                                                "iter_sweep_c2": ITERS,
                                                "expand2": 1},
                         fused_iter=True)
    for B, run in runs.items():
        main = main_runs.get(B)
        if main is not None:
            print(f"[fused_iter] B={B}: {run['ms']:.3f} ms/step against "
                  f"[main] {main['ms']:.3f} (host issue "
                  f"{run['host_ms']:.3f} against {main['host_ms']:.3f} ms)")
    return totals, runs


def phase_uncondensed(device, main_runs):
    """condense=1 at N=50 (each B of B_MAIN) and the odd horizon N=51 with
    the default condense (B=4096): prep_sweep once and kkt_sweep /
    corrector_sweep once per iteration, no condensed kernel; the N=50
    times beside [main]'s of this run (the two forms of the same QP)."""
    per_step = {"prep_sweep": 1, "kkt_sweep": ITERS,
                "corrector_sweep": ITERS}
    totals, runs = drive("uncondensed", device, per_step, condense=1)
    odd, _ = drive("uncondensed", device, per_step, batches=(B_TIME,),
                   n=N_ODD)
    for name, v in odd.items():
        totals[name] = totals.get(name, 0) + v
    for B, run in runs.items():
        main = main_runs.get(B)
        if main is not None:
            print(f"[uncondensed] B={B}: condense=1 {run['ms']:.3f} ms/step "
                  f"against [main] (condense=2) {main['ms']:.3f} (host issue "
                  f"{run['host_ms']:.3f} against {main['host_ms']:.3f} ms)")
    return totals, runs


def phase_unfused_prep(device):
    """fused_prep_condense=False at N=50, B=4096: prep_sweep, condense2,
    the condensed sweeps and the stride-2 expand2."""
    return drive("unfused_prep", device, {
        "prep_sweep": 1, "condense2": 1, "kkt_sweep_c2": ITERS,
        "corrector_sweep_c2": ITERS, "expand2": 1}, batches=(B_TIME,),
        fused_prep_condense=False)


def compare_paths(label, run, other, other_label):
    """One path's step time beside another's of this call, same B."""
    if other is None:
        return
    B, n = run["x0s"].shape[0], run["st"].u_traj.shape[0]
    print(f"[{label}] B={B} N={n}: {run['ms']:.3f} ms/step against "
          f"{other_label} {other['ms']:.3f} (host issue {run['host_ms']:.3f}"
          f" against {other['host_ms']:.3f} ms)")


def phase_split(device, unc_runs):
    """solve_batched(fused=False) on the stage QP at N=50 and N=51,
    B=4096: prep_sweep once, backward_sweep and backward_vector_sweep once
    and forward_sweep twice per iteration, no other kernel.  Step 1's QP
    is solved again with the fused sweeps (kkt_sweep, corrector_sweep) on
    the card: the same formulas in the same order, one launch boundary
    apart, so the two agree to rounding."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import ipm_fast
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import default_ocp, hover_yref
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import prepare_qp

    per_step = {"prep_sweep": 1, "backward_sweep": ITERS,
                "forward_sweep": 2 * ITERS, "backward_vector_sweep": ITERS}
    totals, runs = {}, {}
    for n in (N, N_ODD):
        t, r = drive("split", device, per_step, batches=(B_TIME,), n=n,
                     fused=False)
        for name, v in t.items():
            totals[name] = totals.get(name, 0) + v
        run = r[B_TIME]
        runs[n] = run
        spec = default_ocp(N=n, tf=TF * n / N, dtype=torch.float32,
                           device=device)
        yref, yref_e = hover_yref(spec, device=device)
        _, _, qp = prepare_qp(spec, run["st0"], run["x0s"], yref, yref_e,
                              True, fused_condense=False)
        cfg = IPMConfig(iters=ITERS)
        split = ipm_fast.solve_batched(qp, cfg, fused=False)
        fused = ipm_fast.solve_batched(qp, cfg)
        d_du = float((split.du - fused.du).abs().max())
        d_dx = float((split.dx - fused.dx).abs().max())
        scale = max(1.0, float(fused.dx.abs().max()))
        print(f"[split] N={n}: split vs fused sweeps on step 1's QP, max "
              f"|du| {d_du:.3e} kRPM, max |dx| {d_dx:.3e} (bitwise: "
              f"{bool(torch.equal(split.du, fused.du))})")
        if not (d_du <= 1e-4 and d_dx <= 1e-4 * scale):
            fail(f"[split] N={n}: split and fused sweeps disagree")
    compare_paths("split", runs[N], unc_runs.get(B_TIME),
                  "[uncondensed] (fused sweeps)")
    return totals, runs


def phase_gondzio(device):
    """IPMConfig(iters=6, gondzio_correctors=1), bench.py's 6+1 point, at
    N=50 (the condensed sweeps: kkt_sweep_c2 once and corrector_sweep_c2
    twice per iteration) and N=51 (kkt_sweep, corrector_sweep), B=4096."""
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    cfg, it = IPMConfig(**GONDZIO), GONDZIO["iters"]
    corr = it * (1 + GONDZIO["gondzio_correctors"])
    totals, runs = drive("gondzio", device, {
        "prep_condense2": 1, "kkt_sweep_c2": it, "corrector_sweep_c2": corr,
        "expand2": 1}, batches=(B_TIME,), cfg=cfg)
    odd, odd_runs = drive("gondzio", device, {
        "prep_sweep": 1, "kkt_sweep": it, "corrector_sweep": corr},
        batches=(B_TIME,), n=N_ODD, cfg=cfg)
    for name, v in odd.items():
        totals[name] = totals.get(name, 0) + v
    return totals, {N: runs[B_TIME], N_ODD: odd_runs[B_TIME]}


def phase_throughput_mode(device):
    """bench.py's throughput mode: IPMConfig(iters=8, compress_gains=True,
    compress_ab=True) with prep_vde_order=2, N=50, B = 2048 and 4096: the
    order-2 prep_condense2, the bf16-stream kkt_sweep_c2 /
    corrector_sweep_c2 (counted on their kernels) and expand2.

    Step 1 on N_REF_LANES lanes is held against the port's float64 CPU run
    of the same configuration.  The bf16 gains make this step sensitive to
    the last bits of the working dtype (a rounding step of one gain moves
    it), so float32 and float64 differ far more than on the exact path: the
    yardsticks are two float32 runs of the same step, the port's plain
    versions on the CPU and the JAX package's (JAX_THROUGHPUT), and the
    card may be at most 1.5x as far from float64 as the farther of them.
    It is also held against the uncompressed float64 answer
    (IPMConfig(iters=8), order-4 VDE): JAX's envelope for the compressed
    streams on random bounded QPs is 5e-2 of max |du|
    (tests/test_pallas_kernels.py), but on this OCP the JAX package's own
    compressed step lands 0.153 (float64) and 0.147 (float32) of max |du|
    off it, so the card may be at most 1.1x the larger of those; the
    port's float64 distance must be JAX's to 1e-6 (the port's and JAX's
    float64 runs on the CPU agree to 1e-14)."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    cfg = IPMConfig(**THROUGHPUT)
    opts = dict(prep_vde_order=2)
    totals, runs = drive("throughput_mode", device, {
        "prep_condense2": 1, "kkt_sweep_c2": ITERS,
        "corrector_sweep_c2": ITERS, "expand2": 1}, batches=B_THROUGHPUT,
        cfg=cfg, check_step1=False, **opts)
    run = runs[B_THROUGHPUT[0]]
    lanes = slice(0, N_REF_LANES)
    x0s = run["x0s"][lanes]
    ref, st = cpu_reference_step(x0s, cfg, **opts)
    ref32, _ = cpu_reference_step(x0s, cfg, dtype=torch.float32, **opts)
    exact, _ = cpu_reference_step(x0s, IPMConfig(iters=ITERS))
    du0, dx = step1_error(run, ref, lanes)
    e32 = float((ref32.u0.double() - ref.u0).abs().max())
    x32 = float((ref32.x_plan.double() - ref.x_plan).abs().max())
    jx = JAX_THROUGHPUT

    def du(u_plan):       # the QP step of each lane: u_plan - u_traj
        return u_plan.double().cpu() - st.u_traj
    scale = float(du(exact.u_plan).abs().max())

    def dev(u_plan):
        return float((du(u_plan) - du(exact.u_plan)).abs().max()) / scale
    dev_card = dev(run["first"].u_plan[..., lanes])
    dev64, dev32 = dev(ref.u_plan), dev(ref32.u_plan)
    lim_u0 = 1.5 * max(e32, jx["f32_vs_f64_u0"])
    lim_x = 1.5 * max(x32, jx["f32_vs_f64_x_plan"])
    lim_dev = 1.1 * max(jx["dev_f64"], jx["dev_f32"])
    print(f"[throughput_mode] step 1, {N_REF_LANES} lanes vs CPU float64 "
          f"(same configuration): max |du0| {du0:.3e} kRPM, max |dx_plan| "
          f"{dx:.3e}; float32 yardsticks: the port's plain versions "
          f"{e32:.3e} kRPM, {x32:.3e}, the JAX package's "
          f"{jx['f32_vs_f64_u0']:.3e}, {jx['f32_vs_f64_x_plan']:.3e} "
          f"(limits {lim_u0:.3e}, {lim_x:.3e})")
    print(f"[throughput_mode] step 1 vs the uncompressed float64 answer "
          f"(order-4 VDE), max |du - du_exact| / max |du_exact| "
          f"({scale:.3f} kRPM): card {dev_card:.3e} (limit {lim_dev:.3e}), "
          f"plain float64 {dev64:.3e}, plain float32 {dev32:.3e}; the JAX "
          f"package's float64 {jx['dev_f64']:.3e}, float32 "
          f"{jx['dev_f32']:.3e} (tools/throughput_envelope.py)")
    if not (du0 <= lim_u0 and dx <= lim_x):
        fail("[throughput_mode] step 1 disagrees with the CPU float64 run")
    if abs(dev64 - jx["dev_f64"]) > 1e-6:
        fail("[throughput_mode] the port's float64 step is not the JAX "
             "package's distance from the uncompressed answer")
    if not dev_card <= lim_dev:
        fail("[throughput_mode] step 1 is further from the uncompressed "
             "answer than the JAX package's compressed step")
    return totals, runs


def phase_xla_prep(device, main_runs):
    """The XLA-style preparation (`prepare_qp_xla`: torch.func.jacfwd
    through the integrator, plain PyTorch) and the same solver:
    fused_prep=False at N=50, B=4096 (condense2, the condensed sweeps and
    the stride-2 expand2 on the card), step 1 held against [main]'s on the
    same states (the same QP from the fused preparation's VDE) and against
    float64; then a sim_steps=2 spec at B=1024, held on N_REF_LANES lanes
    against its own float64 CPU run."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    per_step = {"condense2": 1, "kkt_sweep_c2": ITERS,
                "corrector_sweep_c2": ITERS, "expand2": 1}
    totals, runs = drive("xla_prep", device, per_step, batches=(B_TIME,),
                         fused_prep=False)
    run, main = runs[B_TIME], main_runs.get(B_TIME)
    if main is not None:
        du0 = float((run["first"].u0 - main["first"].u0).abs().max())
        dx = float((run["first"].x_plan - main["first"].x_plan).abs().max())
        print(f"[xla_prep] step 1 vs [main]'s on the same {B_TIME} states: "
              f"max |du0| {du0:.3e} kRPM, max |dx_plan| {dx:.3e}")
        if not (du0 <= 1e-3 and dx <= 1e-3):
            fail("[xla_prep] step 1 disagrees with [main]'s")
        compare_paths("xla_prep", run, main, "[main]")
    label = "xla_prep sim_steps=2"
    sim2, sim2_runs = drive(label, device, per_step, batches=(B_CHECK,),
                            check_step1=False, sim_steps=2)
    for name, v in sim2.items():
        totals[name] = totals.get(name, 0) + v
    # the shooting interval is sim_steps x dt, as in the JAX package, so
    # the plan spans 1.5 s and float32 rounding grows along it: u0 to 1e-3
    # kRPM as on every path, the plan to 1e-3 or 3x the plain float32
    # run's distance from float64 on the same lanes (the yardstick [long]
    # and phase_timing use), whichever is larger
    run, lanes = sim2_runs[B_CHECK], slice(0, N_REF_LANES)
    x0s = run["x0s"][lanes]
    ref, _ = cpu_reference_step(x0s, IPMConfig(iters=ITERS), sim_steps=2)
    ref32, _ = cpu_reference_step(x0s, IPMConfig(iters=ITERS),
                                  dtype=torch.float32, sim_steps=2)
    du0, dx = step1_error(run, ref, lanes)
    x32 = float((ref32.x_plan.double() - ref.x_plan).abs().max())
    e32 = float((ref32.u0.double() - ref.u0).abs().max())
    lim_x = max(1e-3, 3 * x32)
    print(f"[{label}] step 1, {N_REF_LANES} lanes vs CPU float64: max "
          f"|du0| {du0:.3e} kRPM, max |dx_plan| {dx:.3e} (limit "
          f"{lim_x:.3e}); plain float32 on the CPU {e32:.3e} kRPM, "
          f"|dx_plan| {x32:.3e}")
    if not (du0 <= 1e-3 and dx <= lim_x):
        fail(f"[{label}] step 1 disagrees with the CPU float64 run")
    planted_prep_faults(label, x0s, ref, lim_x)
    return totals, {**runs, "sim_steps=2": run}


def planted_prep_faults(label, x0s, ref, lim_x):
    """The power of the sim_steps=2 bar: the same step in float32 on the
    CPU with a fault planted in its preparation (the linearization that
    `prepare_qp_xla` calls, patched for the call), held against the same
    float64 answer and bars.  F1 (the interval ignores sim_steps) and F2
    (A, B of one sub-step, the chain rule dropped) must fail them; F3 (one
    RK4 step over the whole interval: a change of discretization only) is
    printed, not required: it moves the plan less than float32 rounding
    does, and only the float64 CPU tests against the JAX package see it."""
    from unittest import mock

    import torch

    from crazyflie_nmpc_tpu_torch.ops.integrators import linearize_trajectory
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import rti_batched

    lin = linearize_trajectory
    faults = {
        "F1 interval ignores sim_steps": (
            lambda f, p, x, u, dt, n: lin(f, p, x, u, dt, 1), True),
        "F2 A, B of one sub-step": (
            lambda f, p, x, u, dt, n: (lin(f, p, x, u, dt, n)[0],
                                       *lin(f, p, x, u, dt, 1)[1:]), True),
        "F3 one RK4 step over the interval": (
            lambda f, p, x, u, dt, n: lin(f, p, x, u, dt * n, 1), False),
    }
    for name, (fault, must_fail) in faults.items():
        with mock.patch.object(rti_batched, "linearize_trajectory", fault):
            out, _ = cpu_reference_step(x0s, IPMConfig(iters=ITERS),
                                        dtype=torch.float32, sim_steps=2)
        du0 = float((out.u0.double() - ref.u0).abs().max())
        dx = float((out.x_plan.double() - ref.x_plan).abs().max())
        caught = not (du0 <= 1e-3 and dx <= lim_x)
        print(f"[{label}] planted fault {name} (CPU float32): max |du0| "
              f"{du0:.3e} kRPM, max |dx_plan| {dx:.3e} -> "
              f"{'fails' if caught else 'passes'} the bars"
              f"{' (required to fail)' if must_fail else ''}")
        if must_fail and not caught:
            fail(f"[{label}] the bars do not see the planted fault {name}")


SINGLE_TICKS = 20


def phase_single(device):
    """The single-instance RTI step (`solver.rti.rti_step`: jacfwd
    linearization, Gauss-Newton QP, `ops.ipm.solve`, plain PyTorch on the
    card), N=50, float32, from the certified transient's 1.5 m offset:
    SINGLE_TICKS chained closed-loop ticks (the plant an RK4 step of the
    model under u0) with escalation off under
    torch.cuda.set_sync_debug_mode("error"), ms per tick from CUDA events
    and the host's issue time; tick 1's u0 held against the port's float64
    CPU run to 1e-3 kRPM.  Then one certified tick (certified_config(),
    escalation: one host read) held the same way, at the first tick whose
    8 iterations left mu above the escalation tolerance.  Last, two ticks
    traced (phase_profile): kernel launches per tick, device busy time."""
    import torch

    from crazyflie_nmpc_tpu_torch.models import dynamics
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti, rti_step)

    def setup(dtype, dev):
        spec = default_ocp(N=N, dtype=dtype, device=dev)
        yref, yref_e = hover_yref(spec, device=dev)
        x0 = hover_batch(spec, 1, seed=7)[0]
        x0[0] += 1.5
        return spec, yref, yref_e, x0, init_rti(spec, x0, device=dev)

    spec, yref, yref_e, x0, st0 = setup(torch.float32, device)
    cfg = IPMConfig(iters=ITERS)

    def tick(carry):
        st, x = carry
        st, out = rti_step(spec, st, x, yref, yref_e, cfg)
        x = integrate(dynamics, spec.params, x, out.u0, spec.dt)
        return (st, x), out

    tick((st0, x0))                           # warm-up, not timed
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True)
           for _ in range(SINGLE_TICKS + 1)]
    host, inputs, mus = [], [], []
    kc.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = (st0, x0)
        evs[0].record()
        for i in range(SINGLE_TICKS):
            inputs.append(carry)
            t0 = time.perf_counter()
            carry, out = tick(carry)
            host.append((time.perf_counter() - t0) * 1e3)
            evs[i + 1].record()
            mus.append(out.qp_mu)
            if i == 0:
                first = out
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = evs[0].elapsed_time(evs[-1]) / SINGLE_TICKS
    counts = {k: v for k, v in kc.launch_counts().items() if v}
    for key, t in list(first._asdict().items()) + list(
            out._asdict().items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"[single] non-finite {key}")
    pos = float(carry[1][:3].sub(yref_e[:3]).norm())
    print(f"[single] N={N} float32: {SINGLE_TICKS} closed-loop ticks from "
          f"1.5 m off, {ms:.3f} ms/tick (window / {SINGLE_TICKS}), host "
          f"issue median {sorted(host)[SINGLE_TICKS // 2]:.3f} ms/tick; no "
          f"host sync; position error after {SINGLE_TICKS} ticks "
          f"{pos:.4f} m; hand-written kernels launched: {counts or 'none'}")

    # the certified tick: the first tick whose 8 iterations left mu above
    # the escalation tolerance (tick 1 if none did), from that tick's
    # inputs; its float64 CPU run starts from the same values
    cert = certified_config()
    hard = next((i for i, mu in enumerate(mus)
                 if float(mu) > cert.escalate_mu_tol), 0)
    spec64, yref64, yref_e64, _, _ = setup(torch.float64, "cpu")
    for label, c, i in (("escalation off", cfg, 0), ("certified", cert,
                                                      hard)):
        (st_i, x_i) = inputs[i]
        got = (first if i == 0 and c is cfg else
               rti_step(spec, st_i, x_i, yref, yref_e, c)[1])
        st64 = type(st_i)(x_traj=st_i.x_traj.double().cpu(),
                          u_traj=st_i.u_traj.double().cpu())
        _, ref = rti_step(spec64, st64, x_i.double().cpu(), yref64,
                          yref_e64, c)
        du0 = float((got.u0.double().cpu() - ref.u0).abs().max())
        note = f", 8-iteration mu {float(mus[i]):.3e}" if c is cert else ""
        print(f"[single] tick {i + 1} ({label}{note}) vs CPU float64: max "
              f"|du0| {du0:.3e} kRPM (u0 "
              f"{[round(float(v), 4) for v in ref.u0]}, mu "
              f"{float(got.qp_mu):.3e})")
        if not du0 <= 1e-3:
            fail(f"[single] tick {i + 1} ({label}) disagrees with float64")

    def step(st):
        return rti_step(spec, st, x0, yref, yref_e, cfg)
    # launches per tick and the device's idle share
    phase_profile("single", dict(st=st0, step=step, x0s=x0[None]), steps=2)


# ---------------------------------------------------------------------------
# closed loops: the Monte-Carlo swarm, the single-vehicle loops, the flight
# ---------------------------------------------------------------------------

SWARM_B = 4096
SWARM_TICKS = 150
SWARM_SEED = 0
SWARM_REF_LANES = 8
SWARM_SETPOINT = (0.0, 0.0, 0.5)
# every lane within 0.02 m of its set-point after 150 ticks, all states
# finite: the JAX package's bar (tests/test_runtime_extras.py:170-181)
SWARM_BAR = 0.02
# the kernels of one [main] step, launched once a [swarm] tick
STEP_KERNELS = {"prep_condense2": 1, "kkt_sweep_c2": ITERS,
                "corrector_sweep_c2": ITERS, "expand2": 1}
LOOP_TICKS = 5
LOOP_TOL = 1e-6       # card float64 against CPU float64: x, u, u_cmd
# 150 ticks, not the JAX test's 400: 400 took 582.6 s on the H100 (1.46 s
# a host-bound tick) and 200 took 320.4 s on a slow host (1.60 s a tick,
# PERF.md §4); the two error bars are held over these ticks (the mean
# over ticks 100-149)
FLIGHT_TICKS = 150
FLIGHT_REF_TICKS = 3
# the JAX package's bars on the 400-tick helix
# (tests/test_flight_configuration.py:49-64) and its recorded largest
# error (docs/PERF.md "Full-helix evidence")
FLIGHT_MAX_ERR = 0.03
FLIGHT_MEAN_ERR = 0.015       # over ticks 100 on
JAX_FLIGHT_MAX_CM = 2.303


def swarm_lanes_off(x, setpoint, bar=SWARM_BAR):
    """Lanes of a swarm run x (T, B, 13) whose last position is not within
    `bar` of the set-point in every coordinate or whose states are not all
    finite, and the largest final distance."""
    import torch

    sp = torch.as_tensor(setpoint, dtype=x.dtype, device=x.device)
    dist = (x[-1, :, :3] - sp).abs().amax(dim=1)
    finite = torch.isfinite(x).all(dim=2).all(dim=0)
    off = ~(dist < bar) | ~finite
    return off.nonzero().flatten().tolist(), float(dist.max())


def check_swarm_bar(label, x, setpoint, bar=SWARM_BAR):
    """The JAX package's swarm bar on x (T, B, 13): fails, naming the
    lanes, where a lane missed it."""
    lanes, worst = swarm_lanes_off(x, setpoint, bar)
    if lanes:
        x_last = x[-1, lanes[:16], :3].tolist()
        fail(f"{label}: {len(lanes)} lanes off by more than {bar} m or not "
             f"finite after {x.shape[0]} ticks: lanes {lanes[:16]}, final "
             f"positions {x_last}, starts {x[0, lanes[:16], :3].tolist()}")
    return worst


def check_flight_bars(label, e, u, x):
    """The JAX package's flight bars: tracking error e (per tick, metres)
    max below FLIGHT_MAX_ERR and mean from tick 100 on below
    FLIGHT_MEAN_ERR, rotor speeds in [0, 22] kRPM, states finite.
    Returns (max, mean from tick 100)."""
    import numpy as np

    e = np.asarray(e)
    e_max = float(e.max()) if e.size else float("nan")
    e_mean = float(e[100:].mean()) if e.size > 100 else float("nan")
    if not bool(x.isfinite().all()):
        fail(f"{label}: non-finite plant states")
    if not (float(u.min()) >= 0.0 and float(u.max()) <= 22.0):
        fail(f"{label}: rotor speeds outside [0, 22] kRPM "
             f"({float(u.min()):.4f} .. {float(u.max()):.4f})")
    if not e_max < FLIGHT_MAX_ERR:
        fail(f"{label}: largest tracking error {e_max:.5f} m, bar "
             f"{FLIGHT_MAX_ERR}")
    if not e_mean < FLIGHT_MEAN_ERR:
        fail(f"{label}: mean tracking error from tick 100 {e_mean:.5f} m, "
             f"bar {FLIGHT_MEAN_ERR}")
    return e_max, e_mean


def timed_call(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error") (a host sync
    fails the run) with the launch counters set to 0: (its result, ms of
    the CUDA-event window, ms the host spent issuing it, the port's
    kernel launches)."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        ev0.record()
        out = fn()
        ev1.record()
        host = (time.perf_counter() - t0) * 1e3
        counts = kc.launch_counts()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, ev0.elapsed_time(ev1), host, counts


def phase_swarm(device):
    """`runtime.batch.monte_carlo_hover` (the Monte-Carlo closed loop,
    BASELINE config 3): N=50, B=SWARM_B, float32, IPMConfig(iters=8),
    pos_scale=0.2 around SWARM_SETPOINT, SWARM_TICKS ticks under the sync
    debug mode, the offsets from a seeded generator on the card.  Prints
    ms/tick (CUDA events), solves/s, host issue per tick and the kernels
    a tick launches (K1 once, K2 and K3 eight times, K4 once); holds
    tick 1's u0 on SWARM_REF_LANES lanes against the port's float64 CPU
    run to 1e-3 kRPM and every lane to the JAX package's bar.  Returns
    the launch counts."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.batch import (monte_carlo_hover,
                                                        swarm_hover)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    cfg = IPMConfig(iters=ITERS)

    def run(ticks):
        gen = torch.Generator(device=device).manual_seed(SWARM_SEED)
        return monte_carlo_hover(spec, gen, SWARM_B, ticks, pos_scale=0.2,
                                 setpoint=SWARM_SETPOINT, config=cfg)

    run(2)                                    # warm-up, not timed
    res, ms, host, counts = timed_call(lambda: run(SWARM_TICKS))
    per_tick = check_tick_launches("[swarm]", counts, SWARM_TICKS,
                                   STEP_KERNELS)
    ms_tick, host_tick = ms / SWARM_TICKS, host / SWARM_TICKS
    print(f"[swarm] monte_carlo_hover N={N} B={SWARM_B} float32: "
          f"{SWARM_TICKS} ticks, {ms_tick:.3f} ms/tick (window / "
          f"{SWARM_TICKS}), {SWARM_B / ms_tick * 1e3:.0f} solves/s; host "
          f"issue {host_tick:.3f} ms/tick; no host sync; kernels per tick "
          + ", ".join(f"{k}={v}" for k, v in per_tick.items()))

    lanes = slice(0, SWARM_REF_LANES)
    spec64 = default_ocp(N=N, dtype=torch.float64, device="cpu")
    x_ref = res.x[0, lanes].double().cpu()
    ref = swarm_hover(spec64, x_ref, torch.tensor(SWARM_SETPOINT,
                                                  dtype=torch.float64)
                      .expand(SWARM_REF_LANES, 3), 1, config=cfg)
    du0 = hold_close("[swarm] tick 1 u0 vs CPU float64", res.u[0, lanes],
                     ref.u[0], 1e-3)
    worst = check_swarm_bar("[swarm]", res.x, SWARM_SETPOINT)
    print(f"[swarm] tick 1 u0 on {SWARM_REF_LANES} lanes vs CPU float64: "
          f"max |du0| {du0:.3e} kRPM; after {SWARM_TICKS} ticks every lane "
          f"within {worst:.5f} m of the set-point (bar {SWARM_BAR} m), all "
          f"states finite")
    trace_ticks("swarm", f"B={SWARM_B}", run, ms_tick)
    return counts


def closed_loop_cases():
    """[closed_loop]'s loops: (label, fn(spec, x0, ticks) -> LoopResult),
    each with IPMConfig(iters=8) (no host read in a tick)."""
    from crazyflie_nmpc_tpu_torch.models.firmware import AttitudeGains
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime import closed_loop as cl

    cfg = cl.LoopConfig(delay_steps=4, ipm=IPMConfig(iters=ITERS))
    lag = AttitudeGains(kd_rate=0.002, tau_m=0.015)
    return (
        ("hover_regulation pending", lambda s, x, t: cl.hover_regulation(
            s, x, steps=t, config=cfg)),
        ("hover_regulation last_command",
         lambda s, x, t: cl.hover_regulation(
             s, x, steps=t, config=dataclasses.replace(
                 cfg, predictor="last_command"))),
        ("estimator_in_the_loop", lambda s, x, t: cl.estimator_in_the_loop(
            s, x, steps=t, config=cfg)),
        ("cmd_vel_loop motvel", lambda s, x, t: cl.cmd_vel_loop(
            s, x, steps=t, delay_steps=2, meas_delay_steps=1,
            predictor="motvel", gains=lag, config=cfg)),
    )


def phase_closed_loop(device):
    """The single-vehicle closed loops of `runtime.closed_loop` on the
    card (plain PyTorch: the single-instance rti_step, the plant, the
    estimator, the cascade), N=50, float64, LOOP_TICKS ticks each from
    hover 0.5 m below the set-point with seeded noise: ms/tick and host
    issue, the hand-written kernels launched (none on this path), x, u
    and u_cmd held against the same call on the port's CPU path to
    LOOP_TOL; then one tick of each traced (`trace_ticks`: device
    launches per tick, idle share)."""
    import torch

    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    spec = default_ocp(N=N, dtype=torch.float64, device=device)
    spec_cpu = default_ocp(N=N, dtype=torch.float64, device="cpu")
    x0 = hover_batch(spec_cpu, 1, seed=11)[0]
    xd = x0.to(device)
    cases = closed_loop_cases()
    cases[-1][1](spec, xd, 1)                 # warm-up, not timed
    for label, loop in cases:
        res, ms, host, counts = timed_call(
            lambda: loop(spec, xd, LOOP_TICKS))
        check_tick_launches(f"[closed_loop] {label}", counts, LOOP_TICKS,
                            {})
        ref = loop(spec_cpu, x0, LOOP_TICKS)
        errs = [hold_close(f"[closed_loop] {label} {f} vs CPU float64",
                           getattr(res, f), getattr(ref, f), LOOP_TOL)
                for f in ("x", "u", "u_cmd")]
        print(f"[closed_loop] {label} N={N} float64: {LOOP_TICKS} ticks, "
              f"{ms / LOOP_TICKS:.3f} ms/tick, host issue "
              f"{host / LOOP_TICKS:.3f} ms/tick; no host sync; hand-written "
              f"kernels launched: none; vs CPU float64 max |dx| "
              f"{errs[0]:.3e}, |du| {errs[1]:.3e}, |du_cmd| {errs[2]:.3e}")
        trace_ticks("closed_loop", label, lambda t: loop(spec, xd, t),
                    ms / LOOP_TICKS, hi=2)


def phase_flight(device):
    """`runtime.closed_loop.flight_configuration` (the paper's flown
    configuration: helix tracking, estimator chain, 60 ms round trip, the
    cmd_vel predictor, the onboard cascade) on the card: N=50, float64,
    LoopConfig(ipm=IPMConfig(iters=8)), FLIGHT_TICKS ticks of
    helix_trajectory under the sync debug mode; the JAX package's bars
    (check_flight_bars) and its recorded 2.303 cm beside the measured
    largest error; the first FLIGHT_REF_TICKS ticks' u_cmd held against
    the port's CPU float64 run to LOOP_TOL; then one tick traced
    (`trace_ticks`)."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.closed_loop import (
        LoopConfig, flight_configuration, tracking_error)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp
    from crazyflie_nmpc_tpu_torch.utils import helix_trajectory

    cfg = LoopConfig(ipm=IPMConfig(iters=ITERS))

    def setup(dev):
        spec = default_ocp(N=N, dtype=torch.float64, device=dev)
        return spec, helix_trajectory(spec.params, device=dev)

    def fly(spec, table, ticks):
        return flight_configuration(spec, table, steps=ticks, delay_steps=4,
                                    predictor="cmd_vel", config=cfg)

    spec, table = setup(device)
    fly(spec, table, 1)                       # warm-up, not timed
    res, ms, host, counts = timed_call(
        lambda: fly(spec, table, FLIGHT_TICKS))
    check_tick_launches("[flight]", counts, FLIGHT_TICKS, {})
    e = tracking_error(res, table)
    e_max, e_mean = check_flight_bars("[flight]", e, res.u, res.x)
    ref = fly(*setup("cpu"), FLIGHT_REF_TICKS)
    du = hold_close("[flight] u_cmd of the first ticks vs CPU float64",
                    res.u_cmd[:FLIGHT_REF_TICKS], ref.u_cmd, LOOP_TOL)
    print(f"[flight] flight_configuration N={N} float64, helix, delay 4, "
          f"cmd_vel predictor: {FLIGHT_TICKS} ticks ({len(e)} tracking) in "
          f"{ms / 1e3:.1f} s, {ms / FLIGHT_TICKS:.3f} ms/tick, host issue "
          f"{host / FLIGHT_TICKS:.3f} ms/tick; no host sync; largest "
          f"tracking error {100 * e_max:.3f} cm (JAX package "
          f"{JAX_FLIGHT_MAX_CM} cm, bar {100 * FLIGHT_MAX_ERR:g}), mean from "
          f"tick 100 {100 * e_mean:.3f} cm (bar {100 * FLIGHT_MEAN_ERR:g}); "
          f"rotor speeds {float(res.u.min()):.3f}..{float(res.u.max()):.3f} "
          f"kRPM; u_cmd of ticks 1-{FLIGHT_REF_TICKS} vs CPU float64 "
          f"{du:.3e}")
    trace_ticks("flight", "B=1", lambda t: fly(spec, table, t),
                ms / FLIGHT_TICKS, hi=2)


# ---------------------------------------------------------------------------
# the serving stack: ServingLoop, SwarmNMPC over the native link
# ---------------------------------------------------------------------------

SERVE_RATE = 66.6
SERVE_TICKS = 200
SERVE_B = 256         # BASELINE.json config 4's fleet
SERVE_RUNS = ((SERVE_B, 0), (SERVE_B, 2), (1, 0))   # (B, pipeline depth)
SERVE_SEED = 3
SERVE_OFFSET = 0.15   # lanes start up to 0.15 m off the set-point
SERVE_SETPOINT = (0.0, 0.0, 0.5)
SERVE_REF_LANES = 16
SERVE_U_TOL = 1e-3    # kRPM, tick 1 against the port's CPU float64 run
# tests/test_serving.py:112-131: every lane within 0.02 m at the end
SERVE_BAR = 0.02
ESCALATE_ITERS = 32   # certified_config's re-solve
WIRE_N = 16           # the JAX package's bench swarm row (BENCH_r05.json)
WIRE_TICKS = 220
# tests/test_swarm_serving.py:83-107
WIRE_FINAL_ERR = 0.08
WIRE_SLOT_GAP = 0.3
WIRE_FRESH = 0.99
RT_N, RT_RATE, RT_TICKS = 2, 20.0, 80     # test_swarm_serving.py:160-212
RT_TARGETS = ((0.0, 0.0, 0.4), (0.6, 0.0, 0.4))
STEP_B, STEP_TICKS, STEP_SEED = 256, 20, 7
LOOP_GRAPH_STEPS = 3  # graphed vs op-by-op IPM algebra (check_loop_graphs)
# JAX's own cross-path bar on a swarm step (test_swarm_serving.py:150-157)
STEP_ANGLE_TOL, STEP_THRUST_RTOL = 0.02, 1e-3


def check_step_launches(label, counts, steps, resolves, iters=ITERS,
                        escalate=ESCALATE_ITERS):
    """The launches of `steps` batched RTI steps: K1 once a step, K2 and
    K3 `iters` times a step and K4 once, each escalation re-solve
    (`resolves` of them) `escalate` more K2 and K3 and one more K4,
    every other kernel never.  Returns the launches per step of the
    kernels that ran."""
    sweeps = iters * steps + escalate * resolves
    want = {"prep_condense2": steps, "kkt_sweep_c2": sweeps,
            "corrector_sweep_c2": sweeps, "expand2": steps + resolves}
    for name, got in counts.items():
        if got != want.get(name, 0):
            fail(f"{label}: {name} launched {got} times in {steps} steps "
                 f"({resolves} escalation re-solves), expected "
                 f"{want.get(name, 0)}")
    return {k: v / steps for k, v in counts.items() if v}


def check_host_syncs(label, syncs, want):
    """The counted host syncs (`device.host_syncs`) are exactly `want`:
    the emits and the escalation checks, nothing else."""
    if syncs != want:
        fail(f"{label}: host syncs {syncs}, expected {want}")


def counted(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error") (any wait on
    the card outside `device.host_sync` fails the run), with the launch,
    host-sync and escalation counters set to 0 just before: (its result,
    wall s, launches, host syncs, escalations)."""
    import torch

    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops import ipm_fast

    torch.cuda.synchronize()
    kc.reset_launch_counts()
    dv.reset_host_syncs()
    ipm_fast.reset_escalation_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        counts, syncs = kc.launch_counts(), dv.host_syncs()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, wall, counts, syncs, ipm_fast.escalation_counts()


def serving_lanes(spec, B):
    """B hover states at SERVE_SETPOINT, each position off by a seeded
    uniform draw in [-SERVE_OFFSET, SERVE_OFFSET] (on the card)."""
    import torch

    from crazyflie_nmpc_tpu_torch.models import hover_state

    dev = spec.lbu.device
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    x0 = hover_state(spec.params, pos=SERVE_SETPOINT, dtype=spec.lbu.dtype,
                     device=dev).expand(B, 13).clone()
    off = torch.rand((B, 3), generator=gen, device=dev, dtype=x0.dtype)
    x0[:, :3] += SERVE_OFFSET * (2.0 * off - 1.0)
    return x0


def serve_plant(spec, B, depth, ticks, x0, device, count=True):
    """`ServingLoop` (the default certified config) at SERVE_RATE with a
    batched RK4 plant on `device` in the sink, from x0 (B, 13): (report,
    final plant states, the first emitted u_apply, and with `count` the
    run's wall time and counters (`counted`) as a dict)."""
    import torch

    from crazyflie_nmpc_tpu_torch.device import from_host
    from crazyflie_nmpc_tpu_torch.models import dynamics
    from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
    from crazyflie_nmpc_tpu_torch.runtime.serving import (ServeConfig,
                                                          ServingLoop)
    from crazyflie_nmpc_tpu_torch.solver import hover_yref

    loop = ServingLoop(spec, serve=ServeConfig(rate_hz=SERVE_RATE,
                                               pipeline_depth=depth),
                       batch=B, device=device)
    yref, yref_e = hover_yref(spec, pos=SERVE_SETPOINT, device=device)
    plant = dict(x=x0.clone(), first=None)

    def source(k):
        return plant["x"]

    def sink(k, cmd, u_apply):
        if plant["first"] is None:
            plant["first"] = u_apply.copy()
        u = from_host(u_apply, plant["x"].dtype, plant["x"].device)
        plant["x"] = integrate(dynamics, spec.params, plant["x"], u, spec.dt)

    loop.warmup(x0, yref, yref_e)
    loop.reset(x0)
    run = lambda: loop.run(ticks, source, sink, yref, yref_e)  # noqa: E731
    if not count:
        return run(), plant["x"], plant["first"], None
    rep, wall, counts, syncs, esc = counted(run)
    plant.update(wall=wall, counts=counts, syncs=syncs, esc=esc)
    return rep, plant["x"], plant["first"], plant


def serving_bars(label, rep, x):
    """[serving]'s bars on a run's report and final plant states x
    (B, 13): every lane within SERVE_BAR of SERVE_SETPOINT in every
    coordinate and finite; at depth d every latency at least d periods
    (less 1 ms).  Returns the largest final distance."""
    lanes, worst = swarm_lanes_off(x[None], SERVE_SETPOINT, SERVE_BAR)
    if lanes:
        fail(f"{label}: {len(lanes)} lanes off by more than {SERVE_BAR} m "
             f"or not finite after {rep.ticks} ticks: {lanes[:16]}")
    depth = rep.config.pipeline_depth
    if depth and not (rep.latency_s.min()
                      >= depth * rep.config.period_s - 1e-3):
        fail(f"{label}: latency {1e3 * rep.latency_s.min():.3f} ms below "
             f"{depth} periods")
    return worst


def phase_serving(device):
    """`runtime.serving.ServingLoop` on the card: N=50, float32, the
    default certified config (escalation capacity min(128, B)), 66.6 Hz,
    SERVE_TICKS ticks at B=256 synchronous and at depth 2, and B=1
    synchronous, a batched RK4 plant on the card in the sink, lanes from
    hover plus seeded offsets of up to 0.15 m.  Each run under the sync
    debug mode, its host syncs counted (the emit and the escalation
    check, one each a tick); prints latency p50/p99/max, deadline misses,
    schedule slips, host issue, solves/s, K1-K4 launches and escalated
    lanes per tick.  Bars: every lane within SERVE_BAR of the set-point
    at the end, tick 1's u_apply on SERVE_REF_LANES lanes within
    SERVE_U_TOL of the port's float64 CPU run, depth-2 latency at least
    2 periods; a few depth-0 ticks traced (`trace_ticks`).  Then
    `measure_transport_floor` on the card.  Returns the launch totals."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.runtime.serving import (
        measure_transport_floor)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    spec64 = default_ocp(N=N, dtype=torch.float64, device="cpu")
    totals = {}
    for B, depth in SERVE_RUNS:
        label = f"[serving] B={B} depth {depth}"
        x0 = serving_lanes(spec, B)
        rep, x, first, run = serve_plant(spec, B, depth, SERVE_TICKS, x0,
                                         device)
        esc = run["esc"]
        per_tick = check_step_launches(label, run["counts"], SERVE_TICKS,
                                       esc["resolves"])
        check_host_syncs(label, run["syncs"], {"emit": SERVE_TICKS,
                                               "escalation": SERVE_TICKS})
        for k, v in run["counts"].items():
            totals[k] = totals.get(k, 0) + v
        s = rep.summary()
        print(f"{label} N={N} float32 certified, {SERVE_RATE} Hz: "
              f"{SERVE_TICKS} ticks in {run['wall']:.3f} s, latency p50 "
              f"{s['p50_ms']:.3f} / p99 {s['p99_ms']:.3f} / max "
              f"{s['max_ms']:.3f} ms (budget {s['budget_ms']:.3f}, "
              f"deadline {s['budget_ms'] * (1 + depth):.3f}); "
              f"deadline misses {s['deadline_misses']}, schedule slips "
              f"{s['schedule_slips']}; host issue {s['issue_ms']:.3f} "
              f"ms/tick (p99 {1e3 * np.percentile(rep.issue_s, 99):.3f}); "
              f"{B * SERVE_TICKS / run['wall']:.0f} solves/s; host syncs "
              f"per tick emit 1, escalation 1, none other; escalation "
              f"re-solves {esc['resolves']} in {SERVE_TICKS} ticks, "
              f"{esc['lanes']} lanes ({esc['lanes'] / SERVE_TICKS:.2f} a "
              f"tick); launches per tick "
              + ", ".join(f"{k}={v:g}" for k, v in per_tick.items()))
        worst = serving_bars(label, rep, x)
        ref_lanes = min(B, SERVE_REF_LANES)
        _, _, ref_first, _ = serve_plant(spec64, ref_lanes, depth, 1,
                                         x0[:ref_lanes].double().cpu(),
                                         "cpu", count=False)
        du = hold_close(f"{label} tick 1 u_apply vs CPU float64",
                        torch.as_tensor(first[:ref_lanes]),
                        torch.as_tensor(ref_first), SERVE_U_TOL)
        print(f"{label}: every lane within {worst:.3e} m of the set-point "
              f"(bar {SERVE_BAR} m); tick 1 u_apply on {ref_lanes} lanes "
              f"vs CPU float64 max |du| {du:.3e} kRPM (bar {SERVE_U_TOL}); "
              f"smallest latency {1e3 * rep.latency_s.min():.3f} ms")
        if depth == 0:
            trace_ticks("serving", f"B={B} depth 0", lambda t: serve_plant(
                spec, B, 0, t, x0, device, count=False),
                1e3 * run["wall"] / SERVE_TICKS)
    floor = measure_transport_floor(batch=SERVE_B, device=device)
    print(f"[serving] transport floor (put (256, 13), trivial op, fetch "
          f"(256, 4)) on {floor['platform']}: p50 {floor['p50_ms']:.4f} ms, "
          f"p99 {floor['p99_ms']:.4f} ms")
    return totals


def wire_bars(label, rep, n):
    """The JAX package's lockstep bars (test_swarm_serving.py:83-107):
    final error below WIRE_FINAL_ERR, slots more than WIRE_SLOT_GAP
    apart, fresh rows on more than WIRE_FRESH of the ticks after 5,
    finite latencies."""
    import numpy as np

    if not np.isfinite(rep.latency_s).all() or rep.latency_s.shape != (
            rep.ticks, n):
        fail(f"{label}: latency accounting {rep.latency_s.shape}")
    if not rep.final_err_m.max() < WIRE_FINAL_ERR:
        fail(f"{label}: final errors {rep.final_err_m.round(4).tolist()} "
             f"m, bar {WIRE_FINAL_ERR}")
    pos = rep.positions[-1]
    gap = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)[
        np.triu_indices(n, 1)].min()
    if not gap > WIRE_SLOT_GAP:
        fail(f"{label}: two vehicles {gap:.4f} m apart, bar "
             f"{WIRE_SLOT_GAP}")
    fresh = float((rep.staleness[5:] <= 1).mean())
    if not fresh > WIRE_FRESH:
        fail(f"{label}: fresh rows on {fresh:.4f} of the ticks, bar "
             f"{WIRE_FRESH}")
    return gap, fresh


def realtime_bars(label, rep, n):
    """The JAX package's realtime bars (test_swarm_serving.py:198-212)."""
    import numpy as np

    if not np.isfinite(rep.latency_s).all():
        fail(f"{label}: non-finite latencies")
    zmax = rep.positions[:, :, 2].max(axis=0)
    if not (zmax > 0.2).all():
        fail(f"{label}: vehicles did not fly (max z {zmax.tolist()})")
    live = float((rep.staleness[-20:] <= 3).mean())
    if not live > 0.8:
        fail(f"{label}: telemetry live on {live:.3f} of the last 20 ticks")
    if not rep.schedule_slips < 40:
        fail(f"{label}: {rep.schedule_slips} schedule slips")
    return zmax, live


def step_telemetry(B):
    """Seeded telemetry of B vehicles near their slots (as
    tests/test_torch_swarm.py): (targets, x0s, mocap, euler, gyro)."""
    import numpy as np

    from crazyflie_nmpc_tpu_torch.runtime.swarm import grid_targets

    targets = grid_targets(B, spacing=0.6, z=0.4)
    rng = np.random.default_rng(STEP_SEED)
    x0s = 0.05 * rng.standard_normal((B, 13))
    x0s[:, :3] += targets * np.array([1.0, 1.0, 0.2])
    x0s[:, 3] = 1.0
    return (targets, x0s, x0s[:, :3].copy(), 5.0 * rng.standard_normal(
        (B, 3)), 10.0 * rng.standard_normal((B, 3)))


def graphs_agree(label, got, want):
    """Fail unless every output of the run with the IPM algebra replayed
    from CUDA graphs equals the op-by-op run's bit for bit: both issue
    the same kernels and operations in the same order.  Returns how many
    outputs agreed."""
    import torch

    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not torch.equal(a, b)]
    if len(got) != len(want) or bad:
        fail(f"{label}: outputs {bad} of {len(want)} differ from the "
             f"op-by-op run")
    return len(got)


def check_loop_graphs(device):
    """`rti_step_batched` with the IPM iteration's algebra replayed from
    CUDA graphs (`ops.ipm_fast.LoopGraphs`, as `SwarmNMPC` runs it)
    against the same steps issued operation by operation, from seeded
    states near their slots: the realtime run's settings (N=20, tf=0.3,
    IPMConfig(iters=4), RT_N lanes) and the certified default (N, STEP_B
    lanes, escalation on), LOOP_GRAPH_STEPS steps each, every plan,
    residual and mu equal bit for bit (`graphs_agree`)."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.device import from_host, host_sync
    from crazyflie_nmpc_tpu_torch.models.quadrotor import NX, NY
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
    from crazyflie_nmpc_tpu_torch.ops.ipm_fast import LoopGraphs
    from crazyflie_nmpc_tpu_torch.runtime.serving import ESCALATION_CAPACITY
    from crazyflie_nmpc_tpu_torch.solver import default_ocp
    from crazyflie_nmpc_tpu_torch.solver.rti import init_rti
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (rti_step_batched,
                                                             to_batch_last)

    for n, tf, cfg, B in (
            (20, 0.3, IPMConfig(iters=4), RT_N),
            (N, TF, certified_config(min(ESCALATION_CAPACITY, STEP_B)),
             STEP_B)):
        spec = default_ocp(N=n, tf=tf, dtype=torch.float32, device=device)
        targets, x0s, *_ = step_telemetry(B)
        y = np.zeros((B, NY))
        y[:, :3] = targets
        y[:, 3] = 1.0
        y[:, NX:] = spec.params.hover_speed()
        y = from_host(y, torch.float32, device)
        x = from_host(x0s, torch.float32, device)
        runs = []
        for graphs in (LoopGraphs(), None):
            st = to_batch_last(init_rti(spec, x, device=device))
            outs = []
            # the first graphed solve captures (torch waits for the card)
            with host_sync("graph capture"):
                for _ in range(LOOP_GRAPH_STEPS):
                    st, out = rti_step_batched(
                        spec, st, x, y[:, None].expand(B, n, NY),
                        y[:, :NX], cfg, layout="batch_last", graphs=graphs)
                    outs += [out.u_plan, out.x_plan, out.qp_mu,
                             out.kkt_res]
            runs.append(outs)
        k = graphs_agree(f"[swarm_wire] LoopGraphs N={n} B={B}", *runs)
        print(f"[swarm_wire] LoopGraphs N={n} B={B} {cfg}: "
              f"{LOOP_GRAPH_STEPS} steps with the IPM algebra replayed "
              f"from CUDA graphs equal the op-by-op steps bit for bit "
              f"({k} outputs)")


def phase_swarm_wire(device):
    """`bringup.swarm_serving` and `runtime.swarm` on the card (N=50
    unless named, float32, the default certified config), each under the
    sync debug mode with its host syncs counted: the lockstep run of
    WIRE_N vehicles over the native link for WIRE_TICKS ticks at 66.6 Hz
    (the JAX bars: final error, distinct slots, fresh rows); the realtime
    run of RT_N vehicles at RT_RATE Hz for RT_TICKS ticks with the JAX
    test's settings (N=20, tf=0.3, IPMConfig(iters=4)) and bars; then
    `SwarmNMPC.step` alone at STEP_B lanes on seeded telemetry,
    STEP_TICKS timed ticks, tick 1 on SERVE_REF_LANES lanes held against
    the port's float64 CPU run (u_apply to SERVE_U_TOL, cmd to JAX's
    cross-path bar).  Prints the plant's host ms per vehicle period.
    Returns the launch totals."""
    import contextlib

    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch import bringup, native
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.swarm import (SwarmNMPC,
                                                        serve_swarm)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    out, wall, counts, syncs, esc = counted(lambda: bringup.swarm_serving(
        n=WIRE_N, ticks=WIRE_TICKS, base_port=0, device=device, spec=spec))
    steps = WIRE_TICKS + 1                     # and the warm-up step
    label = f"[swarm_wire] lockstep {WIRE_N} vehicles"
    per_tick = check_step_launches(label, counts, steps, esc["resolves"])
    # the predictor's CUDA graph is captured at the first step
    check_host_syncs(label, syncs, {"emit": steps, "escalation": steps,
                                    "graph capture": 1})
    add(counts)
    rep = out["report"]
    s = rep.summary()
    print(f"{label}, N={N} float32 certified, {SERVE_RATE} Hz: "
          f"{WIRE_TICKS} ticks in {wall:.3f} s ({1e3 * wall / steps:.3f} "
          f"ms a tick, the vehicles' physics and the wire included); emit "
          f"latency p50 {s['p50_ms']:.3f} / p99 {s['p99_ms']:.3f} ms, "
          f"deadline misses {s['total_misses']} of {WIRE_TICKS * WIRE_N} "
          f"(worst vehicle {s['worst_vehicle_miss']}); final error max "
          f"{s['final_err_max_m']:.3e} m (bar {WIRE_FINAL_ERR}); plant "
          f"{out['plant_ms_per_period']:.4f} host ms a vehicle period; "
          f"host syncs per tick emit 1, escalation 1, and one graph "
          f"capture; escalation re-solves {esc['resolves']}, "
          f"{esc['lanes']} lanes; launches per tick "
          + ", ".join(f"{k}={v:g}" for k, v in per_tick.items()))
    gap, fresh = wire_bars(label, rep, WIRE_N)
    print(f"{label}: slots >= {gap:.3f} m apart (bar {WIRE_SLOT_GAP}), "
          f"fresh rows on {fresh:.4f} of ticks 5+ (bar {WIRE_FRESH})")

    rt_spec = default_ocp(N=20, tf=0.3, dtype=torch.float32, device=device)
    targets = np.asarray(RT_TARGETS)
    swarm = SwarmNMPC(rt_spec, targets, tick_dt=1.0 / RT_RATE,
                      ipm_config=IPMConfig(iters=4), device=device)

    def realtime():
        with contextlib.ExitStack() as stack:
            fws = []
            for i in range(RT_N):
                fw = stack.enter_context(native.CascadeFirmwareSim(
                    0, x0=(targets[i, 0], targets[i, 1], 0.03)))
                fw.serve()
                fws.append(fw)
            server = stack.enter_context(native.LinkServer())
            for i, fw in enumerate(fws):
                server.add_vehicle(i + 1, "127.0.0.1", fw.port, 0)
            rep = serve_swarm(rt_spec, server, list(range(1, RT_N + 1)),
                              fws, swarm, RT_TICKS, rate_hz=RT_RATE,
                              lockstep=False)
            return rep, sum(fw.plant_s for fw in fws) / max(
                1, sum(fw.plant_periods for fw in fws))

    (rep, plant_s), wall, counts, syncs, esc = counted(realtime)
    label = f"[swarm_wire] realtime {RT_N} vehicles {RT_RATE:g} Hz"
    steps = RT_TICKS + 1
    s = rep.summary()
    ran = {k: v for k, v in counts.items() if v}
    print(f"{label}, N=20 tf=0.3 float32 IPMConfig(iters=4): {RT_TICKS} "
          f"ticks in {wall:.3f} s; emit latency p50 {s['p50_ms']:.3f} / "
          f"p99 {s['p99_ms']:.3f} / max {1e3 * rep.latency_s.max():.3f} "
          f"ms, deadline misses {s['total_misses']}, schedule slips "
          f"{s['schedule_slips']} (bar < 40); max z "
          f"{np.round(rep.positions[:, :, 2].max(axis=0), 4).tolist()} m "
          f"(bar > 0.2); final error {s['final_err_max_m']:.4f} m; plant "
          f"{1e3 * plant_s:.4f} host ms a vehicle period (beside the serve "
          f"threads); host syncs {syncs}; launches {ran}")
    per_tick = check_step_launches(label, counts, steps, 0, iters=4)
    check_host_syncs(label, syncs, {"emit": steps, "graph capture": 1})
    add(counts)
    zmax, live = realtime_bars(label, rep, RT_N)
    print(f"{label}: telemetry live on {live:.3f} of the last 20 ticks; "
          f"launches per tick "
          + ", ".join(f"{k}={v:g}" for k, v in per_tick.items()))

    targets, x0s, mocap, euler, gyro = step_telemetry(STEP_B)
    sw = SwarmNMPC(spec, targets, device=device)
    sw.reset(x0s)
    sw.step(mocap, euler, gyro)                # warm-up, not counted
    sw.reset(x0s)

    def ticks():
        outs, ts = [], []
        for _ in range(STEP_TICKS):
            t0 = time.perf_counter()
            outs.append(sw.step(mocap, euler, gyro))
            ts.append(time.perf_counter() - t0)
        return outs, ts

    (outs, ts), wall, counts, syncs, esc = counted(ticks)
    label = f"[swarm_wire] SwarmNMPC.step B={STEP_B}"
    per_tick = check_step_launches(label, counts, STEP_TICKS,
                                   esc["resolves"])
    check_host_syncs(label, syncs, {"emit": STEP_TICKS,
                                    "escalation": STEP_TICKS})
    add(counts)
    lanes = SERVE_REF_LANES
    spec64 = default_ocp(N=N, dtype=torch.float64, device="cpu")
    ref = SwarmNMPC(spec64, targets[:lanes], device="cpu")
    ref.reset(x0s[:lanes])
    rcmd, ru = ref.step(mocap[:lanes], euler[:lanes], gyro[:lanes])
    cmd, u = outs[0]
    du = hold_close(f"{label} tick 1 u_apply vs CPU float64",
                    torch.as_tensor(u[:lanes]), torch.as_tensor(ru),
                    SERVE_U_TOL)
    dang = hold_close(f"{label} tick 1 cmd angles vs CPU float64",
                      torch.as_tensor(cmd[:lanes, :3]),
                      torch.as_tensor(rcmd[:, :3]), STEP_ANGLE_TOL)
    dthr = float(np.abs(cmd[:lanes, 3] / rcmd[:, 3] - 1.0).max())
    if not dthr <= STEP_THRUST_RTOL:
        fail(f"{label}: tick 1 thrust {dthr:.3e} relative from the CPU "
             f"float64 run")
    if not all(np.isfinite(c).all() and np.isfinite(v).all()
               for c, v in outs):
        fail(f"{label}: non-finite commands")
    ts = np.asarray(ts) * 1e3
    print(f"{label} N={N} float32 certified, seeded telemetry: "
          f"{STEP_TICKS} ticks, {ts.mean():.3f} ms a tick (p50 "
          f"{np.percentile(ts, 50):.3f}, max {ts.max():.3f}; estimator, "
          f"predictor, solve and emit), {STEP_B / ts.mean() * 1e3:.0f} "
          f"solves/s; escalation re-solves {esc['resolves']}, "
          f"{esc['lanes']} lanes; tick 1 on {lanes} lanes vs CPU float64: "
          f"max |du| {du:.3e} kRPM, angles {dang:.3e} deg, thrust "
          f"{dthr:.3e} relative; launches per tick "
          + ", ".join(f"{k}={v:g}" for k, v in per_tick.items()))
    check_loop_graphs(device)
    return totals


# ---------------------------------------------------------------------------
# differentiable MPC, the model-generic path, the mission client
# ---------------------------------------------------------------------------

# tests/test_tuning.py's detuned weights: position 100x too small
Q_DETUNED = (1.2, 1.0, 1.0, 1e-3, 1e-3, 1e-3, 1e-3, 0.7, 1.0, 4.0, 1e-5,
             1e-5, 10.0)
GRAD_TICKS, GRAD_ITERS = 20, 5          # tests/test_tuning.py:72
REMAT_TICKS, REMAT_ITERS = 12, 4        # tests/test_tuning.py:109
TUNE_TICKS, TUNE_STEPS, TUNE_LR = 30, 8, 0.15   # tests/test_tuning.py:93
# examples/weight_tuning.py's width: N=20, tf=0.3, 45 ticks, 6 iterations
WIDE_N, WIDE_TF, WIDE_TICKS, WIDE_ITERS = 20, 0.3, 45, 6
CP_SQP_ITERS, CP_IPM_ITERS = 60, 12     # tests/test_cartpole.py:88-123
CP_REF_ITERATES = 3
CP_TICKS = 20                           # of the JAX test's 140 (PERF.md)
CP_TICK_SQP = 3
CP_SIM_TICKS = 2                        # simulate, delay 2, vs the CPU
CLIENT_TICKS = 160                      # tests/test_runtime_extras.py:34
CLIENT_BAR = 0.02


def detuned_spec(n, tf, dev):
    """The reference OCP at N=n with tests/test_tuning.py's detuned
    weights, float64 on dev."""
    import torch

    from crazyflie_nmpc_tpu_torch.runtime.tuning import spec_with_diag_cost
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    spec = default_ocp(N=n, tf=tf, dtype=torch.float64, device=dev)
    q = torch.tensor(Q_DETUNED, dtype=torch.float64, device=dev)
    w = torch.cat([q, torch.full((4,), 0.06, dtype=torch.float64,
                                 device=dev)])
    return spec_with_diag_cost(spec, w, 50.0 * q)


def tuning_loss(spec, x0, ticks, iters, remat=False):
    """(log W diag leaf, fn() -> hover_objective of `ticks` hover ticks
    from x0 with W = exp(leaf), W_e fixed): the JAX test's loss."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.closed_loop import (
        LoopConfig, hover_regulation)
    from crazyflie_nmpc_tpu_torch.runtime.tuning import (hover_objective,
                                                         spec_with_diag_cost)

    cfg = LoopConfig(ipm=IPMConfig(iters=iters), remat=remat)
    obj = hover_objective()
    logw = torch.log(torch.diagonal(spec.cost.W)).detach().requires_grad_()

    def loss():
        s = spec_with_diag_cost(spec, torch.exp(logw),
                                torch.diagonal(spec.cost.W_e))
        return obj(hover_regulation(s, x0, steps=ticks, config=cfg))

    return logw, loss


def value_and_grad(spec, x0, ticks, iters, remat=False):
    """(loss, d loss / d log W diag, forward ms, backward ms, peak MB,
    host syncs): each pass timed on the host clock to a synchronize, the
    peak of device memory allocated over both, and the waits on the card
    the sync debug mode saw (counted from its warnings)."""
    import warnings

    import torch

    logw, loss = tuning_loss(spec, x0, ticks, iters, remat)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            val = loss()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            g, = torch.autograd.grad(val, logw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in seen)
    peak = torch.cuda.max_memory_allocated() / 2**20
    return (val.detach(), g, (t1 - t0) * 1e3, (t2 - t1) * 1e3, peak,
            syncs)


def launches(fn):
    """Device kernels one call of fn ran (a torch.profiler trace), or
    None when the profiler recorded none."""
    sums = trace_sums(fn)
    if sums is None:
        return None
    _, ours, (_, n_other) = sums
    return n_other + sum(n for _, n in ours.values())


def launches_per_tick(spec, x0, iters, remat):
    """Forward and backward device launches a tick of value_and_grad: a
    traced 2-tick run less a 1-tick one, forward alone and both passes."""
    import torch

    def fwd(t):
        _, loss = tuning_loss(spec, x0, t, iters, remat)
        with torch.no_grad():
            loss()

    def both(t):
        logw, loss = tuning_loss(spec, x0, t, iters, remat)
        torch.autograd.grad(loss(), logw)

    n = {k: [launches(lambda: f(t)) for t in (1, 2)]
         for k, f in (("fwd", fwd), ("both", both))}
    if any(v is None for pair in n.values() for v in pair):
        return None
    f = n["fwd"][1] - n["fwd"][0]
    return f, n["both"][1] - n["both"][0] - f


def phase_tuning(device):
    """Differentiable MPC on the card (`runtime.tuning`, float64, the
    detuned reference OCP of tests/test_tuning.py, hover from x = 0.4 m,
    no escalation):

      (a) d hover_objective / d log W diag at N=15, tf=0.225, 20 ticks,
          IPMConfig(iters=5): the JAX bars (finite, max |g| > 1e-6,
          g[0] < 0) and its largest gap to the port's CPU float64
          gradient, relative to its largest entry;
      (b) LoopConfig(remat=True) against the stored gradient, 12 ticks,
          iters=4, to the JAX test's rtol 1e-9 / atol 1e-12, with each
          one's peak device memory;
      (c) is phase_tuning_adam, (d) phase_tuning_wide.

    No hand-written kernel runs here (the launch counters are checked at
    0 over the whole phase)."""
    import torch

    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    kc.reset_launch_counts()
    spec = detuned_spec(15, 0.225, device)

    def x_start(dev):
        return hover_state(spec.params, pos=(0.4, 0.0, 0.0),
                           dtype=torch.float64, device=dev)

    value_and_grad(spec, x_start(device), 1, GRAD_ITERS)   # warm-up
    # (a) the gradient, against the port's CPU float64 run
    val, g, ms_f, ms_b, _, _ = value_and_grad(spec, x_start(device),
                                              GRAD_TICKS, GRAD_ITERS)
    g = g.cpu()
    logw, loss = tuning_loss(detuned_spec(15, 0.225, "cpu"), x_start("cpu"),
                             GRAD_TICKS, GRAD_ITERS)
    g_cpu, = torch.autograd.grad(loss(), logw)
    gap = float((g - g_cpu).abs().max() / g_cpu.abs().max())
    if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 1e-6
            and float(g[0]) < 0.0):
        fail(f"[tuning] (a) gradient misses the JAX bars: {g.tolist()}")
    if not gap <= 1e-6:
        fail(f"[tuning] (a) gradient {gap:.3e} (relative to its largest "
             f"entry) from the CPU float64 one")
    print(f"[tuning] (a) N=15 float64, {GRAD_TICKS} ticks, iters="
          f"{GRAD_ITERS}: loss {float(val):.10f}, forward {ms_f:.1f} ms, "
          f"backward {ms_b:.1f} ms; max |g| {float(g.abs().max()):.4e}, "
          f"g[0] {float(g[0]):.4e} (< 0: the JAX bar); largest gap to the "
          f"CPU float64 gradient {gap:.3e} of its largest entry")

    # (b) remat against stored
    runs = {r: value_and_grad(spec, x_start(device), REMAT_TICKS,
                              REMAT_ITERS, remat=r) for r in (False, True)}
    gs, gr = runs[False][1], runs[True][1]
    if not bool(torch.allclose(gr, gs, rtol=1e-9, atol=1e-12)):
        fail(f"[tuning] (b) remat gradient differs: max |diff| "
             f"{float((gr - gs).abs().max()):.3e}")
    print(f"[tuning] (b) {REMAT_TICKS} ticks, iters={REMAT_ITERS}: remat "
          f"gradient vs stored max |diff| {float((gr - gs).abs().max()):.3e}"
          f" (rtol 1e-9, atol 1e-12); peak device memory stored "
          f"{runs[False][4]:.1f} MB, remat {runs[True][4]:.1f} MB")

    check_tick_launches("[tuning]", kc.launch_counts(), 1, {})
    print("[tuning] hand-written kernels launched: none (plain PyTorch)")


def phase_tuning_adam(device):
    """(c) of [tuning]: tune_diagonal_cost on the detuned OCP (N=15,
    float64), 30 hover ticks from (0.4, -0.3), IPMConfig(iters=5), 8 Adam
    steps, lr 0.15: the JAX bars (best < 0.6 of the first loss, w[0] >
    1.2, all weights positive), the wall time and the host syncs (one
    loss read a step).  No hand-written kernel runs here."""
    import torch

    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.closed_loop import (
        LoopConfig, hover_regulation)
    from crazyflie_nmpc_tpu_torch.runtime.tuning import (hover_objective,
                                                         tune_diagonal_cost)

    kc.reset_launch_counts()
    spec = detuned_spec(15, 0.225, device)
    cfg = LoopConfig(ipm=IPMConfig(iters=GRAD_ITERS))
    x0 = hover_state(spec.params, pos=(0.4, -0.3, 0.0), dtype=torch.float64,
                     device=device)
    obj = hover_objective()

    def roll(s):
        return hover_regulation(s, x0, steps=TUNE_TICKS, config=cfg)

    dv.reset_host_syncs()
    t0 = time.perf_counter()
    res = tune_diagonal_cost(spec, roll, obj, iters=TUNE_STEPS, lr=TUNE_LR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = dv.host_syncs()
    with torch.no_grad():
        first, best = float(res.losses[0]), float(obj(roll(res.spec)))
    w = res.w_diag.cpu()
    if not (best < 0.6 * first and float(w[0]) > 1.2
            and bool((w > 0).all())):
        fail(f"[tuning] (c) misses the JAX bars: first {first}, best "
             f"{best}, w {w.tolist()}")
    print(f"[tuning] (c) tune_diagonal_cost {TUNE_STEPS} Adam steps of "
          f"{TUNE_TICKS} ticks, lr {TUNE_LR}: {wall:.1f} s "
          f"({wall / TUNE_STEPS * 1e3:.0f} ms a step); losses "
          f"{[round(float(v), 6) for v in res.losses]}; best {best:.6f} = "
          f"{best / first:.3f} of the first (bar 0.6); w[0] "
          f"{float(w[0]):.4f} (bar 1.2), all > 0; host syncs {syncs}")
    check_tick_launches("[tuning] (c)", kc.launch_counts(), 1, {})


def phase_tuning_wide(device):
    """(d) of [tuning]: one value and gradient at examples/weight_tuning.py's
    width (N=20, tf=0.3, 45 ticks, iters=6, float64, the detuned weights,
    hover from x = 0.4 m), stored and remat: ms of each pass, device
    launches a tick of each (traced: a 2-tick run less a 1-tick one), host
    syncs (the sync debug mode's warnings) and peak device memory.  No
    hand-written kernel runs here."""
    import torch

    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    kc.reset_launch_counts()
    wide = detuned_spec(WIDE_N, WIDE_TF, device)

    def x_start(dev):
        return hover_state(wide.params, pos=(0.4, 0.0, 0.0),
                           dtype=torch.float64, device=dev)

    value_and_grad(wide, x_start(device), 1, WIDE_ITERS)   # warm-up
    for remat in (False, True):
        val, g, ms_f, ms_b, peak, nsync = value_and_grad(
            wide, x_start(device), WIDE_TICKS, WIDE_ITERS, remat)
        if not (bool(torch.isfinite(g).all()) and float(g[0]) < 0.0):
            fail(f"[tuning] (d) remat={remat}: gradient not finite or "
                 f"g[0] >= 0: {g.tolist()}")
        per = launches_per_tick(wide, x_start(device), WIDE_ITERS, remat)
        per = ("not measured (no device kernels traced)" if per is None
               else f"{per[0]} forward / {per[1]} backward")
        print(f"[tuning] (d) N={WIDE_N} tf={WIDE_TF} float64, "
              f"{WIDE_TICKS} ticks, iters={WIDE_ITERS}, remat={remat}: "
              f"forward {ms_f:.1f} ms ({ms_f / WIDE_TICKS:.2f} ms/tick), "
              f"backward {ms_b:.1f} ms ({ms_b / WIDE_TICKS:.2f} ms/tick); "
              f"device launches a tick {per}; host syncs {nsync}; peak "
              f"device memory {peak:.1f} MB; loss {float(val):.8f}")
    check_tick_launches("[tuning] (d)", kc.launch_counts(), 1, {})


def phase_cartpole(device):
    """The model-generic path on the card (`models.cartpole`, a custom ODE
    linearised by jacfwd under vmap), float64, cartpole_ocp() (N=40,
    0.05 s stages):

      * sqp_solve from hanging, 60 iterations, IPMConfig(iters=12): the
        JAX bars (last KKT < 1e-8, |theta_N| < 0.05); its first 3
        iterates against the port's CPU float64 run (to LOOP_TOL);
      * the same with f_max=40: |F| <= 40 + 1e-6 and max F > 39;
      * CP_TICKS closed-loop swing-up ticks from the converged plan, 3
        SQP iterations a tick (ms/tick; launches a tick traced);
      * runtime.simulate of the spec with a 2-tick delay, its first 2
        ticks against the CPU.

    No hand-written kernel runs here."""
    import torch

    from crazyflie_nmpc_tpu_torch.device import device_tensor
    from crazyflie_nmpc_tpu_torch.models.cartpole import (cartpole_dynamics,
                                                          cartpole_ocp,
                                                          downward_state)
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.closed_loop import (LoopConfig,
                                                              simulate)
    from crazyflie_nmpc_tpu_torch.solver import policies
    from crazyflie_nmpc_tpu_torch.solver.rti import init_rti, sqp_solve

    cfg = IPMConfig(iters=CP_IPM_ITERS)
    f64 = torch.float64

    def refs(spec, dev):
        return (torch.zeros((spec.N, 5), dtype=f64, device=dev),
                torch.zeros((4,), dtype=f64, device=dev))

    def swing_plan(dev, iterates=0, **kw):
        """sqp_solve from hanging, the first `iterates` iterations one at
        a time (their states kept), then the rest."""
        spec = cartpole_ocp(device=dev, **kw)
        x = downward_state(f64, device=dev)
        st, (yref, yref_e) = init_rti(spec, x, device=dev), refs(spec, dev)
        kept = []
        for _ in range(iterates):
            st, _ = sqp_solve(spec, st, x, yref, yref_e, iters=1,
                              config=cfg)
            kept.append(st)
        st, kkts = sqp_solve(spec, st, x, yref, yref_e,
                             iters=CP_SQP_ITERS - iterates, config=cfg)
        return spec, st, kkts, kept

    kc.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec, st, kkts, kept = swing_plan(device, CP_REF_ITERATES)
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) * 1e3 / CP_SQP_ITERS
    kkt, theta_n = float(kkts[-1]), float(st.x_traj[-1, 1])
    if not (kkt < 1e-8 and abs(theta_n) < 0.05):
        fail(f"[cartpole] swing-up plan misses the JAX bars: KKT {kkt:.3e}"
             f" (1e-8), theta_N {theta_n:.4f} (0.05)")
    _, _, _, ref = swing_plan("cpu", CP_REF_ITERATES)
    errs = [max(hold_close(f"[cartpole] SQP iterate {k + 1} {f} vs CPU "
                           "float64", getattr(a, f), getattr(b, f),
                           LOOP_TOL) for f in ("x_traj", "u_traj"))
            for k, (a, b) in enumerate(zip(kept, ref))]
    print(f"[cartpole] cartpole_ocp() N={spec.N} float64: sqp_solve from "
          f"hanging, {CP_SQP_ITERS} iterations (iters={CP_IPM_ITERS}) in "
          f"{ms_iter:.1f} ms an iteration; last KKT {kkt:.3e} (bar 1e-8), "
          f"theta_N {theta_n:.2e} (bar 0.05); iterates 1-{CP_REF_ITERATES} "
          f"vs CPU float64 max |diff| "
          + ", ".join(f"{e:.3e}" for e in errs))

    _, st40, _, _ = swing_plan(device, f_max=40.0)
    u = st40.u_traj
    if not (float(u.abs().max()) <= 40.0 + 1e-6 and float(u.max()) > 39.0):
        fail(f"[cartpole] f_max=40: force {float(u.min()):.4f}.."
             f"{float(u.max()):.4f} (box 40, must reach 39)")
    print(f"[cartpole] f_max=40: force {float(u.min()):.6f}.."
          f"{float(u.max()):.6f} N (|F| <= 40 + 1e-6, max > 39)")

    yref, yref_e = refs(spec, device)

    def swing(ticks, st=st):
        x = downward_state(f64, device=device)
        for _ in range(ticks):
            st, _ = sqp_solve(spec, st, x, yref, yref_e, iters=CP_TICK_SQP,
                              config=cfg)
            x = rk4_step(cartpole_dynamics, spec.params, x, st.u_traj[0],
                         spec.dt)
        return x, st

    (x, st2), ms, host, counts = timed_call(lambda: swing(CP_TICKS))
    check_tick_launches("[cartpole]", counts, CP_TICKS, {})
    if not (bool(torch.isfinite(x).all())
            and float(st2.u_traj.abs().max()) <= 80.0 + 1e-6):
        fail(f"[cartpole] swing-up ticks: state {x.tolist()}, force max "
             f"{float(st2.u_traj.abs().max())}")
    print(f"[cartpole] {CP_TICKS} closed-loop swing-up ticks of "
          f"{CP_TICK_SQP} SQP iterations: {ms / CP_TICKS:.1f} ms/tick, host "
          f"issue {host / CP_TICKS:.1f} ms/tick; no host sync; state after "
          f"{CP_TICKS} ticks {[round(float(v), 4) for v in x]}; "
          f"hand-written kernels launched: none")
    trace_ticks("cartpole", "swing-up", lambda t: swing(t), ms / CP_TICKS,
                hi=2)

    def sim(dev):
        """simulate's arguments on dev (made before the timed call: the
        spec's weights come from the host) and the call."""
        args = (cartpole_ocp(device=dev),
                device_tensor((0.2, 0.1, 0.0, 0.0), f64, dev),
                policies.regulation_state(torch.zeros(5, dtype=f64,
                                                      device=dev),
                                          device=dev),
                torch.zeros((1, 5), dtype=f64, device=dev), CP_SIM_TICKS,
                LoopConfig(delay_steps=2, ipm=IPMConfig(iters=10)))
        return lambda: simulate(*args)

    res, ms, host, counts = timed_call(sim(device))
    check_tick_launches("[cartpole] simulate", counts, CP_SIM_TICKS, {})
    ref = sim("cpu")()
    errs = [hold_close(f"[cartpole] simulate {f} vs CPU float64",
                       getattr(res, f), getattr(ref, f), LOOP_TOL)
            for f in ("x", "u", "u_cmd")]
    print(f"[cartpole] simulate delay 2, iters=10: {CP_SIM_TICKS} ticks, "
          f"{ms / CP_SIM_TICKS:.1f} ms/tick; vs CPU float64 max |dx| "
          f"{errs[0]:.3e}, |du| {errs[1]:.3e}, |du_cmd| {errs[2]:.3e}")


def phase_client(device):
    """`runtime.client.MissionClient` on the card: takeoff(0.5 m, 1.5 s)
    flown closed loop on rti_step at the reference N=50, float32,
    IPMConfig(iters=8), CLIENT_TICKS ticks with the RK4 plant on the card,
    under the sync debug mode with host syncs counted (a tick makes
    none); the JAX bars (|z - 0.5| < 0.02 and `done`), ms/tick and host
    syncs a tick by reason.  No hand-written kernel runs here."""
    import torch

    from crazyflie_nmpc_tpu_torch.models import dynamics, hover_state
    from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime.client import MissionClient
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti, policies,
                                                 rti_step)

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    cfg = IPMConfig(iters=ITERS)
    client = MissionClient(spec)
    client.takeoff(height=0.5, duration=1.5, at=(0.0, 0.0, 0.0))
    if client.mode != policies.TRACKING:
        fail("[client] takeoff did not start tracking")
    x = hover_state(spec.params, pos=(0.0, 0.0, 0.04), device=device)
    state = init_rti(spec, x, device=device)
    rti_step(spec, state, x, *hover_yref(spec, device=device), cfg)  # warm-up

    def fly():
        xs, st = x, state
        for _ in range(CLIENT_TICKS):
            yref, yref_e = client.tick()
            st, out = rti_step(spec, st, xs, yref, yref_e, cfg)
            xs = rk4_step(dynamics, spec.params, xs, out.u0, spec.dt)
        return xs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, _, counts, syncs, _ = counted(fly)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_tick_launches("[client]", counts, CLIENT_TICKS, {})
    check_host_syncs("[client]", syncs, {})
    z = float(xs[2])
    done = client.done
    if not (abs(z - 0.5) < CLIENT_BAR and done):
        fail(f"[client] takeoff ends at z {z:.4f} (bar 0.5 +- "
             f"{CLIENT_BAR}), done {done}")
    print(f"[client] MissionClient.takeoff(0.5 m, 1.5 s) on rti_step N={N} "
          f"float32 iters={ITERS}: {CLIENT_TICKS} ticks, "
          f"{wall / CLIENT_TICKS * 1e3:.1f} ms/tick (host clock to a "
          f"synchronize), z after {CLIENT_TICKS} ticks {z:.5f} (bar 0.5 +- "
          f"{CLIENT_BAR}), done {done}; host syncs a tick: none (mode and "
          f"done read once after the flight); hand-written kernels "
          f"launched: none")


def phase_long(device):
    """N=400 (tf=6.0), B=4096: windowed=True (the split sweeps) and
    windowed=None (the fused sweeps), 20 chained steps each; step 1 of
    both against each other and against a float64 CPU run of 8 lanes."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    win = run_chain(B_LONG, device, n=N_LONG, windowed=True)
    totals = check_chain("long windowed", win, B_LONG, N_LONG, {
        "prep_condense2": 1, "bwd_c2": ITERS, "bwd_vec_c2": ITERS,
        "fwd_c2": 2 * ITERS, "expand2": 1})
    fused = run_chain(B_LONG, device, n=N_LONG, windowed=None)
    check_chain("long fused", fused, B_LONG, N_LONG, {
        "prep_condense2": 1, "kkt_sweep_c2": ITERS,
        "corrector_sweep_c2": ITERS, "expand2": 1})
    # the same formulas in the same order, one launch boundary apart:
    # rounding-level agreement (the TPU's pair agreed bitwise)
    d_win = float((win["first"].u0 - fused["first"].u0).abs().max())
    dx_win = float((win["first"].x_plan - fused["first"].x_plan).abs().max())
    lanes = slice(0, N_LONG_REF_LANES)
    ref, _ = cpu_reference_step(win["x0s"][lanes], IPMConfig(iters=ITERS),
                                n=N_LONG)
    scale = max(1.0, float(ref.x_plan.abs().max()))
    e_win, x_win = step1_error(win, ref, lanes)
    e_fused, x_fused = step1_error(fused, ref, lanes)
    # the yardstick: the plain versions in float32 on the CPU, same lanes
    ref32, _ = cpu_reference_step(win["x0s"][lanes], IPMConfig(iters=ITERS),
                                  n=N_LONG, dtype=torch.float32)
    e32 = float((ref32.u0.double() - ref.u0).abs().max())
    x32 = float((ref32.x_plan.double() - ref.x_plan).abs().max())
    # float32 through a 200-stage Riccati recursion vs float64: u0 to 1e-2
    # kRPM (the JAX package's f32 windowed path read 1.4e-3, BENCH_r05
    # longN_windowed_vs_f64).  The 401-state plan, which the rollouts
    # carry through all 200 stages (u0 does not depend on them), to 2e-2
    # of its largest entry: after 8 iterations the N=400 iterate is far
    # from converged and rounding-sensitive, so float32 moves its far
    # stages by up to ~1% of that entry, in the plain versions as on the
    # card (the yardstick's error is printed beside).  The kernels
    # themselves are held against their plain versions at N=400 in
    # phase_kernels and phase_timing.
    print(f"[long] step 1: windowed vs fused on the card max |du0| "
          f"{d_win:.3e} kRPM, |dx_plan| {dx_win:.3e}; vs CPU float64 "
          f"({N_LONG_REF_LANES} lanes): windowed {e_win:.3e} kRPM, "
          f"|dx_plan| {x_win:.3e}; fused {e_fused:.3e} kRPM, |dx_plan| "
          f"{x_fused:.3e}; plain float32 on the CPU {e32:.3e} kRPM, "
          f"|dx_plan| {x32:.3e} (largest plan entry {scale:.3f})")
    print(f"[long] N={N_LONG} B={B_LONG}: windowed {win['ms']:.3f} ms/step, "
          f"fused {fused['ms']:.3f} ms/step (window mean of {STEPS})")
    if not (d_win <= 1e-4 and dx_win <= 1e-4 * scale):
        fail("[long] windowed and fused sweeps disagree")
    if not (e_win <= 1e-2 and e_fused <= 1e-2):
        fail("[long] step 1 u0 disagrees with the CPU float64 run")
    if not (x_win <= 2e-2 * scale and x_fused <= 2e-2 * scale):
        fail("[long] step 1 plan disagrees with the CPU float64 run")
    return totals


def phase_profile(label, run, steps=3):
    """Where a step's time goes at B=B_TIME: a torch.profiler trace of a
    few chained steps, split into the port's kernels, the other kernels
    (the barrier algebra and layout glue, PyTorch's own), and the device
    idle time between them.  Profiling adds host overhead, so the idle
    share is an upper bound for the untraced run.  Returns the trace's
    sums (trace_sums)."""
    state = dict(st=run["st"])

    def steps_run():
        for _ in range(steps):
            state["st"], _ = run["step"](state["st"])

    sums = trace_sums(steps_run)
    print_trace(label, f"B={run['x0s'].shape[0]}", sums, steps, "steps")
    return sums


def trace_sums(fn):
    """A torch.profiler trace of one call of fn: (window us from the first
    kernel to the last, {port kernel: [busy us, launches]}, [busy us,
    launches] of the other kernels), or None when the profiler recorded
    no device kernel."""
    kern = traced_kernels(fn)
    if not kern:
        return None
    ours = {k: [0.0, 0] for k in KERNEL_INFO}
    other = [0.0, 0]
    # a port kernel's name, mangled or not, not the tail of a longer one
    # (condense2_kernel inside prep_condense2_kernel)
    names = "|".join(sorted(KERNEL_INFO, key=len, reverse=True))
    pattern = re.compile(r"(?<![A-Za-z_])(%s)_kernel" % names)
    for e in kern:
        found = pattern.search(e["name"])
        acc = ours[found.group(1)] if found else other
        acc[0] += e["dur"]
        acc[1] += 1
    t0 = min(e["ts"] for e in kern)
    t1 = max(e["ts"] + e["dur"] for e in kern)
    return t1 - t0, ours, other


def print_trace(label, what, sums, steps, unit="ticks"):
    """Per step or tick of a traced run (`trace_sums`) of `steps` of
    them: the window, the busy time of the port's kernels (each by name)
    and of the others, the idle share and the launches."""
    if sums is None:
        print(f"[profile] {label}: torch.profiler recorded no device "
              f"kernels: device breakdown not measured")
        return
    window_us, ours, (other, n_other) = sums
    window = window_us / steps / 1e3
    busy = (sum(v for v, _ in ours.values()) + other) / steps / 1e3
    parts = [f"{k} {v / steps / 1e3:.3f} ms ({n // steps} x "
             f"{v / n / 1e3:.3f})" for k, (v, n) in ours.items() if n]
    parts.append(f"other kernels {other / steps / 1e3:.3f} ms "
                 f"({n_other // steps} launches)")
    print(f"[profile] {label} {what}, {steps} traced {unit}, per "
          f"{unit[:-1]}: window {window:.3f} ms, kernels busy {busy:.3f} ms "
          f"(idle share {1 - busy / window:.3f}); " + ", ".join(parts))


def trace_ticks(label, what, loop, ms_tick, lo=1, hi=3):
    """Where a closed loop's tick goes, without the loop's set-up (the
    warm start's rollout, the filters): a traced call of loop(hi) ticks
    less a traced call of loop(lo), per tick: the launches and busy time
    of the port's kernels (each by name) and of the others, and the idle
    share against `ms_tick`, the untraced run's ms/tick (the traced
    windows carry the profiler's host time, which moves between calls).
    A host-bound loop leaves the card idle, so its clocks and the kernels'
    times move too: the busy time is approximate, the launches exact."""
    a, b = trace_sums(lambda: loop(lo)), trace_sums(lambda: loop(hi))
    if a is None or b is None:
        print_trace(label, what, None, hi - lo)
        return
    n = hi - lo
    ours = {k: (b[1][k][0] - a[1][k][0], b[1][k][1] - a[1][k][1])
            for k in KERNEL_INFO}
    other = (b[2][0] - a[2][0], b[2][1] - a[2][1])
    busy = (sum(v for v, _ in ours.values()) + other[0]) / n / 1e3
    parts = [f"{k} {v / n / 1e3:.3f} ms ({c // n} x {v / c / 1e3:.3f})"
             for k, (v, c) in ours.items() if c]
    parts.append(f"other kernels {other[0] / n / 1e3:.3f} ms "
                 f"({other[1] // n} launches)")
    ticks = f"tick {hi}" if n == 1 else f"ticks {lo + 1}..{hi}"
    print(f"[profile] {label} {what}, {ticks} traced (a {hi}-tick run "
          f"less a {lo}-tick one), per tick: kernels busy "
          f"{busy:.3f} ms of {ms_tick:.3f} (idle share "
          f"{1 - busy / ms_tick:.3f}); " + ", ".join(parts))


def phase_certified(device):
    """certified_config(64) on a 1.5 m step transient at B=1024."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import ipm_fast
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prepare_qp,
                                                             to_batch_last)

    B, cap, hard = 1024, 64, 32
    cfg = certified_config(capacity=cap)

    def solve(dtype, dev, x0s, config):
        x0s = x0s.to(device=dev, dtype=dtype)
        spec = default_ocp(N=N, dtype=dtype, device=dev)
        yref, yref_e = hover_yref(spec, device=dev)
        st = to_batch_last(init_rti(spec, x0s, device=dev))
        x_bl, u_bl, qp = prepare_qp(spec, st, x0s, yref, yref_e, True)
        sol = ipm_fast.solve_batched(qp, config, condense=2)
        return u_bl[0] + sol.du[0], sol.stats

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    x0s = hover_batch(spec, B, seed=7)
    # the first `hard` lanes start 1.5 m off in x (the bang-bang transient
    # of tools/bangbang_cert.py); the rest hover near the setpoint
    x0s[:hard, 0] += 1.5
    u0, stats = solve(torch.float32, device, x0s, cfg)
    esc = int(stats["escalated"])
    mask = stats["escalated_lanes"]
    lanes = mask.nonzero().squeeze(1)
    if esc <= 0 or esc != int(lanes.numel()):
        fail(f"certified path escalated {esc} lanes, reported "
             f"{int(lanes.numel())} lanes > 0")
    # lanes over the tolerance after the first 8 iterations: the escalated
    # ones plus any left over when the capacity is full
    left = (stats["mu"] > cfg.escalate_mu_tol) & ~mask
    n_left = int(left.sum())
    n_hard = int(mask[:hard].sum())
    n_hard_bad = int((mask | left)[:hard].sum())
    u0_cpu, st_cpu = solve(torch.float64, "cpu", x0s[lanes].cpu(), cfg)
    if int(st_cpu["escalated"]) <= 0:
        fail("the CPU float64 run of the escalated lanes did not escalate")
    err = float((u0[:, lanes].double().cpu() - u0_cpu).abs().max())
    mu_esc = stats["mu"][lanes]
    # escalated lanes run 32 iterations from scratch; f32 on the card vs
    # f64 on the CPU, saturated inputs included: 1e-2 kRPM (0.05% of the
    # 22 kRPM range)
    print(f"[certified] B={B}, capacity {cap}: {esc + n_left} lanes over "
          f"mu tol {cfg.escalate_mu_tol:.0e} after {cfg.iters} iterations, "
          f"escalated {esc} on the card (CPU float64: "
          f"{int(st_cpu['escalated'])}), {n_hard} of the {n_hard_bad} "
          f"1.5 m lanes over tol among them, {n_left} left unsolved "
          f"(their mu max "
          f"{float(stats['mu'][left].max()) if n_left else 0.0:.3e}); "
          f"escalated lanes' final mu max {float(mu_esc.max()):.3e}, median "
          f"{float(mu_esc.median()):.3e}; u0 vs CPU float64 max err "
          f"{err:.3e} kRPM")
    if not err <= 1e-2:
        fail("escalated lanes disagree with the CPU float64 run")

    # what the escalation costs per step (its host sync included)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
    yref, yref_e = hover_yref(spec, device=device)
    st = to_batch_last(init_rti(spec, x0s, device=device))
    ms = {name: time_events(lambda: rti_step_batched(
        spec, st, x0s, yref, yref_e, c, layout="batch_last"), 5)
        for name, c in (("iters8", IPMConfig(iters=ITERS)),
                        ("certified", cfg))}
    print(f"[certified] B={B} step, mean of 5: {ms['certified']:.3f} ms "
          f"with {esc} lanes escalated to 32 iterations, "
          f"{ms['iters8']:.3f} ms at iters=8 without escalation")


def kernel_pattern(label):
    """A regular expression that finds the CUDA function of the kernel (or
    FORMS label) `label` in a trace's kernel names, mangled or not, and not
    the tail of a longer name (condense2_kernel in prep_condense2_kernel)."""
    return r"(?<![A-Za-z_])%s_kernel" % FORMS.get(label, label)


def time_kernel(name, kern, args, reps=20):
    """(device ms, window ms) per launch over `reps` launches: the device
    time of the kernel from a profiler trace (`device_ms` on the traced
    kernels named as `kernel_pattern(name)`; None when the trace holds
    none), and the CUDA-event window around the
    launches, which holds the host's issue too (`time_events`).
    iter_sweep_c2 updates its carried inputs in place, so each of its
    launches gets a copy of its own, made before the timed window: every
    launch starts from the same iterate, as the first one does."""
    if name == "iter_sweep_c2":
        def timed(timer):
            copies = iter([fresh(args) for _ in range(reps + 1)])
            return timer(lambda: kern(*next(copies)), reps)
    else:
        def timed(timer):
            return timer(lambda: kern(*args), reps)
    window = timed(time_events)
    ms, per_call = timed(functools.partial(device_ms,
                                           kernel=kernel_pattern(name)))
    if ms is not None and per_call != 1:
        fail(f"{name}: {per_call} device kernels a launch in the trace")
    return ms, window


def phase_timing(device):
    """Per-kernel time, plain version's time and bound, float32, B=4096:
    every kernel (and FORMS) at N=50, the uncondensed ones at their
    [uncondensed] shapes; the split sweeps again at N=400, the shapes of
    the path that runs them (their row), beside the fused sweeps there.
    At N=400 each of them is also held in float32 against the plain
    version in float64 (phase_kernels holds them in float64 there)."""
    import torch

    rows = {}
    for n, names in ((N, tuple(KERNEL_INFO) + tuple(FORMS)),
                     (N_LONG, LONG_CHECKED)):
        # every bound finite, as on the main path ([0, 22] kRPM on every
        # input): iter_sweep_c2's time depends on it
        inputs = kernel_inputs(B_TIME, torch.float32, device, seed=1, n=n,
                               finite=1.0)
        for name in names:
            kern, ref, args = inputs[name]
            ms, window = time_kernel(name, kern, args)
            if ms is None:
                print(f"[timing] {name}: the trace holds no device kernels: "
                      f"device time not measured, the event window kept")
                ms = window
            if name == "iter_sweep_c2":
                mixed = kernel_inputs(B_TIME, torch.float32, device,
                                      seed=1)[name]
                mixed_ms, mixed_window = time_kernel(name, mixed[0],
                                                     mixed[2])
                print(f"[timing] iter_sweep_c2 N={n} B={B_TIME} float32, "
                      f"10% of the bounds infinite (the [kernel] check's "
                      f"inputs): {mixed_ms} ms/launch on the device (event "
                      f"window {mixed_window:.4f} ms)")
                time_iter_batches(device, args)
            want = ref(*args)
            plain_ms = time_events(lambda: ref(*args), 2)
            if n == N_LONG:
                # float32 rounding grows through the 200-stage recursion
                # (outputs reach ~3e3), in the plain version as in the
                # kernel, so two float32 evaluations in different orders
                # drift apart by more than TOL.  Both are held to the
                # exact answer for these inputs, the plain version in
                # float64: the kernel's error there may be at most 3x the
                # plain float32 version's (or TOL).
                got = flat(kern(*args))
                exact = flat(ref(*[a.double() if isinstance(a, torch.Tensor)
                                   else a for a in args]))
                _, rel_plain = compare(got, flat(want))
                _, e_kern = compare(got, exact)
                _, e_plain = compare(flat(want), exact)
                ok = e_kern <= max(TOL["float32"], 3 * e_plain)
                print(f"[kernel] {name} float32 N={n} B={B_TIME}: rel err "
                      f"vs plain float32 {rel_plain:.3e}; vs plain float64 "
                      f"on the same inputs: kernel {e_kern:.3e}, plain "
                      f"float32 {e_plain:.3e} (limit max({TOL['float32']:.0e},"
                      f" 3 x plain's)) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} float32 at N={n} is less accurate than "
                         f"its plain version")
            nbytes = bytes_of(name, args, want)
            flops = flops_of(name, B_TIME, n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_FP32_FLOPS * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            if (n == N and name in KERNEL_INFO) or name in LONG_KERNELS:
                rows[name] = dict(ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            print(f"[timing] {name} N={n} B={B_TIME} float32: {ms:.4f} "
                  f"ms/launch on the device (event window {window:.4f} ms),"
                  f" plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)")
        if n == N:
            for name in GROUP_KERNELS:
                time_group_batches(device, name, inputs)
        else:
            time_long_batches(device, inputs)
    return rows


# the kernels that give each block a tile of lanes and several threads a
# lane, timed with their forms at every B of B_MAIN
GROUP_KERNELS = ("prep_condense2", "kkt_sweep_c2", "corrector_sweep_c2",
                 "kkt_sweep", "backward_sweep", "bwd_vec_c2",
                 "forward_sweep", "corrector_sweep", "backward_vector_sweep",
                 "condense2")
# the group kernels whose grid spans the stage pairs besides the lanes
PAIR_GRID_KERNELS = ("prep_condense2", "condense2")


def group_kernel(label):
    """(launch geometry (B, dtype) -> dict, blocks per SM (dtype) -> int,
    threads a lane) of a GROUP_KERNELS or LONG_GROUP_KERNELS kernel or one
    of its FORMS."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    name = FORMS.get(label, label)
    if name in ("kkt_sweep", "backward_sweep"):
        return (rk.riccati_launch_geometry,
                functools.partial(rk.riccati_blocks_per_sm, kernel=name),
                rk.RICCATI_GROUP)
    if name == "kkt_sweep_c2":
        return ck.kkt_launch_geometry, ck.kkt_blocks_per_sm, ck.KKT_GROUP
    if name == "corrector_sweep_c2":
        return ck.corr_launch_geometry, ck.corr_blocks_per_sm, ck.CORR_GROUP
    if name == "bwd_c2":
        return ck.bwd_launch_geometry, ck.bwd_blocks_per_sm, ck.KKT_GROUP
    if name == "fwd_c2":
        return ck.fwd_launch_geometry, ck.fwd_blocks_per_sm, ck.FWD_GROUP
    if name == "bwd_vec_c2":
        return (ck.bwd_vec_launch_geometry, ck.bwd_vec_blocks_per_sm,
                ck.BWD_VEC_GROUP)
    if name == "forward_sweep":
        return (rk.forward_launch_geometry, rk.forward_blocks_per_sm,
                rk.FORWARD_GROUP)
    if name in ("corrector_sweep", "backward_vector_sweep"):
        return (rk.vector_launch_geometry,
                functools.partial(rk.vector_blocks_per_sm, kernel=name),
                rk.VECTOR_GROUP)
    if name == "condense2":
        return (ck.condense_launch_geometry, ck.condense_blocks_per_sm,
                ck.CONDENSE_THREADS // ck.CONDENSE_LANES)
    order = 2 if label.endswith("vde_order=2") else 4
    return (functools.partial(pk.prep_launch_geometry, vde_order=order),
            functools.partial(pk.prep_blocks_per_sm, vde_order=order),
            pk.PREP_THREADS // pk.PREP_LANES)


def at_lanes(args, B):
    """The tensor arguments cut or tiled along the lane (last) axis to B
    lanes, contiguous; other arguments as they are."""
    import torch

    reps = -(-B // args[0].shape[-1])
    return tuple(torch.cat([a] * reps, dim=-1)[..., :B].contiguous()
                 if isinstance(a, torch.Tensor) else a for a in args)


def time_long_batches(device, inputs):
    """K5a, K5b, K5c, K2 and K3 (LONG_GROUP_KERNELS) at N=400 in float32 at
    each B of B_MAIN (their B_TIME inputs cut or tiled along the lane axis:
    no loop of the kernels depends on the data): device time of a launch (the
    mean of 20 traced) beside the bound, with the blocks an SM holds (the
    occupancy API) and the waves each B needs.  Prints the seconds it
    took."""
    import math

    import torch

    t0 = time.perf_counter()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name in LONG_GROUP_KERNELS:
        geometry, blocks_per_sm, _ = group_kernel(name)
        bps = blocks_per_sm(torch.float32)
        kern, _, args = inputs[name]
        for B in B_MAIN:
            cut = at_lanes(args, B)
            geo = geometry(B, torch.float32)
            waves = math.ceil(geo["grid"] / (bps * sms))
            ms, _ = device_ms(lambda: kern(*cut), 20,
                              kernel=kernel_pattern(name))
            ms = f"{ms:.4f}" if ms is not None else "not measured"
            bound_ms = max(bytes_of(name, cut, kern(*cut)) / HBM_BYTES_PER_S,
                           flops_of(name, B, N_LONG) / PEAK_FP32_FLOPS) * 1e3
            print(f"[timing] {name} N={N_LONG} B={B} float32: {ms} "
                  f"ms/launch on the device, bound {bound_ms:.4f} ms, "
                  f"{geo['grid']} blocks of {geo['lanes']} lanes, {bps} "
                  f"an SM ({geo['smem']} B each), {waves} wave(s)")
    print(f"[timing] N={N_LONG} group sweeps at B="
          f"{'/'.join(map(str, B_MAIN))}: {time.perf_counter() - t0:.1f} s")


def time_iter_batches(device, args):
    """K10 at each B of B_MAIN in float32 (its B_TIME inputs, every bound
    finite, cut or tiled along the lane axis, each launch on a copy of its
    own: `time_kernel`): device time of a launch beside the bound, with
    the blocks an SM holds (the occupancy API, both dtypes) and the waves
    each B needs."""
    import math

    import torch

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    bps = {dt: ck.iter_blocks_per_sm(dt)
           for dt in (torch.float32, torch.float64)}
    print(f"[timing] iter_sweep_c2 occupancy: {bps[torch.float32]} blocks "
          f"of {ck.ITER_LANES} lanes x {ck.ITER_GROUP} threads per SM in "
          f"float32, {bps[torch.float64]} in float64")
    for B in B_MAIN:
        cut = at_lanes(args, B)
        kern = functools.partial(ck.iter_sweep_c2, scratch=ck.iter_scratch(
            M, B, torch.float32, device))
        geo = ck.iter_launch_geometry(B, torch.float32)
        waves = math.ceil(geo["grid"] / (bps[torch.float32] * sms))
        ms, window = time_kernel("iter_sweep_c2", kern, cut)
        ms = f"{ms:.4f}" if ms is not None else "not measured"
        bound_ms = max(bytes_of("iter_sweep_c2", cut, kern(*fresh(cut)))
                       / HBM_BYTES_PER_S,
                       flops_of("iter_sweep_c2", B) / PEAK_FP32_FLOPS) * 1e3
        print(f"[timing] iter_sweep_c2 N={N} B={B} float32: {ms} ms/launch "
              f"on the device (event window {window:.4f} ms), bound "
              f"{bound_ms:.4f} ms, {geo['grid']} blocks of {geo['lanes']} "
              f"lanes ({geo['smem']} B each), {waves} wave(s)")


def time_group_batches(device, name, inputs):
    """A group kernel and its forms at each B of B_MAIN in float32 (their
    B_TIME inputs cut or tiled along the lane axis: no loop of the kernels
    depends on the data): device time (the mean over 20 traced launches)
    beside the median of 3 event windows of 20 launches, and the bound at
    that B; with the occupancy of each distinct launch (blocks and lanes
    per SM from the occupancy API, both dtypes) and the waves each B
    needs."""
    import math

    import torch

    forms = (name,) + tuple(k for k, v in FORMS.items() if v == name)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = {label: group_kernel(label) for label in forms}
    bps = {}
    for label, (geometry, blocks_per_sm, group) in shapes.items():
        if name != "prep_condense2" and label != name:
            bps[label] = bps[name]      # the forms share the exact form's
            continue
        bps[label] = {dt: blocks_per_sm(dt)
                      for dt in (torch.float32, torch.float64)}
        for dt, blocks in bps[label].items():
            geo = geometry(B_TIME, dt)
            print(f"[timing] {label} occupancy {str(dt)[6:]}: {blocks} "
                  f"blocks of {geo['lanes']} lanes x {group} threads per "
                  f"SM ({geo['smem']} B of shared memory a block) -> "
                  f"{blocks * geo['lanes']} lanes per SM, "
                  f"{blocks * geo['lanes'] * sms} on {sms} SMs")
    for B in B_MAIN:
        for label in forms:
            geometry = shapes[label][0]
            geo = geometry(B, torch.float32)
            blocks = geo["grid"] * (M if name in PAIR_GRID_KERNELS else 1)
            waves = math.ceil(blocks / (bps[label][torch.float32] * sms))
            kern, _, args = inputs[label]
            cut = at_lanes(args, B)
            window = time_events(lambda: kern(*cut), 20, rounds=3)
            ms, _ = device_ms(lambda: kern(*cut), 20,
                              kernel=kernel_pattern(label))
            ms = f"{ms:.4f}" if ms is not None else "not measured"
            bound_ms = max(bytes_of(label, cut, kern(*cut))
                           / HBM_BYTES_PER_S,
                           flops_of(label, B) / PEAK_FP32_FLOPS) * 1e3
            print(f"[timing] {label} N={N} B={B} float32: {ms} ms/launch on "
                  f"the device (event window {window:.4f} ms), bound "
                  f"{bound_ms:.4f} ms, {blocks} blocks, {waves} wave(s)")


# the lanes each probe is checked at: both (8 lanes a block) also at
# B_RAGGED, on a ragged last tile (B_RAGGED + 3) and at B=1
PROBE_BATCHES = {"fma_chain": (B_CHECK, B_RAGGED, B_RAGGED + 3, 1),
                 "stage_replay": (B_CHECK, B_RAGGED, B_RAGGED + 3, 1)}


def probe_flops(name, B, reps):
    """Operations one probe launch needs (2 per multiply-add, 1 per other
    operation).  fma_chain: per product and lane 13^3 multiply-adds and
    13^2 for the scale and the added b.  stage_replay: per stage and lane
    bwd_c2's whole stage (flops_of), kff's solve included: the replay runs
    K2's group stage, whose thread 13 solves for kff beside K's
    columns."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk

    if name == "fma_chain":
        return float(2 * (2197 + 169)) * (reps // sk.UNROLL * sk.UNROLL) * B
    return flops_of("bwd_c2", 1, 2) * reps * B


def phase_roofline(device):
    """The speed-of-light study's probes and path: fma_chain and
    stage_replay against their plain versions at B=B_CHECK in float64
    and float32 (their default reps), both (a group of threads a lane, 8
    lanes a block) also at the other B of PROBE_BATCHES (a ragged last
    tile, B=1), on inputs whose output depends on every product and stage
    (probe_inputs(parity=True)): the kernel's answer must also disagree,
    beyond the same tolerance, with the plain version one group of UNROLL
    products (fma_chain) or one stage (stage_replay) short, so a wrong
    count cannot pass.  Then the study of
    roofline/ipm_iter_sol.py at N=50, B=B_TIME (its table on the lines
    above), with the launch counts read around it; then each probe's
    time, plain time and bound at the study's B.  Returns (errs, totals,
    rows) keyed as phase_kernels', drive()'s and phase_timing's."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
    from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol as sol

    kern = {"fma_chain": (sk.fma_chain, sk.fma_chain_plain),
            "stage_replay": (sk.stage_replay, sk.stage_replay_plain)}
    reps = {"fma_chain": sol.FMA_REPS, "stage_replay": sol.REPLAY_REPS}
    short = {"fma_chain": sk.UNROLL, "stage_replay": 1}
    errs = {}
    for dtype, B in itertools.product((torch.float64, torch.float32),
                                      dict.fromkeys(itertools.chain(
                                          *PROBE_BATCHES.values()))):
        dn = str(dtype).split(".")[1]
        for name, args in zip(PROBE_INFO, sol.probe_inputs(
                B, dtype, device, parity=True)):
            if B not in PROBE_BATCHES[name]:
                continue
            fn, plain = kern[name]
            before = kc.launch_counts(kc.PROBES)[name]
            got = flat(fn(*args))
            torch.cuda.synchronize()
            if kc.launch_counts(kc.PROBES)[name] != before + 1:
                fail(f"{name} did not launch its kernel once")
            abs_err, rel_err = compare(got, flat(plain(*args)))
            _, rel_short = compare(got, flat(plain(
                *args, reps=reps[name] - short[name])))
            ok = rel_err <= TOL[dn] < rel_short
            print(f"[roofline] {name} {dn} B={B}: max abs err "
                  f"{abs_err:.3e}, rel {rel_err:.3e} (tol {TOL[dn]:.0e}); "
                  f"rel {rel_short:.3e} against the plain version "
                  f"{short[name]} short of {reps[name]} (must exceed the "
                  f"tol) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dn} disagrees with its plain version, or "
                     f"the check cannot see a wrong count")
            if B == B_CHECK:
                errs[(name, dn)] = abs_err

    kc.reset_launch_counts()
    kc.reset_launch_counts(kc.PROBES)
    try:
        sol.study(B_TIME, device,
                  log=lambda line: print(f"[roofline] {line}"))
    except RuntimeError as e:
        fail(f"[roofline] {e}")
    counts = {**kc.launch_counts(), **kc.launch_counts(kc.PROBES)}
    totals = {name: counts[name] for name in PROBE_INFO}
    print("[roofline] launches in the study: " + ", ".join(
        f"{k}={v}" for k, v in counts.items() if v))
    if not all(totals.values()):
        fail("[roofline] a probe was not launched by the study")

    rows = {}
    for name, args in zip(PROBE_INFO, sol.probe_inputs(B_TIME,
                                                       torch.float32,
                                                       device)):
        fn, plain = kern[name]
        window = time_events(lambda: fn(*args), 10)
        ms, _ = device_ms(lambda: fn(*args), 10, kernel=kernel_pattern(name))
        ms = window if ms is None else ms
        plain_ms = time_events(lambda: plain(*args), 2)
        nbytes = bytes_of(name, args, fn(*args))
        flops = probe_flops(name, B_TIME, reps[name])
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        print(f"[timing] {name} B={B_TIME} float32, reps {reps[name]}: "
              f"{ms:.4f} ms/launch on the device (event window "
              f"{window:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")
    return errs, totals, rows


# ---------------------------------------------------------------------------
# the pod path (parallel/) and the certified loops
# ---------------------------------------------------------------------------

POD_B = 4096          # [pod]: [main]'s lanes at B=B_TIME
POD_TOL = 1e-6        # sharded against unsharded, the same inputs
POD_RANKS = 2         # [pod_ranks] (a): 2 ranks x 2048 lanes
# [pod_ranks] (b)-(d), tests/test_sharding.py's stage-sharded runs:
# (N, tf, dtype, ranks, block, IPM iterations, x0 position, rtol, atol);
# (d) is held against rti_step_batched(windowed=True) at B=1 (K5a/b/c)
STAGE_RUNS = {
    "b": (50, 0.75, "float64", 2, 5, 10, (0.1, -0.05, 0.3), 1e-8, 1e-9),
    "c": (400, 6.0, "float64", 4, 10, 10, (0.2, -0.1, 0.4), 1e-7, 1e-8),
    "d": (800, 12.0, "float32", 4, 10, 2, (0.2, -0.1, 0.4), 0.0, 5e-4),
}
STAGE_TIMED = 2       # timed steps of each stage-sharded run, after one
CERT_TOL = 1e-4       # every tick's u-plan against the oracle (BASELINE)
CERT_PLAIN = 1e-2     # the plain 8-iteration solve is off by more
CERT_HOVER_TICKS = 24
CERT_HELIX_TICKS = 96
CERT_BATCHED_TICKS = 5
CERT_PLAIN_TICKS = 3  # the plain solve on the hover loop's first ticks
CERT_ESCALATE = 16    # tests/test_certification.py's escalation budget
ORACLE_WORKERS = 3    # processes solving the oracle's QPs meanwhile


def check_shards(label, shards, whole, tol):
    """The ranks' shards, in rank order, put together along the lane
    (last, batch-last) axis equal the unsharded result within `tol`
    (hold_close).  Returns the largest |diff|."""
    import torch

    got = torch.cat([s.detach().double().cpu() for s in shards], dim=-1)
    return hold_close(label, got, whole, tol)


def check_replicated(label, by_rank, want, rtol, atol):
    """Every rank's copy of a replicated result within atol + rtol |want|
    of the reference, or the run fails.  Returns the largest |diff|."""
    want = want.detach().double().cpu()
    worst = 0.0
    for rank, got in enumerate(by_rank):
        got = got.detach().double().cpu()
        if got.shape != want.shape:
            fail(f"{label}: rank {rank} shape {tuple(got.shape)}, "
                 f"expected {tuple(want.shape)}")
        diff = (got - want).abs()
        if not bool((diff <= atol + rtol * want.abs()).all()):
            fail(f"{label}: rank {rank} off by {float(diff.max()):.3e} "
                 f"(rtol {rtol:g}, atol {atol:g})")
        worst = max(worst, float(diff.max()))
    return worst


def check_fleet(label, got, kkt, mu, rel=POD_TOL):
    """fleet_metrics' (max kkt_res, mean qp_mu) against amax / mean of the
    whole batch's, to `rel` relative."""
    want = (float(kkt.double().amax()), float(mu.double().mean()))
    for name, g, w in zip(("kkt_res max", "qp_mu mean"), got, want):
        if not abs(float(g) - w) <= rel * abs(w):
            fail(f"{label}: fleet {name} {float(g):.9e}, the whole batch's "
                 f"{w:.9e}")
    return want


def check_certified(label, errs, tol=CERT_TOL):
    """Every tick's max |u-plan - oracle's| below `tol` (a NaN fails);
    returns the worst."""
    bad = [(t, e) for t, e in enumerate(errs) if not e < tol]
    if bad or not errs:
        fail(f"{label}: {len(bad)} of {len(errs)} ticks not within {tol:g} "
             f"of the oracle: " + ", ".join(f"tick {t} {e:.3e}"
                                            for t, e in bad[:5]))
    return max(errs)


def phase_pod(device):
    """`parallel.pod_rti_step` on a one-rank NCCL group: N=50, B=POD_B,
    float32, IPMConfig(iters=8), [main]'s lanes, 20 chained steps
    (chain_steps, under the sync debug mode) against the unsharded
    `rti_step_batched` chain on the same inputs in this process (lanes are
    independent: equal to POD_TOL, bitwise expected), K1-K4 in its launch
    counts and in a profiler trace, and `fleet_metrics` over the group
    against amax / mean.  Returns the launch counts."""
    import tempfile

    import torch

    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.parallel import (fleet_metrics,
                                                   init_distributed,
                                                   make_mesh, pod_rti_step)
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import to_batch_last

    with tempfile.TemporaryDirectory() as tmp:
        world, _ = init_distributed(f"file://{tmp}/rendezvous", 1, 0,
                                    device=device)
        try:
            backend = torch.distributed.get_backend()
            mesh = make_mesh()
            spec = default_ocp(N=N, dtype=torch.float32, device=device)
            yref, yref_e = hover_yref(spec, device=device)
            x0s = hover_batch(spec, POD_B, seed=POD_B)
            st0 = to_batch_last(init_rti(spec, x0s, device=device))
            pod = pod_rti_step(spec, mesh, IPMConfig(iters=ITERS),
                               layout="batch_last")
            dv.reset_host_syncs()
            run = dict(x0s=x0s, st0=st0, **chain_steps(
                lambda st: pod(st, x0s, yref, yref_e), st0))
            syncs = dv.host_syncs()
            counts = check_chain("pod", run, POD_B, N, STEP_KERNELS)
            first = run["first"]
            fleet = fleet_metrics(mesh)(first.kkt_res, first.qp_mu)
            want = check_fleet("[pod]", fleet, first.kkt_res, first.qp_mu)
            sums = phase_profile("pod", run)
            missing = [k for k in STEP_KERNELS
                       if sums is None or not sums[1][k][1]]
            if missing:
                fail(f"[pod]: {missing} not in the profiler trace")
            ref = run_chain(POD_B, device)
            du = hold_close("[pod] step 1 u_plan vs unsharded", first.u_plan,
                            ref["first"].u_plan, POD_TOL)
            dx = hold_close("[pod] step 1 x_plan vs unsharded", first.x_plan,
                            ref["first"].x_plan, POD_TOL)
            dst = hold_close(f"[pod] u_traj after {STEPS} steps vs "
                             "unsharded", run["st"].u_traj,
                             ref["st"].u_traj, POD_TOL)
        finally:
            torch.distributed.destroy_process_group()
    print(f"[pod] pod_rti_step on a {world}-rank {backend} group, N={N} "
          f"B={POD_B} float32: {run['ms']:.3f} ms/step, host issue "
          f"{run['host_ms']:.3f} ms/step; the unsharded rti_step_batched "
          f"([main]'s path) in this process {ref['ms']:.3f} ms/step, host "
          f"issue {ref['host_ms']:.3f}; max |diff| vs unsharded: step 1 "
          f"u_plan {du:.3e}, x_plan {dx:.3e}, u_traj after {STEPS} steps "
          f"{dst:.3e} (bar {POD_TOL:g}); fleet_metrics over the group: "
          f"kkt_res max {float(fleet[0]):.6e} ({want[0]:.6e}), qp_mu mean "
          f"{float(fleet[1]):.6e} ({want[1]:.6e}); host syncs in the "
          f"chain {syncs or 'none'}")
    return counts


def pod_rank(rank, world, init, out):
    """One rank of [pod_ranks]' gloo group (every rank on the one card):
    (a) pod_rti_step on its 2048 of [pod]'s lanes (ranks 0-1), then the
    stage-sharded steps of STAGE_RUNS on their ranks; its results, times,
    launches and host syncs by reason go to `out`/rank<r>.pt."""
    import os

    import torch

    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.parallel import (fleet_metrics,
                                                   init_distributed,
                                                   make_mesh, pod_rti_step,
                                                   stage_sharded_rti_step)
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import to_batch_last

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(init, world, rank, backend="gloo")
    res = {}
    try:
        # every rank makes every mesh (new_group is collective)
        mesh_a = make_mesh(batch=POD_RANKS, devices=range(POD_RANKS))
        meshes = {k: make_mesh(stage=v[3], devices=range(v[3]))
                  for k, v in STAGE_RUNS.items()}
        if rank < POD_RANKS:
            spec = default_ocp(N=N, dtype=torch.float32, device=device)
            yref, yref_e = hover_yref(spec, device=device)
            x0s = mesh_a.shard(hover_batch(spec, POD_B, seed=POD_B))
            st0 = to_batch_last(init_rti(spec, x0s, device=device))
            pod = pod_rti_step(spec, mesh_a, IPMConfig(iters=ITERS),
                               layout="batch_last")
            dv.reset_host_syncs()
            run = chain_steps(lambda st: pod(st, x0s, yref, yref_e), st0)
            syncs = dv.host_syncs()
            first = run["first"]
            fleet = fleet_metrics(mesh_a)(first.kkt_res, first.qp_mu)
            res["a"] = dict(u_plan=first.u_plan.cpu(),
                            u_traj=run["st"].u_traj.cpu(),
                            fleet=[float(f) for f in fleet], ms=run["ms"],
                            host_ms=run["host_ms"], counts=run["counts"],
                            syncs=syncs,
                            fleet_syncs=dv.host_syncs())
        for key, (n, tf, dt, ranks, block, iters, pos, _,
                  _) in STAGE_RUNS.items():
            if rank >= ranks:
                continue
            dtype = getattr(torch, dt)
            spec = default_ocp(N=n, tf=tf, dtype=dtype, device=device)
            x0 = hover_state(spec.params, pos=pos, dtype=dtype,
                             device=device)
            yref, yref_e = hover_yref(spec, device=device)
            st = init_rti(spec, x0, device=device)
            cfg = IPMConfig(iters=iters)
            new, o = stage_sharded_rti_step(spec, meshes[key], block, st,
                                            x0, yref, yref_e, cfg)
            torch.cuda.synchronize()
            dv.reset_host_syncs()
            kc.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(STAGE_TIMED):
                stage_sharded_rti_step(spec, meshes[key], block, st, x0,
                                       yref, yref_e, cfg)
            torch.cuda.synchronize()
            res[key] = dict(u=new.u_traj.cpu(), x=new.x_traj.cpu(),
                            kkt=float(o.kkt_res),
                            ms=(time.perf_counter() - t0) * 1e3 / STAGE_TIMED,
                            syncs=dv.host_syncs(),
                            counts=kc.launch_counts())
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def phase_pod_ranks(device):
    """The multi-rank pod path on the one card: a gloo group of 4 ranks
    (processes) whose tensors all lie on it (NCCL refuses two ranks on
    one GPU; gloo's collectives go through pinned host buffers, each a
    counted "collective" host sync).  (a) pod_rti_step, 2 ranks x 2048
    lanes, each shard and fleet_metrics against the unsharded step on
    the whole batch; (b)-(d) stage_sharded_rti_step (STAGE_RUNS) against
    rti_step, and (d) against rti_step_batched(windowed=True) at B=1,
    which launches K5a/b/c.  Returns (a)'s launch counts."""
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti, rti_step)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched

    world = max(v[3] for v in STAGE_RUNS.values())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(pod_rank, nprocs=world, start_method="spawn",
                           args=(world, f"file://{tmp}/rendezvous", tmp))
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(world)]
    print(f"[pod_ranks] {world} gloo ranks on one card: {wall:.1f} s "
          f"(process start, CUDA and the runs)")

    # (a) against the unsharded step on the whole batch
    a = [r["a"] for r in res[:POD_RANKS]]
    ref = run_chain(POD_B, device)
    du = check_shards("[pod_ranks] (a) step 1 u_plan", [r["u_plan"] for r in a],
                      ref["first"].u_plan, POD_TOL)
    dst = check_shards(f"[pod_ranks] (a) u_traj after {STEPS} steps",
                       [r["u_traj"] for r in a], ref["st"].u_traj, POD_TOL)
    for rank, r in enumerate(a):
        check_fleet(f"[pod_ranks] (a) rank {rank}", r["fleet"],
                    ref["first"].kkt_res, ref["first"].qp_mu)
    counts = {}
    for rank, r in enumerate(a):
        per_step = check_tick_launches(f"[pod_ranks] (a) rank {rank}",
                                       r["counts"], STEPS, STEP_KERNELS)
        for k, v in r["counts"].items():
            counts[k] = counts.get(k, 0) + v
    print(f"[pod_ranks] (a) pod_rti_step, {POD_RANKS} ranks x "
          f"{POD_B // POD_RANKS} lanes, N={N} float32: ms/step "
          + " / ".join(f"{r['ms']:.3f}" for r in a) + ", host issue "
          + " / ".join(f"{r['host_ms']:.3f}" for r in a)
          + f" (the unsharded B={POD_B} step here {ref['ms']:.3f}); launches "
          f"a step a rank {per_step}; max |diff| vs unsharded: step 1 u_plan "
          f"{du:.3e}, u_traj after {STEPS} steps {dst:.3e} (bar "
          f"{POD_TOL:g}); fleet kkt_res max {a[0]['fleet'][0]:.6e}, qp_mu "
          f"mean {a[0]['fleet'][1]:.6e} on each rank; host syncs in the "
          f"chain {a[0]['syncs'] or 'none'}, with fleet_metrics "
          f"{a[0]['fleet_syncs']}")

    # (b)-(d) against the unsharded steps
    for key, (n, tf, dt, ranks, block, iters, pos, rtol,
              atol) in STAGE_RUNS.items():
        dtype = getattr(torch, dt)
        spec = default_ocp(N=n, tf=tf, dtype=dtype, device=device)
        x0 = hover_state(spec.params, pos=pos, dtype=dtype, device=device)
        yref, yref_e = hover_yref(spec, device=device)
        st = init_rti(spec, x0, device=device)
        cfg = IPMConfig(iters=iters)
        if key == "d":
            what = "rti_step_batched(windowed=True) at B=1"

            def reference():
                new, _ = rti_step_batched(
                    spec, init_rti(spec, x0[None], device=device), x0[None],
                    yref[None], yref_e[None], cfg, condense=2, windowed=True)
                return new.u_traj[0], new.x_traj[0]
        else:
            what = "rti_step"

            def reference():
                new, _ = rti_step(spec, st, x0, yref, yref_e, cfg)
                return new.u_traj, new.x_traj
        reference()                            # the first call, not timed
        torch.cuda.synchronize()
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        want_u, want_x = reference()
        torch.cuda.synchronize()
        ref_ms = (time.perf_counter() - t0) * 1e3
        ref_counts = {k: v for k, v in kc.launch_counts().items() if v}
        if key == "d" and not all(ref_counts.get(k) for k in LONG_KERNELS):
            fail(f"[pod_ranks] ({key}): the windowed step launched "
                 f"{ref_counts}, not K5a/b/c {LONG_KERNELS}")
        r = [x[key] for x in res[:ranks]]
        eu = check_replicated(f"[pod_ranks] ({key}) u_traj",
                              [x["u"] for x in r], want_u, rtol, atol)
        ex = check_replicated(f"[pod_ranks] ({key}) x_traj",
                              [x["x"] for x in r], want_x, rtol, atol)
        print(f"[pod_ranks] ({key}) stage_sharded_rti_step N={n} tf={tf} "
              f"{dt} iters={iters}, {ranks} stage ranks, block {block}: "
              f"ms/step " + " / ".join(f"{x['ms']:.1f}" for x in r)
              + f" (mean of {STAGE_TIMED}, after one); {what} here "
              f"{ref_ms:.1f} ms (its second call) with launches "
              f"{ref_counts if key == 'd' else 'not counted'}; max |diff| "
              f"u_traj {eu:.3e}, x_traj {ex:.3e} (rtol {rtol:g}, atol "
              f"{atol:g}); host syncs by reason over {STAGE_TIMED} steps, "
              f"rank 0: {r[0]['syncs']}; no port kernel launched: "
              f"{not any(r[0]['counts'].values())}")
    return counts


_ORACLE = {}


def oracle_plan(args):
    """The post-step u-plan of one RTI subproblem (x_traj, u_traj, x0,
    yref, yref_e as numpy, dt) by the numpy oracle
    tests/_reference_rti.py of this checkout (loaded once a process)."""
    if "mod" not in _ORACLE:
        import importlib.util
        import os

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "_reference_rti.py")
        spec = importlib.util.spec_from_file_location("_reference_rti", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ORACLE["mod"] = mod
    return _ORACLE["mod"].rti_step_ref(*args)[1]


def _host(*tensors):
    return tuple(t.detach().cpu().numpy() for t in tensors)


def certified_loop(spec, x_init, yref_fn, ticks, cfg, submit,
                   plain_ticks=0):
    """The single-vehicle production loop on `rti_step` (the spec's
    device) with the RK4 plant: each tick's subproblem (the same warm
    start, x0 and yref) goes to `submit` (the oracle: a value or a
    future), beside the step's post-step u-plan; on the first
    `plain_ticks` ticks the plain 8-iteration solve's plan too.  Returns
    ([(u_plan, oracle)], [(plain u_plan, oracle)], ms per tick of the
    step, the wait for its plan included)."""
    from crazyflie_nmpc_tpu_torch.models import dynamics
    from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import init_rti, rti_step

    state = init_rti(spec, x_init, device=x_init.device)
    x = x_init
    plans, plain, wall = [], [], 0.0
    for t in range(ticks):
        yref, yref_e = yref_fn(t)
        prev = state
        t0 = time.perf_counter()
        state, out = rti_step(spec, prev, x, yref, yref_e, cfg)
        u_plan = out.u_plan.cpu()
        wall += time.perf_counter() - t0
        ref = submit(_host(prev.x_traj, prev.u_traj, x, yref, yref_e)
                     + (float(spec.dt),))
        plans.append((u_plan, ref))
        if t < plain_ticks:
            _, p = rti_step(spec, prev, x, yref, yref_e,
                            IPMConfig(iters=ITERS))
            plain.append((p.u_plan.cpu(), ref))
        x = integrate(dynamics, spec.params, x, out.u0, spec.dt,
                      spec.sim_steps)
    return plans, plain, wall / ticks * 1e3


def certified_batched_loop(spec, x0s, ticks, cfg, submit):
    """The batched production path (`rti_step_batched`, batch-first) in
    closed loop from x0s (B, 13): each lane's subproblem to `submit` every
    tick.  Returns ([(u_plan, oracle)], ms per tick, launch counts,
    escalation re-solves)."""
    from crazyflie_nmpc_tpu_torch.models import dynamics
    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops import ipm_fast
    from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
    from crazyflie_nmpc_tpu_torch.solver import hover_yref, init_rti
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched

    yref, yref_e = hover_yref(spec, device=x0s.device)
    states = init_rti(spec, x0s, device=x0s.device)
    x = x0s
    plans, wall = [], 0.0
    kc.reset_launch_counts()
    ipm_fast.reset_escalation_counts()
    for _ in range(ticks):
        prev = states
        t0 = time.perf_counter()
        states, out = rti_step_batched(spec, prev, x, yref, yref_e, cfg)
        u_plan = out.u_plan.cpu()
        wall += time.perf_counter() - t0
        for b in range(x.shape[0]):
            plans.append((u_plan[b], submit(
                _host(prev.x_traj[b], prev.u_traj[b], x[b], yref, yref_e)
                + (float(spec.dt),))))
        x = integrate(dynamics, spec.params, x, out.u0, spec.dt,
                      spec.sim_steps)
    return (plans, wall / ticks * 1e3, kc.launch_counts(),
            ipm_fast.escalation_counts()["resolves"])


def plan_errors(plans):
    """max |u_plan - oracle's| of each (u_plan, oracle value or future)."""
    import numpy as np

    return [float(np.abs(u.double().numpy() - np.asarray(
        r.result() if hasattr(r, "result") else r)).max()) for u, r in plans]


def phase_certified_loops(device):
    """tests/test_certification.py's loops on the card, float64, N=50,
    every tick's post-step u-plan against the numpy oracle
    (tests/_reference_rti.py, in ORACLE_WORKERS processes while the loops
    run) to CERT_TOL: hover from 0.3 m (saturating, 24 ticks,
    IPMConfig(iters=8, escalate_iters=16)), the helix (96 ticks,
    IPMConfig(iters=8)), the batched path (5 ticks, B=3, offsets 0.3 /
    0.02 / -0.25 m, escalate_capacity=4: K1-K4); the plain 8-iteration
    solve must miss the oracle by more than CERT_PLAIN on one of the hover
    loop's first ticks.  Returns the batched loop's launch counts."""
    import concurrent.futures
    import multiprocessing
    import os

    import torch

    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import default_ocp, hover_yref
    from crazyflie_nmpc_tpu_torch.utils.trajectories import helix_trajectory

    # the oracle's dense solves run fastest on one BLAS thread a process
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    t_start = time.perf_counter()
    spec = default_ocp(dtype=torch.float64, device=device)
    yref, yref_e = hover_yref(spec, device=device)
    hover = hover_state(spec.params, dtype=torch.float64, device=device)
    table = helix_trajectory(spec.params, device=device)
    rows = torch.arange(spec.N + 1, device=device)

    def helix_window(t):
        win = table[torch.clamp(t + rows, 0, table.shape[0] - 1)]
        return win[:-1], win[-1, :13]

    x_hover = hover.clone()
    x_hover[0].fill_(0.3)
    x_batch = hover.repeat(3, 1)
    x_batch[:, 0].copy_(torch.tensor([0.3, 0.02, -0.25],
                                     dtype=torch.float64))
    ctx = multiprocessing.get_context("spawn")
    dv.reset_host_syncs()
    with concurrent.futures.ProcessPoolExecutor(ORACLE_WORKERS,
                                                mp_context=ctx) as pool:
        def submit(args):
            return pool.submit(oracle_plan, args)
        hov, plain, hov_ms = certified_loop(
            spec, x_hover, lambda t: (yref, yref_e), CERT_HOVER_TICKS,
            IPMConfig(iters=ITERS, escalate_iters=CERT_ESCALATE), submit,
            plain_ticks=CERT_PLAIN_TICKS)
        hel, _, hel_ms = certified_loop(spec, table[0, :13], helix_window,
                                        CERT_HELIX_TICKS,
                                        IPMConfig(iters=ITERS), submit)
        syncs = dv.host_syncs()
        bat, bat_ms, counts, resolves = certified_batched_loop(
            spec, x_batch, CERT_BATCHED_TICKS,
            IPMConfig(iters=ITERS, escalate_iters=CERT_ESCALATE,
                      escalate_capacity=4), submit)
        loops_s = time.perf_counter() - t_start
        errs = {"hover": plan_errors(hov), "helix": plan_errors(hel),
                "batched": plan_errors(bat)}
        plain_errs = plan_errors(plain)
    per_tick = check_step_launches("[certified_loops] batched", counts,
                                   CERT_BATCHED_TICKS, resolves,
                                   escalate=CERT_ESCALATE)
    worst = {k: check_certified(f"[certified_loops] {k}", v)
             for k, v in errs.items()}
    if not max(plain_errs) > CERT_PLAIN:
        fail(f"[certified_loops] the plain {ITERS}-iteration solve is within "
             f"{CERT_PLAIN:g} of the oracle on the hover loop's first "
             f"{CERT_PLAIN_TICKS} ticks ({plain_errs}): the bar would not "
             f"see a wrong plan")
    t_plain = plain_errs.index(max(plain_errs))
    print(f"[certified_loops] float64 N={N}, every tick's post-step u-plan "
          f"vs the numpy oracle (bar {CERT_TOL:g} kRPM): hover from 0.3 m "
          f"{CERT_HOVER_TICKS} ticks worst {worst['hover']:.3e} "
          f"({hov_ms:.1f} ms/tick, iters={ITERS} + escalation to "
          f"{CERT_ESCALATE}); helix {CERT_HELIX_TICKS} ticks worst "
          f"{worst['helix']:.3e} ({hel_ms:.1f} ms/tick); batched B=3 "
          f"{CERT_BATCHED_TICKS} ticks worst {worst['batched']:.3e} "
          f"({bat_ms:.1f} ms/tick, {resolves} escalation re-solves, "
          f"launches a tick {per_tick}); the plain {ITERS}-iteration solve "
          f"off by {max(plain_errs):.3e} on hover tick {t_plain} (of "
          f"{['%.1e' % e for e in plain_errs]}); host syncs of the two "
          f"single loops {syncs}; {loops_s:.1f} s with the oracle in "
          f"{ORACLE_WORKERS} processes")
    return counts


# ---------------------------------------------------------------------------
# the associative-scan Riccati, the launch layer and the last modules
# ---------------------------------------------------------------------------

PSCAN_PARITY_N = (50, 200)
# tools/pscan_crossover.py's horizons but its 3200 (the sequential solve
# takes 4.7 s a call there: cut for the script's time limit)
PSCAN_N = (50, 200, 800)
PSCAN_REPS = 5
# tests/test_riccati.py's bars: the solve to rtol 1e-8 / atol 1e-9, the
# factors' P to 1e-9 and K to rtol 1e-8 / atol 1e-9
PSCAN_BARS = {"dx": (1e-8, 1e-9), "du": (1e-8, 1e-9), "P": (0.0, 1e-9),
              "K": (1e-8, 1e-9)}
SYNC_MESSAGE = "synchroniz"         # in the error the sync debug mode raises


def pscan_lq(N, dtype, device, nx=13, nu=4, seed=0):
    """tools/pscan_crossover.py's LQ at horizon N (nx=13, nu=4: A near
    0.5 I, diagonal positive costs, S = 0, p_term = 0), drawn in float64
    on the CPU from a seeded torch.Generator, then cast and moved."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    def u(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64)

    lq = dict(A=0.9 * n(N, nx, nx) / math.sqrt(nx)
              + 0.5 * torch.eye(nx, dtype=torch.float64),
              B=n(N, nx, nu), c=0.1 * n(N, nx),
              Qxx=torch.diag_embed(0.2 + u(N, nx)), qx=n(N, nx),
              Ruu=torch.diag_embed(0.2 + u(N, nu)), ru=n(N, nu),
              S=torch.zeros(N, nu, nx, dtype=torch.float64),
              P_term=torch.diag(0.2 + u(nx)),
              p_term=torch.zeros(nx, dtype=torch.float64), dx0=n(nx))
    return {k: v.to(device=device, dtype=dtype) for k, v in lq.items()}


def check_pscan(label, got, want):
    """Each named output within its bar of PSCAN_BARS (|got - want| <=
    atol + rtol |want|, as numpy's allclose), or the run fails.  Returns
    the max |diff| of each."""
    import torch

    errs = {}
    for name, g in got.items():
        w = want[name].detach().double().cpu()
        g = g.detach().double().cpu()
        rtol, atol = PSCAN_BARS[name]
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            fail(f"{label}: {name} shape {tuple(g.shape)} (expected "
                 f"{tuple(w.shape)}) or non-finite")
        excess = float(((g - w).abs() - rtol * w.abs()).max())
        errs[name] = float((g - w).abs().max())
        if not excess <= atol:
            fail(f"{label}: {name} off by {errs[name]:.3e}, above "
                 f"{atol:g} + {rtol:g} |ref|")
    return errs


def run_without_sync(label, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): a wait on the
    card inside it fails the run."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        if SYNC_MESSAGE in str(e):
            fail(f"{label}: waits on the card ({e})")
        raise
    finally:
        torch.cuda.set_sync_debug_mode(0)


def pscan_parity(N, device):
    """The float64 parity of [pscan] at horizon N: (solve_lq_pscan on the
    card vs the port's sequential solve_lq on the card, vs its own CPU
    run; factors_pscan vs factorize on the card), the pscan calls under
    the sync debug mode.  Returns {what: max |diff| by output}."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import riccati
    from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as rp

    label = f"[pscan] N={N} float64"
    lq = pscan_lq(N, torch.float64, device)
    cpu = {k: v.cpu() for k, v in lq.items()}
    fac = [lq[k] for k in ("A", "B", "Qxx", "Ruu", "S", "P_term")]
    dx, du = run_without_sync(label, lambda: rp.solve_lq_pscan(**lq))
    fr = run_without_sync(label, lambda: rp.factors_pscan(*fac))
    dx_seq, du_seq = riccati.solve_lq(**lq)
    dx_cpu, du_cpu = rp.solve_lq_pscan(**cpu)
    fr_seq = riccati.factorize(*fac)
    return {
        "vs sequential": check_pscan(f"{label} vs sequential",
                                     dict(dx=dx, du=du),
                                     dict(dx=dx_seq, du=du_seq)),
        "vs CPU": check_pscan(f"{label} vs its CPU run", dict(dx=dx, du=du),
                              dict(dx=dx_cpu, du=du_cpu)),
        "factors": check_pscan(f"{label} factors_pscan vs factorize",
                               dict(P=fr.P, K=fr.K),
                               dict(P=fr_seq.P, K=fr_seq.K)),
    }


def time_calls(fn, reps=PSCAN_REPS):
    """(median CUDA-event ms, median host issue ms) of `reps` single
    calls of fn after one untimed call, each call timed alone on an idle
    card."""
    import statistics

    import torch

    fn()
    ms, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        fn()
        ev1.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
    return statistics.median(ms), statistics.median(host)


def phase_pscan(device):
    """ops/riccati_pscan.py on the card: the float64 parity at N=50 and
    200 (pscan_parity, tests/test_riccati.py's bars, no host sync), then
    the crossover at B=1 in float32, N = 50 / 200 / 800: pscan's
    solve_lq_pscan against the sequential solve_lq, each call's
    CUDA-event ms and host issue ms (median of 5), its launches (a
    torch.profiler trace of one call) and its max |du| from the float64
    sequential answer.  No bar on the times: they are reported."""
    import math

    import torch

    from crazyflie_nmpc_tpu_torch.ops import riccati
    from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as rp

    for N in PSCAN_PARITY_N:
        errs = pscan_parity(N, device)
        print(f"[pscan] N={N} float64, nx=13 nu=4, no host sync: "
              + "; ".join(f"{k} " + ", ".join(f"max |d{n}| {v:.3e}"
                                              for n, v in e.items())
                          for k, e in errs.items()))
    rows = []
    for N in PSCAN_N:
        lq = pscan_lq(N, torch.float32, device)
        _, du64 = riccati.solve_lq(**pscan_lq(N, torch.float64, device))
        row = {"N": N}
        for name, fn in (("seq", riccati.solve_lq),
                         ("pscan", rp.solve_lq_pscan)):
            ms, host = time_calls(lambda: fn(**lq))
            out = {}

            def traced():
                out["du"] = fn(**lq)[1]

            launches = len(traced_kernels(traced))
            gap = float((out["du"].double() - du64).abs().max())
            if not math.isfinite(gap):
                fail(f"[pscan] N={N} float32 {name}: non-finite du")
            row[name] = dict(ms=ms, host=host, launches=launches, gap=gap)
        rows.append(row)
    print("[pscan] crossover, B=1 float32 (CUDA-event ms and host issue ms "
          "of one call, median of 5; launches a call; max |du| from the "
          "float64 sequential solve):")
    print("[pscan]      N | seq ms | seq host | seq launches | seq |du| "
          "| pscan ms | pscan host | pscan launches | pscan |du| | "
          "seq/pscan")
    for r in rows:
        s, p = r["seq"], r["pscan"]
        print(f"[pscan] {r['N']:6d} | {s['ms']:.3f} | {s['host']:.3f} | "
              f"{s['launches']} | {s['gap']:.3e} | {p['ms']:.3f} | "
              f"{p['host']:.3f} | {p['launches']} | {p['gap']:.3e} | "
              f"{s['ms'] / p['ms']:.2f}x")
    return rows


BRINGUP_PREDICTOR_TICKS = 30
BRINGUP_PREDICTOR_TOL = 1e-6     # m, x of the card's float64 vs the CPU's
BRINGUP_BENCH_TICKS = 60
BRINGUP_ANGLE_TOL = 1e-3         # deg, the card's cmd_vel vs the CPU's
BRINGUP_PWM_TOL = 1
BRINGUP_SWARM_N = 4
BRINGUP_SWARM_TICKS = 60
BRINGUP_FLY_STEPS = 20
BAG_RATE_HZ = 1 / 0.015          # the bench's bag: one event a 15 ms stage


def check_session(label, out, healthy, crashed=()):
    """Every pane of `healthy` returned a result and every pane of
    `crashed` an exception (a crashed pane isolated, tmux semantics), or
    the run fails."""
    if set(out) != set(healthy) | set(crashed):
        fail(f"{label}: panes {sorted(out)}, expected "
             f"{sorted(set(healthy) | set(crashed))}")
    for pane in healthy:
        if isinstance(out[pane], BaseException):
            fail(f"{label}: pane {pane} crashed: {out[pane]!r}")
    for pane in crashed:
        if not isinstance(out[pane], BaseException):
            fail(f"{label}: pane {pane} should have crashed and reported "
                 f"{type(out[pane]).__name__}")


def check_bars(label, bars):
    """bars: {what: passed}; the run fails on the first that did not."""
    for what, ok in bars.items():
        if not ok:
            fail(f"{label}: {what}")


def bench_bars(out, steps):
    """tests/test_bringup.py's bars of the attitude bench and its bag."""
    import numpy as np

    cmd = out["cmd_vel"]
    return {f"cmd_vel shape {cmd.shape}": cmd.shape == (steps, 4),
            f"mocap published {out['mocap_published']} of {steps}":
                out["mocap_published"] == steps,
            "no setpoint reached the vehicle":
                out["device_setpoint"] is not None,
            f"final roll/pitch {cmd[-1, :2]} deg (bar 1)":
                bool(np.abs(cmd[-1, :2]).max() < 1.0),
            f"final PWM {cmd[-1, 3]} (bar 30000-60000)":
                30000 < cmd[-1, 3] < 60000}


def wire_composition_bars(name, out):
    """tests/test_bringup.py's bars of a host-side composition."""
    import numpy as np

    if name == "system_identification":
        meas = out["measurements"]
        return {f"rows {out['rows']} (bar 60)": out["rows"] >= 60,
                f"measurements {meas.shape}": meas.shape[1:] == (13,),
                "qw off 1": abs(meas[-1, 3] - 1.0) < 0.05,
                "non-finite measurements": bool(np.isfinite(meas).all())}
    if name == "thrust_identification":
        want = (12000 * 0.2685 + 4070.3) / 1000.0
        return {f"rows {out['rows']} (bar 10)": out["rows"] >= 10,
                "motor PWM echo not 12000":
                    bool(np.allclose(out["motor_pwm"], 12000.0)),
                f"implied kRPM {out['implied_krpm']}":
                    abs(out["implied_krpm"] / want - 1) < 1e-6}
    if name == "high_level_mission":
        cmds = [c["cmd"] for c in out["hl_commands"]]
        err = out["max_tracking_err_m"]
        pos = out["final_pos"]
        return {f"commands {cmds}": cmds[:1] == ["define_trajectory"] and [
                    c for c in cmds if c != "define_trajectory"][:4] == [
                    "takeoff", "start_trajectory", "land", "stop"],
                "wire": out["wire_ok"],
                f"params {out['params']}": out["params"] == {
                    "commander/enHighLevel": 1, "stabilizer/estimator": 2,
                    "stabilizer/controller": 2,
                    "kalman/resetEstimation": 1},
                f"flown ticks {out['flown_ticks']}":
                    out["flown_ticks"] > 400,
                f"tracking error {err} m (bar 0.15)":
                    err is not None and err < 0.15,
                f"landed {out['landed']} at {pos}": out["landed"]
                    and abs(pos[2]) < 0.08 and abs(pos[0]) < 0.1
                    and abs(pos[1]) < 0.1}
    if name in ("hover_demo", "position_demo"):
        sp = out["final_setpoint"]
        bars = {f"final setpoint {sp}": bool(sp) and sp["type"] == "stop"}
        if name == "position_demo":
            bars[f"setpoints sent {out['setpoints_sent']}"] = \
                out["setpoints_sent"] > 30
        return bars
    if name == "multi_hover":
        return {"not landed": out["vehicles"] == 2 and out["landed"],
                "a vehicle got nothing":
                    all(s["sent"] > 0 for s in out["stats"])}
    if name == "teleop":
        sp = out["device_setpoint"]
        return {f"device setpoint {sp}": sp is not None
                and abs(sp[0] - 3.0) < 1e-5 and abs(sp[1] + 3.0) < 1e-5
                and sp[3] == 36000}
    if name == "telemetry":
        return {f"records {out['records']}": bool(out["records"])}
    raise ValueError(name)


WIRE_COMPOSITIONS = (
    ("system_identification", dict(steps=60, port=0)),
    ("thrust_identification", dict(steps=30, port=0, thrust_pwm=12000)),
    ("high_level_mission", dict(port=0)),
    ("hover_demo", dict(port=0)),
    ("position_demo", dict(port=0)),
    ("multi_hover", dict(n=2, base_port=0)),
    ("teleop", dict(ticks=30, port=0)),
    ("telemetry", dict(seconds=1.2, port=0)),
)


def cpu_reference(job):
    """One [bringup] composition (name, kwargs) run on the CPU, in a
    worker process while the card runs it: what the card's run is held
    against, as numpy arrays and numbers."""
    import torch

    from crazyflie_nmpc_tpu_torch import bringup

    torch.set_num_threads(1)        # small problems: one thread is fastest
    name, kw = job
    out = bringup.BRINGUPS[name](device="cpu", **kw)
    if name == "nmpc_predictor":
        return {"x": out["result"].x.numpy(),
                "tracking_err_max": out["tracking_err_max"]}
    if name == "nmpc_attitude_bench":
        return {"cmd_vel": out["cmd_vel"]}
    return {"steps": out["steps"], "final_z": out["final_z"]}


def captured(fn):
    """(fn()'s return value, what it printed)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


def phase_bringup(device):
    """The launch layer on the card (`bringup`, `tools`), every UDP port
    0: nmpc_predictor under both actuations (BRINGUP_PREDICTOR_TICKS
    ticks, N=50, float64) and nmpc_attitude_bench (BRINGUP_BENCH_TICKS
    ticks, float32, its bag replayed by bag_play), each held against the
    port's CPU run of the same call; pid_waypoints at its 4000-tick cap
    (its steps equal to the CPU run's); the host-side compositions
    (WIRE_COMPOSITIONS) at test_bringup.py's bars; a session of a
    swarm_serving pane (BRINGUP_SWARM_N vehicles, BRINGUP_SWARM_TICKS
    ticks on the card, the JAX lane bars; its launches counted under the
    sync debug mode) beside telemetry and teleop panes, then a session
    whose crashing bag_play pane is isolated; the tools (fly on the card,
    toc / imu / scan against a simulator, bag info / plot on the bench's
    bag) and `python -m crazyflie_nmpc_tpu_torch.bringup teleop` as a
    subprocess.  Returns the swarm pane's launch counts."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp()
    # the CPU runs the card's runs are held against, in one worker process
    # while the card runs (after the card's runs they would lengthen the
    # group, the tail's longest, by their own time)
    jobs = {act: ("nmpc_predictor", dict(steps=BRINGUP_PREDICTOR_TICKS,
                                         actuation=act))
            for act in ("cmd_vel", "rotor")}
    jobs["bench"] = ("nmpc_attitude_bench",
                     dict(steps=BRINGUP_BENCH_TICKS, port=0))
    jobs["pid"] = ("pid_waypoints", {})
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    with pool:
        refs = {k: pool.submit(cpu_reference, job) for k, job in jobs.items()}
        counts = bringup_on_card(device, tmp, refs)
    print(f"[bringup] took {time.perf_counter() - t_start:.1f} s")
    return counts


def bringup_on_card(device, tmp, refs):
    """phase_bringup's runs on the card, each held against its CPU run
    (refs: futures of cpu_reference) where it has one."""
    import os

    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch import bringup, native, tools
    from crazyflie_nmpc_tpu_torch import device as dv
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    for act in ("cmd_vel", "rotor"):
        label = f"[bringup] nmpc_predictor {act}"
        t0 = time.perf_counter()
        out = bringup.nmpc_predictor(steps=BRINGUP_PREDICTOR_TICKS,
                                     actuation=act, device=device)
        wall = time.perf_counter() - t0
        ref = refs[act].result()
        dx = hold_close(f"{label} x vs CPU float64", out["result"].x,
                        torch.as_tensor(ref["x"]), BRINGUP_PREDICTOR_TOL)
        print(f"{label}: {BRINGUP_PREDICTOR_TICKS} ticks N={N} float64 in "
              f"{wall:.1f} s ({1e3 * wall / BRINGUP_PREDICTOR_TICKS:.1f} "
              f"ms/tick); tracking error max "
              f"{out['tracking_err_max']:.4e} m (CPU "
              f"{ref['tracking_err_max']:.4e}); max |dx| vs the CPU run "
              f"{dx:.3e} m (bar {BRINGUP_PREDICTOR_TOL:g})")

    label = "[bringup] nmpc_attitude_bench"
    bag = os.path.join(tmp, "afl.bag")
    dv.reset_host_syncs()
    t0 = time.perf_counter()
    out = bringup.nmpc_attitude_bench(steps=BRINGUP_BENCH_TICKS, port=0,
                                      bag_path=bag, device=device)
    wall = time.perf_counter() - t0
    syncs = dv.host_syncs()
    ref = refs["bench"].result()
    check_bars(label, bench_bars(out, BRINGUP_BENCH_TICKS))
    check_host_syncs(label, syncs, {"emit": BRINGUP_BENCH_TICKS})
    got, want = (torch.as_tensor(o["cmd_vel"]) for o in (out, ref))
    dang = hold_close(f"{label} cmd_vel angles vs CPU", got[:, :3],
                      want[:, :3], BRINGUP_ANGLE_TOL)
    dpwm = hold_close(f"{label} PWM vs CPU", got[:, 3], want[:, 3],
                      BRINGUP_PWM_TOL)
    played = bringup.bag_play(bag)
    rate = played["summary"]["cmd_vel"]["rate_hz"]
    check_bars(f"{label} bag_play", {
        f"events replayed {played['events_replayed']}":
            played["events_replayed"] == BRINGUP_BENCH_TICKS,
        f"rate {rate} Hz": abs(rate - BAG_RATE_HZ) < 1.0})
    print(f"{label}: {BRINGUP_BENCH_TICKS} ticks N={N} float32 in "
          f"{wall:.1f} s ({1e3 * wall / BRINGUP_BENCH_TICKS:.1f} ms/tick, "
          f"the wire included); final cmd_vel {out['cmd_vel'][-1].tolist()}"
          f"; vs the CPU run: angles {dang:.3e} deg (bar "
          f"{BRINGUP_ANGLE_TOL:g}), PWM {dpwm:g} (bar {BRINGUP_PWM_TOL}); "
          f"host syncs {syncs}; bag_play replayed "
          f"{played['events_replayed']} events at {rate:.2f} Hz")

    label = "[bringup] pid_waypoints"
    dv.reset_host_syncs()
    t0 = time.perf_counter()
    out = bringup.pid_waypoints(device=device)
    wall = time.perf_counter() - t0
    syncs = dv.host_syncs()
    ref = refs["pid"].result()
    check_bars(label, {
        f"not completed: {out}": out["completed"],
        f"reached {out['waypoints_reached']} of {out['n_goals']}":
            out["waypoints_reached"] == out["n_goals"],
        f"final z {out['final_z']}": out["final_z"] > 0.4,
        f"{out['steps']} steps, the CPU run {ref['steps']}":
            out["steps"] == ref["steps"]})
    check_host_syncs(label, syncs, {"pose": out["steps"] + 1})
    print(f"{label}: {out['steps']} ticks float32 in {wall:.2f} s "
          f"({1e3 * wall / out['steps']:.3f} ms/tick, one pose read back a "
          f"tick), final z {out['final_z']:.4f} m (CPU "
          f"{ref['final_z']:.4f}); host syncs {syncs}")

    for name, kw in WIRE_COMPOSITIONS:
        t0 = time.perf_counter()
        if name == "system_identification":
            kw = dict(kw, device=device)
        out = bringup.BRINGUPS[name](**kw)
        check_bars(f"[bringup] {name}", wire_composition_bars(name, out))
        print(f"[bringup] {name}: bars met in "
              f"{time.perf_counter() - t0:.2f} s")

    label = "[bringup] session"
    # the spec is made before the sync debug mode is set: its weights
    # are copied from the host
    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    panes = {"swarm": ("swarm_serving", BRINGUP_SWARM_N,
                       BRINGUP_SWARM_TICKS, 0, SERVE_RATE, 0.6, 0.4, True,
                       None, device, spec),
             "telemetry": ("telemetry", 2.0, 0),
             "teleop": ("teleop", 50, 0)}
    out, wall, counts, syncs, esc = counted(lambda: bringup.session(panes))
    check_session(label, out, healthy=panes)
    steps = BRINGUP_SWARM_TICKS + 1             # and the warm-up step
    per_tick = check_step_launches(f"{label} swarm pane", counts, steps,
                                   esc["resolves"])
    check_host_syncs(f"{label} swarm pane", syncs, {
        "emit": steps, "escalation": steps, "graph capture": 1})
    rep = out["swarm"]["report"]
    gap, fresh = wire_bars(f"{label} swarm pane", rep, BRINGUP_SWARM_N)
    s = rep.summary()
    print(f"{label}: swarm_serving {BRINGUP_SWARM_N} vehicles "
          f"{BRINGUP_SWARM_TICKS} ticks beside telemetry "
          f"({sum(out['telemetry']['records'].values())} records) and "
          f"teleop, {wall:.1f} s; final error max {s['final_err_max_m']:.3e}"
          f" m (bar {WIRE_FINAL_ERR}), slots >= {gap:.3f} m apart, fresh "
          f"rows on {fresh:.4f}; escalation re-solves {esc['resolves']}; "
          f"launches per tick "
          + ", ".join(f"{k}={v:g}" for k, v in per_tick.items()))
    crash = bringup.session({"bad": ("bag_play", "/nonexistent/no.bag"),
                             "ok": ("teleop", 10, 0)})
    check_session(f"{label} with a crashing pane", crash, healthy=("ok",),
                  crashed=("bad",))
    check_bars(f"{label} with a crashing pane", {
        "the teleop pane set nothing":
            crash["ok"]["device_setpoint"] is not None})
    print(f"{label}: the crashing bag_play pane isolated "
          f"({type(crash['bad']).__name__}), the teleop pane's setpoint "
          f"{crash['ok']['device_setpoint']}")

    label = "[bringup] tools"
    flight = os.path.join(tmp, "flight.txt")
    t0 = time.perf_counter()
    rc, text = captured(lambda: tools.main([
        "fly", "--traj", "hover", "--steps", str(BRINGUP_FLY_STEPS),
        "--device", str(device), "--out", flight]))
    wall = time.perf_counter() - t0
    table = np.loadtxt(flight)
    check_bars(f"{label} fly", {
        f"exit {rc}": rc == 0,
        f"flight file {table.shape}": table.shape == (BRINGUP_FLY_STEPS,
                                                      17),
        "non-finite flight": bool(np.isfinite(table).all()),
        f"not on the card: {text}": f"on {device}" in text})
    state = {"gyro.x": 1.0, "gyro.y": 2.0, "gyro.z": 3.0, "acc.z": 1.0}
    with native.FirmwareSim(0, state_provider=lambda n: state.get(
            n, 0.0)).serve() as fw:
        peer = ["--peer-port", str(fw.port), "--local-port", "0"]
        _, toc = captured(lambda: tools.main(["toc"] + peer))
        _, imu = captured(lambda: tools.main(["imu"] + peer + [
            "--duration", "0.5"]))
        _, scan = captured(lambda: tools.main([
            "scan", "--ports", f"{fw.port}-{fw.port}"]))
    _, info = captured(lambda: tools.main(["bag", "info", bag]))
    _, plot = captured(lambda: tools.main(["bag", "plot", bag, "--channel",
                                           "cmd_vel", "--col", "3"]))
    sub = subprocess.run(
        [sys.executable, "-m", "crazyflie_nmpc_tpu_torch.bringup", "teleop"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check_bars(label, {
        "toc lists no commander/enHighLevel": "commander/enHighLevel" in toc,
        "imu printed no gyro": "gyro [deg/s]" in imu and "+3.000" in imu,
        "scan found no vehicle": f"udp://127.0.0.1:{fw.port}" in scan,
        "bag info lists no cmd_vel": "cmd_vel" in info,
        "bag plot drew nothing": plot.startswith("cmd_vel"),
        f"bringup teleop subprocess exit {sub.returncode}: "
        f"{sub.stderr[-300:]}": sub.returncode == 0
        and "device_setpoint: (" in sub.stdout})
    print(f"{label}: fly --traj hover --steps {BRINGUP_FLY_STEPS} on "
          f"{device} in {wall:.1f} s ({table.shape[1]}-column file); toc "
          f"{toc.count(chr(10))} lines, imu {imu.count('gyro')} samples, "
          f"scan, bag info / plot; `python -m "
          f"crazyflie_nmpc_tpu_torch.bringup teleop` exit 0")
    return counts


COUNTS = "[counts] "    # a child's launch counts, one JSON line a phase


def child_counts(text):
    """The launch counts a child's output reports (its COUNTS lines),
    summed."""
    totals = {}
    for line in text.splitlines():
        if line.startswith(COUNTS):
            for name, v in json.loads(line[len(COUNTS):]).items():
                totals[name] = totals.get(name, 0) + v
    return totals


def run_concurrent(groups):
    """Each group of phases in a child process of this script (`--phases
    a,b --child`), the groups all started together, their output (to
    temporary files) printed group by group once every child has ended;
    fails if a child failed.  Every child is ended before this returns.
    Returns the kernel launches the children's paths counted (their
    `[counts]` lines), summed."""
    import tempfile

    procs = []
    try:
        for group in groups:
            out = tempfile.TemporaryFile(mode="w+")
            procs.append((group, out, subprocess.Popen(
                [sys.executable, __file__, "--phases", ",".join(group),
                 "--child"], stdout=out, stderr=subprocess.STDOUT,
                text=True)))
        for _, _, proc in procs:
            proc.wait()
    finally:
        for _, out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed, totals = [], {}
    for group, out, proc in procs:
        out.seek(0)
        text = out.read()
        print(text, end="", flush=True)
        out.close()
        if proc.returncode != 0:
            failed.append(f"{','.join(group)} (exit {proc.returncode})")
        for name, v in child_counts(text).items():
            totals[name] = totals.get(name, 0) + v
    if failed:
        fail(f"concurrent phases failed: {'; '.join(failed)}")
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset (the ok line needs all)")
    ap.add_argument("--child", action="store_true",
                    help="run the phases here, in sequence, and print no "
                         "summary (run_concurrent's children)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t_start = time.perf_counter()

    def mark(phase):
        print(f"[phase] {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
    errs, totals, timing = {}, {}, {}
    main_runs, fused_runs, unc_runs, unf_runs = {}, {}, {}, {}
    split_runs, gondzio_runs, thr_runs = {}, {}, {}
    roofline_rows, xla_runs = {}, {}
    if "build" in phases:
        mark("build")
        phase_build()
    if "kernels" in phases:
        mark("kernels")
        errs = phase_kernels(device)
    if "main" in phases:
        mark("main")
        main_totals, main_runs = phase_main(device)
        totals.update({k: v for k, v in main_totals.items()
                       if k in ("prep_condense2", "kkt_sweep_c2",
                                "corrector_sweep_c2", "expand2")})
    if "fused_iter" in phases:
        mark("fused_iter")
        fused_totals, fused_runs = phase_fused_iter(device, main_runs)
        totals["iter_sweep_c2"] = fused_totals["iter_sweep_c2"]
    if "long" in phases:
        mark("long")
        long_totals = phase_long(device)
        totals.update({k: long_totals[k] for k in LONG_KERNELS})
    if "uncondensed" in phases:
        mark("uncondensed")
        unc_totals, unc_runs = phase_uncondensed(device, main_runs)
        totals.update({k: unc_totals[k] for k in UNCONDENSED_KERNELS
                       if k not in SPLIT_KERNELS})
    if "unfused_prep" in phases:
        mark("unfused_prep")
        unf_totals, unf_runs = phase_unfused_prep(device)
        totals["prep_sweep"] = (totals.get("prep_sweep", 0)
                                + unf_totals["prep_sweep"])
        totals["condense2"] = unf_totals["condense2"]
    if "split" in phases:
        mark("split")
        split_totals, split_runs = phase_split(device, unc_runs)
        totals.update({k: split_totals[k] for k in SPLIT_KERNELS})
    if "gondzio" in phases:
        mark("gondzio")
        _, gondzio_runs = phase_gondzio(device)
        compare_paths("gondzio", gondzio_runs[N], main_runs.get(B_TIME),
                      "[main]")
        compare_paths("gondzio", gondzio_runs[N_ODD], unc_runs.get(B_TIME),
                      "[uncondensed] N=50")
    if "throughput_mode" in phases:
        mark("throughput_mode")
        _, thr_runs = phase_throughput_mode(device)
        compare_paths("throughput_mode", thr_runs[B_TIME],
                      main_runs.get(B_TIME), "[main]")
    if "xla_prep" in phases:
        mark("xla_prep")
        _, xla_runs = phase_xla_prep(device, main_runs)
    if "single" in phases:
        mark("single")
        phase_single(device)
    if "roofline" in phases:
        mark("roofline")
        r_errs, r_totals, r_rows = phase_roofline(device)
        errs.update(r_errs)
        totals.update(r_totals)
        roofline_rows = r_rows
    if "certified" in phases:
        mark("certified")
        phase_certified(device)
    if "timing" in phases:
        mark("timing")
        timing = phase_timing(device)
        for B in B_MAIN:
            if B != B_TIME and B in main_runs:
                phase_profile("main", main_runs[B])
        for label, run in (("main", main_runs.get(B_TIME)),
                           ("fused_iter", fused_runs.get(B_TIME)),
                           ("uncondensed", unc_runs.get(B_TIME)),
                           ("unfused_prep", unf_runs.get(B_TIME)),
                           ("split", split_runs.get(N)),
                           ("gondzio", gondzio_runs.get(N)),
                           ("throughput_mode", thr_runs.get(B_TIME)),
                           ("xla_prep", xla_runs.get(B_TIME))):
            if run is not None:
                phase_profile(label, run)
    if "pscan" in phases:
        mark("pscan")
        phase_pscan(device)
    # the closed loops last: their traces (10^5 kernels each) left the
    # profiler's later short traces empty in one run (PERF.md, PR 10)
    if "swarm" in phases:
        mark("swarm")
        for name, v in phase_swarm(device).items():
            totals[name] = totals.get(name, 0) + v
    for phase, run in (("serving", phase_serving),
                       ("swarm_wire", phase_swarm_wire)):
        if phase in phases:
            mark(phase)
            for name, v in run(device).items():
                totals[name] = totals.get(name, 0) + v
    tail = {"tuning": phase_tuning, "tuning_adam": phase_tuning_adam,
            "tuning_wide": phase_tuning_wide,
            "cartpole": phase_cartpole, "client": phase_client,
            "closed_loop": phase_closed_loop, "flight": phase_flight,
            "pod": phase_pod, "pod_ranks": phase_pod_ranks,
            "certified_loops": phase_certified_loops,
            "bringup": phase_bringup}
    if args.child:
        for phase in phases:
            t0 = time.perf_counter()
            counts = tail[phase](device)
            if isinstance(counts, dict):
                print(COUNTS + json.dumps(counts))
            print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s")
        return 0
    # the pod path in a process of its own: its NCCL group ends with it
    if "pod" in phases:
        mark("pod")
        for name, v in run_concurrent([("pod",)]).items():
            totals[name] = totals.get(name, 0) + v
    groups = [[p for p in g if p in phases] for g in CONCURRENT]
    if any(groups):
        t0 = time.perf_counter()
        for name, v in run_concurrent([g for g in groups if g]).items():
            totals[name] = totals.get(name, 0) + v
        print(f"[phase] {','.join(p for g in groups for p in g)} at once: "
              f"{time.perf_counter() - t0:.1f} s")
    timing.update(roofline_rows)
    print(f"[done] phases {','.join(phases)} in "
          f"{time.perf_counter() - t_start:.1f} s")

    print(smi)
    if set(phases) != set(PHASES):
        print("chip_smoke: partial run (--phases); no result line")
        return 0
    kernels = []
    for name, info in {**KERNEL_INFO, **PROBE_INFO}.items():
        if totals.get(name, 0) <= 0:
            fail(f"{name} was not launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=totals[name],
            max_abs_err=errs[(name, "float32")],
            ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"],
            bound_ms=timing[name]["bound_ms"],
            bound_by=timing[name]["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
