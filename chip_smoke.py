#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crazyflie_nmpc_tpu_torch/csrc`,
holds each against its plain PyTorch version at the main path's shapes
(N=50, M=25) in float64 and float32, drives the batched RTI step
(`rti_step_batched`, N=50, IPMConfig(iters=8), batch-last, float32) for 20
chained steps at B = 1024, 4096 and 8192 with launch counters proving the
kernels ran, holds step 1 against the port's float64 CPU run, checks the
certified path's per-lane escalation on a 1.5 m step transient, and times
the step and each kernel with CUDA events.  Exits non-zero if any phase
fails, or when no CUDA device is present.

The second-to-last line is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

# main path: the reference OCP at full width
N = 50
M = N // 2
ITERS = 8
STEPS = 20
B_MAIN = (1024, 4096, 8192)
B_CHECK = 1024        # kernel-vs-plain checks
B_TIME = 4096         # per-kernel timing
N_REF_LANES = 64      # lanes held against the CPU float64 run

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s, fp32
# outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Tolerances of kernel vs plain version, as max |kernel - plain| over
# max(1, max |plain|), per output.  float64: both evaluate the same
# formulas in another order (FMA contraction, the tangent form of A1 A0 in
# K1), so they agree to a few hundred ulp even through the 25-stage
# Riccati recursion.  float32: the same reorderings at eps = 1.2e-7, grown
# by the sequential recursion (P reaches ~1e4 with W_e = 50 Q) and the 8x8
# Cholesky.
TOL = {"float64": 1e-10, "float32": 1e-4}

KERNEL_INFO = {
    "prep_condense2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/prep_condense2.cu",
        replaces="crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:384"),
    "kkt_sweep_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/condensed_c2.cu",
        replaces="crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py:446"),
    "corrector_sweep_c2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/condensed_c2.cu",
        replaces="crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py:1206"),
    "expand2": dict(
        source="crazyflie_nmpc_tpu_torch/csrc/condensed_c2.cu",
        replaces="crazyflie_nmpc_tpu/ops/pallas/condensed_kernels.py:282"),
}


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


def kernel_inputs(B, dtype, device, seed=0):
    """Main-path-shaped inputs of the four kernels: K1's from perturbed
    hover trajectories, K2's from K1's outputs (condensed QP data plus a
    barrier shift), K3's from K2's factorization, K4's from both."""
    import numpy as np
    import torch

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prep_tiles,
                                                             to_batch_last)

    rng = np.random.default_rng(seed)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype,  # noqa: E731
                                   device=device)
    spec = default_ocp(N=N, dtype=dtype, device=device)
    yref, yref_e = hover_yref(spec, device=device)
    st = to_batch_last(init_rti(spec, hover_batch(spec, B, seed),
                                device=device))
    x = st.x_traj
    u = (st.u_traj + 0.3 * r(N, 4, B)).contiguous()
    yb = yref[:, :, None].expand(N, 17, B).contiguous()
    k1_in = (x, u, yb) + prep_tiles(spec, B, dtype, device)
    cnd, Ae, Be, c, lb, ub = pk.prep_condense2_ref(*k1_in)

    pT = torch.diagonal(spec.cost.W_e)[:, None].expand(13, B).contiguous()
    ruu = torch.diagonal(spec.cost.W)[13:].repeat(2)[None, :, None]
    ruu_shift = (ruu + torch.as_tensor(rng.uniform(0.01, 1.0, (M, 8, B)),
                                       dtype=dtype, device=device))
    p_term = (pT * (x[-1] - yref_e[:, None])).contiguous()
    dx0 = (0.01 * r(13, B)).contiguous()
    k2_in = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["Qbar"], cnd["S1T"],
             cnd["R00"], cnd["qbar"], ruu_shift.contiguous(), cnd["rbar"],
             pT, p_term, dx0)
    K, kff, L, Pc, dx, du = ck.kkt_sweep_c2_ref(*k2_in)
    k3_in = (cnd["Abar"], cnd["Bbar"], cnd["cbar"], cnd["qbar"],
             (cnd["rbar"] + 0.1 * r(M, 8, B)).contiguous(), K, L, Pc,
             p_term, dx0)
    k4_in = (Ae, Be, c, dx[:-1].contiguous(), du[:, :4].contiguous())
    return {"prep_condense2": (pk.prep_condense2, pk.prep_condense2_ref,
                               k1_in),
            "kkt_sweep_c2": (ck.kkt_sweep_c2, ck.kkt_sweep_c2_ref, k2_in),
            "corrector_sweep_c2": (ck.corrector_sweep_c2,
                                   ck.corrector_sweep_c2_ref, k3_in),
            "expand2": (ck.expand2, ck.expand2_ref, k4_in)}


def flat(out):
    """Outputs of a kernel as a flat list of tensors."""
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    res = []
    for o in out:
        res.extend(flat(list(o.values())) if isinstance(o, dict) else flat(o))
    return res


def bytes_of(name, args, out):
    """Bytes one call must move: each input read once, each output written
    once.  expand2 reads only the even stages c[2k] of c (N, 13, B)."""
    ins = list(args)
    if name == "expand2":
        ins[2] = ins[2][0::2]
    return sum(t.numel() * t.element_size() for t in ins + flat(out))


def flops_of(name, B):
    """Operations each kernel needs for one call at (M, B), counted from
    the algorithm (2 per multiply-add), not from what the kernel issues.

    K1, per pair: two ERK4 VDE stages (sparse J with ~60 nonzeros times the
    13+4 tangent columns at 3 RK stages, 4 dynamics and 4 Jacobian
    evaluations, the RK4 combinations) and the condensing products (Abar
    13^3, A1 B0 13^2 4, Qbar 13^3, S1T 13^2 4, R00 13 4^2, vectors).
    K2, per stage: PA, A'PA 2 x 13^3; PB, B'PA, Qux'K 3 x 13^2 8; B'PB
    8^2 13; the 8x8 Cholesky and 14 solves; vectors and the rollout.
    K3, per stage: B'm, A'm, K'Qu, one solve and the rollout.
    K4, per pair: 13^2 + 13 4 multiply-adds.
    """
    vde = 3 * 60 * 17 + 4 * 100 + 4 * 150 + 6 * (169 + 52)
    k1 = 2 * (2 * vde) + 2 * (2197 + 676 + 2197 + 169 + 676 + 208
                              + 169 + 52 + 169)
    k2 = 2 * (2 * 2197 + 3 * 1352 + 832 + 84 + 14 * 64 + 169 + 273 + 104
              + 377) + 36
    k3 = 2 * (104 + 64 + 273 + 377)
    k4 = 2 * (169 + 52) + 13
    per = {"prep_condense2": k1, "kkt_sweep_c2": k2,
           "corrector_sweep_c2": k3, "expand2": k4}[name]
    return float(per) * M * B


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from crazyflie_nmpc_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for src, rec in info.items():
        print(f"[build] {src}: {rec['seconds']:.1f} s"
              f"{' (cached)' if rec['cached'] else ''} -> {rec['lib']}")
        fn = None
        for line in rec["ptxas"].splitlines():
            found = re.search(r"(%s)_kernelI([fd])E" % "|".join(KERNEL_INFO),
                              line)
            if "Compiling entry function" in line and found:
                fn = found.group(1) + ("<float>" if found.group(2) == "f"
                                       else "<double>")
            elif "spill stores" in line or "Used " in line:
                print(f"[ptxas] {fn}: {line.split(':', 1)[-1].strip()}")
    return info


def compare(a, b):
    """(max abs err, max over outputs of abs err / max(1, max |b_i|)) over
    matching lists of outputs."""
    err = rel = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            fail(f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if not bool(x.isfinite().all()):
            fail("non-finite kernel output")
        e = float((x - y).abs().max())
        err = max(err, e)
        rel = max(rel, e / max(1.0, float(y.abs().max())))
    return err, rel


def phase_kernels(device):
    """Each kernel against its plain version, float64 then float32."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc

    kc.reset_launch_counts()
    errs = {}
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).split(".")[1]
        for name, (kern, ref, args) in kernel_inputs(
                B_CHECK, dtype, device).items():
            got = flat(kern(*args))
            torch.cuda.synchronize()
            want = flat(ref(*args))
            if kc.launch_counts()[name] == 0:
                fail(f"{name} did not launch its kernel")
            abs_err, rel_err = compare(got, want)
            ok = rel_err <= TOL[dn]
            print(f"[kernel] {name} {dn} B={B_CHECK}: max abs err "
                  f"{abs_err:.3e}, rel {rel_err:.3e} (tol {TOL[dn]:.0e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} {dn} disagrees with its plain version")
            errs[(name, dn)] = abs_err
    print("[kernel] held against plain PyTorch in float64 and float32: "
          + ", ".join(KERNEL_INFO))
    return errs


def run_chain(B, device):
    """20 chained batch-last steps at batch B; returns the first step's
    output, the last state, ms per step and the launch counts.

    The steps run under torch.cuda.set_sync_debug_mode("error"), so any
    host-device synchronisation on the main path fails the run.  ms is
    the whole window's time over its 20 steps; the median and max of the
    step-to-step gaps are extra statistics.  host_ms is the host's time
    to issue one step from an idle card (median of 5): where it is close
    to ms, the host's launch loop sets the step time."""
    import torch

    from crazyflie_nmpc_tpu_torch.ops import cuda as kc
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
        rti_step_batched, to_batch_last)

    spec = default_ocp(N=N, dtype=torch.float32, device=device)
    yref, yref_e = hover_yref(spec, device=device)
    x0s = hover_batch(spec, B, seed=B)
    st0 = to_batch_last(init_rti(spec, x0s, device=device))
    cfg = IPMConfig(iters=ITERS)

    def step(st):
        return rti_step_batched(spec, st, x0s, yref, yref_e, cfg,
                                layout="batch_last")

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
    return dict(x0s=x0s, first=first, last=out, st=st,
                ms=evs[0].elapsed_time(evs[-1]) / STEPS,
                ms_median=gaps[STEPS // 2], ms_max=gaps[-1],
                host_ms=sorted(host)[2], counts=counts, step=step)


def cpu_reference_step(x0s, cfg):
    """The same lanes through the port's plain versions on the CPU, f64."""
    import torch

    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti)
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
        rti_step_batched, to_batch_last)

    spec = default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, yref_e = hover_yref(spec, device="cpu")
    x = x0s.to(device="cpu", dtype=torch.float64)
    st = to_batch_last(init_rti(spec, x, device="cpu"))
    return rti_step_batched(spec, st, x, yref, yref_e, cfg,
                            layout="batch_last")[1]


def phase_main(device):
    import torch

    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    per_step = {"prep_condense2": 1, "kkt_sweep_c2": ITERS,
                "corrector_sweep_c2": ITERS, "expand2": 1}
    totals = dict.fromkeys(per_step, 0)
    rows = []
    for B in B_MAIN:
        run = run_chain(B, device)
        for name, n in per_step.items():
            got = run["counts"][name]
            if got != n * STEPS:
                fail(f"B={B}: {name} launched {got} times in {STEPS} "
                     f"steps, expected {n * STEPS}")
            totals[name] += got
        outputs = [(f"step 1 {k}", t) for k, t in
                   run["first"]._asdict().items()]
        outputs += [(f"step {STEPS} {k}", t) for k, t in
                    run["last"]._asdict().items()]
        outputs += [("x_traj", run["st"].x_traj),
                    ("u_traj", run["st"].u_traj)]
        for key, t in outputs:
            if not bool(torch.isfinite(t).all()):
                fail(f"B={B}: non-finite {key}")
        if tuple(run["last"].u0.shape) != (4, B) or tuple(
                run["last"].x_plan.shape) != (N + 1, 13, B):
            fail(f"B={B}: output shapes {tuple(run['last'].u0.shape)}, "
                 f"{tuple(run['last'].x_plan.shape)}")
        print(f"[main] B={B}: {STEPS} steps, {run['ms']:.3f} ms/step "
              f"(window / {STEPS}), {B / run['ms'] * 1e3:.0f} solves/s; "
              f"step gaps median {run['ms_median']:.3f}, max "
              f"{run['ms_max']:.3f} ms; host issue {run['host_ms']:.3f} "
              f"ms/step; no host sync; launches per step "
              + ", ".join(f"{k}={v // STEPS}" for k, v in
                          run["counts"].items()))
        rows.append(run if B == B_TIME else None)
        if B == B_MAIN[0]:
            lanes = slice(0, N_REF_LANES)
            ref = cpu_reference_step(run["x0s"][lanes],
                                     IPMConfig(iters=ITERS))
            first = run["first"]
            du0 = float((first.u0[:, lanes].double().cpu() - ref.u0)
                        .abs().max())
            dx = float((first.x_plan[..., lanes].double().cpu()
                        - ref.x_plan).abs().max())
            # float32 on the card vs float64 on the CPU after 8 IPM
            # iterations: u0 [kRPM] to 1e-3 (the JAX package's own f32
            # cross-path bar, tests/test_pallas_kernels.py:621), the state
            # plan to 1e-3 (metres, unit quaternion, m/s, rad/s)
            print(f"[main] step 1, {N_REF_LANES} lanes vs CPU float64: "
                  f"max |du0| {du0:.3e} kRPM, max |dx_plan| {dx:.3e}")
            if not (du0 <= 1e-3 and dx <= 1e-3):
                fail("step 1 disagrees with the CPU float64 run")
    return totals, next(r for r in rows if r is not None)


def phase_profile(run, steps=3):
    """Where a step's time goes at B=B_TIME: a torch.profiler trace of a
    few chained steps, split into the port's kernels, the other kernels
    (the barrier algebra and layout glue, PyTorch's own), and the device
    idle time between them.  Profiling adds host overhead, so the idle
    share is an upper bound for the untraced run."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    st = run["st"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            st, _ = run["step"](st)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    kern = [e for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and "dur" in e]
    if not kern:
        print("[profile] torch.profiler recorded no device kernels: "
              "device breakdown not measured")
        return
    ours = dict.fromkeys(KERNEL_INFO, 0.0)
    other, n_other = 0.0, 0
    for e in kern:
        name = next((k for k in KERNEL_INFO if k + "_kernel" in e["name"]),
                    None)
        if name:
            ours[name] += e["dur"]
        else:
            other += e["dur"]
            n_other += 1
    t0 = min(e["ts"] for e in kern)
    t1 = max(e["ts"] + e["dur"] for e in kern)
    window = (t1 - t0) / steps / 1e3
    busy = (sum(ours.values()) + other) / steps / 1e3
    print(f"[profile] B={run['x0s'].shape[0]}, {steps} traced steps, per "
          f"step: window {window:.3f} ms, kernels busy {busy:.3f} ms "
          f"(idle share {1 - busy / window:.3f}); "
          + ", ".join(f"{k} {v / steps / 1e3:.3f} ms"
                      for k, v in ours.items())
          + f", other kernels {other / steps / 1e3:.3f} ms "
          f"({n_other // steps} launches)")


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
        sol = ipm_fast.solve_batched(qp, config)
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


def time_events(fn, reps):
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def phase_timing(device):
    """Per-kernel time, plain version's time and bound at B=4096, f32."""
    import torch

    rows = {}
    for name, (kern, ref, args) in kernel_inputs(
            B_TIME, torch.float32, device, seed=1).items():
        ms = time_events(lambda: kern(*args), 20)
        plain_ms = time_events(lambda: ref(*args), 2)
        nbytes = bytes_of(name, args, kern(*args))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops_of(name, B_TIME) / PEAK_FP32_FLOPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        print(f"[timing] {name} B={B_TIME} float32: {ms:.4f} ms/launch, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops_of(name, B_TIME) / 1e9:.2f} GFLOP)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,main,certified,timing",
                    help="comma-separated subset (the ok line needs all)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import crazyflie_nmpc_tpu_torch  # noqa: F401  (fails outside the repo)

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    errs, totals, timing, main_run = {}, {}, {}, None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        errs = phase_kernels(device)
    if "main" in phases:
        totals, main_run = phase_main(device)
    if "certified" in phases:
        phase_certified(device)
    if "timing" in phases:
        timing = phase_timing(device)
        if main_run is not None:
            phase_profile(main_run)

    print(smi)
    if len(phases) < 5:
        print("chip_smoke: partial run (--phases); no result line")
        return 0
    kernels = []
    for name, info in KERNEL_INFO.items():
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
