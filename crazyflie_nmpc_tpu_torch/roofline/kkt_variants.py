"""K2 `kkt_sweep_c2` in variants on the card: its group size, its dot
products, and the parts of its stage cut out one at a time.

    python -m crazyflie_nmpc_tpu_torch.roofline.kkt_variants

Each variant is `csrc/kkt_sweep_c2.cu` with one edit (`VARIANTS`): G = 8
or 32 threads per lane (128 threads a block, so 16 or 4 lanes), the dot
products on two accumulators, or one part of the stage removed (the
backward pass's loads, its phases A-D, its stores, the rollout).  Every
variant is built with the port's nvcc flags into
`build/torch_kernels/variants/`, launched through its float32 entry point
at its own launch shape, and timed with CUDA events at B = 1024, 4096 and
8192 (N=50, the study's condensed data), all variants in turn and then in
reverse order; the unedited kernel runs among them.  The variants that
compute the whole stage are also held against the plain version at
B=1024 (relative 1e-4, as `chip_smoke.py`); the cut ones compute garbage
and are only timed.  What a part costs is the kernel's time less the time
without it.  Runs on the CUDA device only: without one it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.roofline import time_events

BATCHES = (1024, 4096, 8192)
_SOURCE = "kkt_sweep_c2.cu"
_ROLLOUT = "  // forward rollout: du_k"
_LAUNCH = ("template <typename T, typename TA, typename TG, bool DEV>\n"
           "int set_smem()")


def _cut(start, end, keep=""):
    """An edit removing the source between the markers `start` (included)
    and `end` (kept), leaving `keep` in its place."""
    def edit(src):
        a, b = src.index(start), src.index(end)
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

# name: (threads per lane, edit of the source or None)
VARIANTS = {
    "kernel": (16, None),
    "G=8": (8, _replace("constexpr int kGroup = 16;",
                        "constexpr int kGroup = 8;")),
    "G=32": (32, _replace("constexpr int kGroup = 16;",
                          "constexpr int kGroup = 32;")),
    "two accumulators": (16, _replace(_DOT, _DOT2)),
    "no backward loads": (16, _cut(
        "    stage_in<T, DEV, NX, RW>(sh, AT, Abar", "    copy_wait();")),
    "no phase A": (16, _cut("    // P [A | B | c]", "    // B' times",
                            _BARRIER)),
    "no phase B": (16, _cut("    // B' times", "    // L = chol(Quu)",
                            _BARRIER)),
    "no phase C": (16, _cut("    // L = chol(Quu)",
                            "    // the stage's gains out", _BARRIER)),
    "no stores": (16, _cut("    // the stage's gains out",
                           "    // X = Qbar + A'PA")),
    "no phase D": (16, _cut("    // X = Qbar + A'PA", "  }\n\n" + _ROLLOUT)),
    "no rollout": (16, _cut(_ROLLOUT, _LAUNCH, "}\n\n")),
}


def sources() -> dict:
    """{variant name: its source text}."""
    src = (_build.CSRC / _SOURCE).read_text()
    return {name: edit(src) if edit else src
            for name, (_, edit) in VARIANTS.items()}


def _stem(name):
    return "kkt_" + re.sub(r"\W+", "_", name).strip("_")


def build(texts) -> dict:
    """Compile every variant at once; {name: (library, ptxas lines of its
    float32 exact-form instance)}."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in _build.HEADERS:
        shutil.copy(_build.CSRC / h, out_dir / h)
    jobs = {}
    for name, text in texts.items():
        cu = out_dir / f"{_stem(name)}.cu"
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
                on = "kkt_sweep_c2_kernelIfffLb0E" in line
            elif on and ("spill" in line or "Used " in line):
                lines.append(line.split(":", 1)[-1].strip())
        built[name] = (ctypes.CDLL(str(lib)), lines)
    return built


def launcher(lib, group):
    """f(args) -> outputs: the variant's float32 exact form on the sweep's
    12 inputs, at its own launch shape."""
    fn = lib.kkt_sweep_c2_f32
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lanes = ck.KKT_THREADS // group

    def run(args):
        M, B = args[0].shape[0], args[0].shape[-1]
        outs = tuple(torch.empty(s, dtype=torch.float32, device=args[0].device)
                     for s in ((M, ck.NUC, ck.NX, B), (M, ck.NUC, B),
                               (M, ck.NLC, B), (M, ck.NX, B),
                               (M + 1, ck.NX, B), (M, ck.NUC, B)))
        err = fn(*[t.data_ptr() for t in (*args, *outs)], M, B,
                 math.ceil(B / lanes), ck.KKT_THREADS,
                 lanes * ck.KKT_LANE_VALUES * 4,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"kkt_variants: CUDA error {err}")
        return outs
    return run


def rel_err(got, want):
    """max over outputs of max |got - want| / max(1, max |want|)."""
    return max(float((g.double() - w.double()).abs().max())
               / max(1.0, float(w.abs().max())) for g, w in zip(got, want))


def study(device=None, log=print) -> dict:
    """Build, check and time every variant; returns {name: {B: [ms, ms]}}.
    Raises RuntimeError when a whole-stage variant disagrees with the
    plain version."""
    from crazyflie_nmpc_tpu_torch.roofline.ipm_iter_sol import condensed_data

    device = torch.device(device or "cuda")
    built = build(sources())
    for name, (_, lines) in built.items():
        log(f"ptxas {name}: " + "; ".join(lines))
    runs = {name: launcher(lib, VARIANTS[name][0])
            for name, (lib, _) in built.items()}
    data = {}
    for B in BATCHES:
        d = condensed_data(B, device)
        c = d["cnd"]
        data[B] = (c["Abar"], c["Bbar"], c["cbar"], c["Qbar"], c["S1T"],
                   c["R00"], c["qbar"], d["ruu"], c["rbar"], d["pT"],
                   d["p_term"], d["dx0"])
    want = ck.kkt_sweep_c2_ref(*data[BATCHES[0]])
    for name, run in runs.items():
        if not name.startswith("no "):
            e = rel_err(run(data[BATCHES[0]]), want)
            log(f"{name}: rel err {e:.3e} against the plain version at "
                f"B={BATCHES[0]}")
            if not e <= 1e-4:
                raise RuntimeError(f"kkt_variants: {name} disagrees ({e})")
    times = {name: {B: [] for B in BATCHES} for name in runs}
    order = list(runs) + list(runs)[::-1]
    for name in order:
        for B in BATCHES:
            times[name][B].append(time_events(
                lambda: runs[name](data[B]), 20, rounds=3))
    for name, by_b in times.items():
        log(f"{name}: " + ", ".join(
            f"B={B} " + " / ".join(f"{ms:.4f}" for ms in t) + " ms"
            for B, t in by_b.items()))
    return times


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("kkt_variants: no CUDA device (the variants run on the card)",
              file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    study()
    return 0


if __name__ == "__main__":
    sys.exit(main())
