"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source under `crazyflie_nmpc_tpu_torch/csrc/` compiles on its own
into `build/torch_kernels/<stem>-<hash>.so` at the repository root, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and exposes a plain C interface (pointers, sizes, stream; returns the
`cudaGetLastError()` of its launch).  The hash covers the source, the
shared headers and the flags, so an edited source rebuilds.  `ptxas -v`
(registers, spills) is kept beside each library as `<name>.log`.

Nothing here runs at import: the CPU tests import every module, and this
host need not have `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("prep_condense2.cu", "prep_sweep.cu", "kkt_sweep_c2.cu",
           "corrector_sweep_c2.cu", "condensed_c2.cu", "iter_c2.cu",
           "riccati.cu", "sol_probes.cu")
HEADERS = ("batch_last.cuh", "c2_stage.cuh", "prep_stage.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# a block's shared memory on the H100 without the opt-in attribute
SMEM_DEFAULT = 48 * 1024

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> dict:
    """Compile every stale source, all nvcc processes started together.

    Returns {source: {"lib": path, "seconds": s, "ptxas": text,
    "cached": bool}}.  Raises RuntimeError with the compiler's output when
    any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    info = {}
    for src in sources:
        lib = _lib_path(src)
        log = lib.with_suffix(".log")
        if lib.exists():
            info[src] = dict(lib=lib, seconds=0.0, cached=True,
                             ptxas=log.read_text() if log.exists() else "")
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     time.perf_counter(), lib, tmp, log)
    failed = []
    for src, (proc, t0, lib, tmp, log) in jobs.items():
        out, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {src} (exit {proc.returncode})\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
        info[src] = dict(lib=lib, seconds=secs, cached=False, ptxas=out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return info


def load(source: str) -> ctypes.CDLL:
    """The loaded library for `source`, building it first if stale."""
    lib = _loaded.get(source)
    if lib is None:
        path = build_all((source,))[source]["lib"]
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib


def check(name: str, tensors: dict, shapes: dict, dtype, device,
          bf16=()) -> None:
    """Raise unless every tensor is contiguous, on `device`, of `dtype`
    (float32 or float64) and of its expected shape.  The compressed
    streams named in `bf16` must be torch.bfloat16 instead, and no other
    tensor may be."""
    import torch

    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} (float32 or float64 only)")
    for key, t in tensors.items():
        want = torch.bfloat16 if key in bf16 else dtype
        if t.device != device or t.dtype != want:
            raise ValueError(f"{name}: {key} is {t.dtype} on {t.device}, "
                             f"expected {want} on {device}")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: {key} exceeds 32-bit indexing")


def launch(source: str, symbol: str, ptrs, ints, floats=()) -> None:
    """Call `int symbol(void* ptrs..., double floats..., int ints...,
    stream)` on the current stream (no synchronize); raise on a non-zero
    cudaGetLastError()."""
    import torch

    if not all(t.is_cuda for t in ptrs):
        raise ValueError(f"{symbol}: the kernel takes CUDA tensors only")
    lib = load(source)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs)
                   + [ctypes.c_double] * len(floats)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*[t.data_ptr() for t in ptrs], *floats, *ints,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


def run(wrapper, source: str, ins: dict, outs, shapes: dict, ints,
        floats=(), form: str = "", bf16=()) -> None:
    """Check `ins` against `shapes` (dtype and device those of the first
    input not named in `bf16`, the bfloat16 compressed streams), launch
    `<wrapper name><form>_<f32|f64>` of `source` on `ins` and `outs`, and
    count the launch on `wrapper.launches`."""
    import torch

    first = next(t for k, t in ins.items() if k not in bf16)
    check(wrapper.__name__, ins, shapes, first.dtype, first.device, bf16)
    sfx = "f32" if first.dtype == torch.float32 else "f64"
    launch(source, f"{wrapper.__name__}{form}_{sfx}",
           list(ins.values()) + list(outs), ints, floats)
    wrapper.launches += 1


def lane_geometry(B, dtype, lanes, threads, lane_values) -> dict:
    """The launch of a kernel that gives each block `lanes` consecutive
    lanes, at B lanes of `dtype` (float32 or float64): `grid` blocks of
    `threads` threads (block i takes lanes [i lanes, (i + 1) lanes) below
    B), `smem` bytes of dynamic shared memory a block (`lane_values` values
    of the dtype a lane), and `opt_in`: whether that exceeds SMEM_DEFAULT,
    so the kernel's launch sets the opt-in attribute."""
    import torch

    smem = lanes * lane_values * torch.finfo(dtype).bits // 8
    return dict(grid=math.ceil(B / lanes), threads=threads, lanes=lanes,
                smem=smem, opt_in=smem > SMEM_DEFAULT)


def blocks_per_sm(source, symbol, dtype) -> int:
    """Resident blocks per SM of the kernel behind `symbol`_f32/_f64 in
    `source`, from the CUDA occupancy API for its registers and shared
    memory (builds the kernel first)."""
    import torch

    sfx = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(load(source), f"{symbol}_{sfx}")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return blocks.value
