"""The CPU rehearsal of a CUDA kernel source: g++ and threads in place of
nvcc and the card.

    lib = emulated.load("corrector_sweep_c2.cu")
    emulated.launch(lib, "corrector_sweep_c2_f32", tensors, ints)

`load` rewrites a source of `csrc/` for the stand-ins in `csrc/emu/` (each
`kernel<<<grid, block, smem, stream>>>(args)` launch becomes a call of the
emulator, each `extern __shared__ ... name[];` a pointer to the block's
shared memory), compiles it with

    g++ -std=c++20 -O1 -shared -fPIC -pthread -DCFL_EMULATED

into `build/emulated/<stem>-<hash>.so` at the repository root, and loads it
with ctypes.  The emulator runs each block's threads as std::threads with a
std::barrier for `__syncthreads()`, fills shared memory with NaN bytes, and
makes every `cp.async` a plain copy, so a kernel's indexing, its barriers
and its ragged tiles run on CPU tensors, beside the plain version.  What it
cannot show: the card's timing, its memory model beyond the barriers, and
its rounding of `rsqrtf` (exact here).  Needs g++ with C++20
(`std::barrier`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from crazyflie_nmpc_tpu_torch.ops.cuda import _build

EMU = _build.CSRC / "emu"
EMU_HEADERS = ("cuda_runtime.h", "cuda_bf16.h")
BUILD_DIR = _build.BUILD_DIR.parent / "emulated"
GXX_FLAGS = ("-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
             "-DCFL_EMULATED")

_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)[\s\\]*<<<(.*?)>>>", re.S)
_SHARED = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?"
                     r"([\w ]+?)\s+(\w+)\[\];")

_loaded: dict[str, ctypes.CDLL] = {}


def gxx() -> str | None:
    """The g++ the rehearsal compiles with, or None."""
    return shutil.which("g++")


def translate(text: str) -> str:
    """A kernel source rewritten for the emulator: its launches and its
    dynamic shared memory."""
    text = _LAUNCH.sub(r"cfl_emu::launch(\1, \2)", text)
    return _SHARED.sub(r"\1* const \2 = cfl_emu::shared<\1>();", text)


def load(source: str, text: str | None = None) -> ctypes.CDLL:
    """The emulated library of `source` (a file of `csrc/`, or `text` in
    its place: a variant of it, named `source`), compiled first if stale.
    Raises RuntimeError without g++ or when it fails."""
    text = (_build.CSRC / source).read_text() if text is None else text
    h = hashlib.sha256(text.encode())
    for path in ([_build.CSRC / n for n in _build.HEADERS]
                 + [EMU / n for n in EMU_HEADERS]):
        h.update(path.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    path = BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"
    lib = _loaded.get(str(path))
    if lib is not None:
        return lib
    if not path.exists():
        cxx = gxx()
        if cxx is None:
            raise RuntimeError("g++ not found: the CPU rehearsal cannot "
                               "build")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = path.with_suffix(f".{os.getpid()}.cc")
        cc.write_text(translate(text))
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        done = subprocess.run(
            [cxx, *GXX_FLAGS, "-I", str(EMU), "-I", str(_build.CSRC),
             "-include", "cuda_runtime.h", "-o", str(tmp), str(cc)],
            capture_output=True, text=True)
        cc.unlink()
        if done.returncode != 0:
            raise RuntimeError(f"emulated build of {source} failed:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    _loaded[str(path)] = lib
    return lib


def launch(lib: ctypes.CDLL, symbol: str, tensors, ints, floats=()) -> None:
    """Call `int symbol(void* tensors..., double floats..., int ints...,
    stream)` on CPU tensors (stream null), as `_build.launch` calls the
    card's; raise on a non-zero return."""
    if any(t.is_cuda for t in tensors):
        raise ValueError(f"{symbol}: the emulator takes CPU tensors")
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_double] * len(floats)
                   + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*[t.data_ptr() for t in tensors], *floats, *ints, None)
    if err != 0:
        raise RuntimeError(f"{symbol}: emulated launch refused (error "
                           f"{err})")
