"""K6 `condense2` (`csrc/condensed_c2.cu`, K1's block: 32 lanes of one
stage pair, 8 threads a lane) and P1 `fma_chain` (`csrc/sol_probes.cu`, 16
threads a lane, row i of c on thread i, 8 lanes a block) compiled with
g++ against the port's thread emulator (`ops/cuda/emulated.py`,
`csrc/emu/`), float32 and float64, against their plain versions
`condense2_ref` and `fma_chain_plain` on CPU tensors.

K6 runs at 1 and 7 lanes (one ragged tile) and 33 (a full tile and a
ragged one of one lane), over 1 and 2 stage pairs, on seeded stage data
whose state cost differs between the stages of a pair (the odd one is
eliminated, the even one lands on Qbar's diagonal).  P1 runs at 1, 7 and
17 lanes (two full 8-lane tiles and a ragged one) on the study's parity
inputs (`probe_inputs(parity=True)`: the output depends on every
product), 16 and 32 products, and must disagree with the plain version
one group of UNROLL products short.  Every output starts as NaN, so an
entry the kernel does not store fails.  Tolerances are the card check's
(`chip_smoke.TOL`): both sides evaluate the same sums in the same order,
apart from FMA contraction.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.ops.cuda import emulated
from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol as sol
from _torch_shared import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])
SOURCES = ("condensed_c2.cu", "sol_probes.cu")


@pytest.fixture(scope="module")
def libs():
    """Both sources' emulated libraries, compiled at once."""
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(emulated.load, SOURCES)))


def _stage_data(lanes, M, dtype):
    """Seeded stage data of 2M stages: A near I, B, c, qxx > 0, qx, ru."""
    rng = np.random.default_rng([lanes, M])
    N = 2 * M
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    n = lambda *s: rng.standard_normal(s)  # noqa: E731
    return (t(np.eye(13)[None, :, :, None] + 0.1 * n(N, 13, 13, lanes)),
            t(0.1 * n(N, 13, 4, lanes)), t(0.05 * n(N, 13, lanes)),
            t(rng.uniform(0.5, 2.0, (N, 13, lanes))), t(n(N, 13, lanes)),
            t(n(N, 4, lanes)))


def _sfx(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def emulate_k6(lib, args, geometry=None):
    """`condense2`'s launch, as its wrapper makes it, on the emulator, into
    NaN-filled outputs (condense2_ref's order); `geometry` overrides
    `condense_launch_geometry`'s."""
    N, B, dtype = args[0].shape[0], args[0].shape[-1], args[0].dtype
    M = N // 2
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in (
        (M, 13, 13, B), (M, 13, 8, B), (M, 13, B), (M, 13, 13, B),
        (M, 4, 13, B), (M, 4, 4, B), (M, 13, B), (M, 8, B))]
    geo = geometry or ck.condense_launch_geometry(B, dtype)
    emulated.launch(lib, f"condense2_{_sfx(dtype)}", list(args) + outs,
                    [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def emulate_p1(lib, a, b, reps, geometry=None):
    """`fma_chain`'s launch, as its wrapper makes it, on the emulator, into
    a NaN-filled output; `geometry` overrides `fma_launch_geometry`'s."""
    B = a.shape[-1]
    out = torch.full((13, 13, B), float("nan"), dtype=a.dtype)
    geo = geometry or sk.fma_launch_geometry(B, a.dtype)
    emulated.launch(lib, f"fma_chain_{_sfx(a.dtype)}", [a, b, out],
                    [reps, B, geo["grid"], geo["threads"], geo["smem"]])
    return out


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("lanes", [1, 7, 33])
@DTYPES
def test_condense2_emulated_matches_plain(libs, dtype, lanes, M):
    args = _stage_data(lanes, M, dtype)
    got = emulate_k6(libs["condensed_c2.cu"], args)
    want = list(ck.condense2_ref(*args).values())
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


@pytest.mark.parametrize("reps", [16, 32])
@pytest.mark.parametrize("lanes", [1, 7, 17])
@DTYPES
def test_fma_chain_emulated_matches_plain(libs, dtype, lanes, reps):
    """The kernel's chain against the plain one, and more than the
    tolerance away from the plain chain one group of products short."""
    (a, b), _ = sol.probe_inputs(lanes, dtype, "cpu", parity=True)
    got = emulate_p1(libs["sol_probes.cu"], a, b, reps)
    assert bool(torch.isfinite(got).all())
    assert _rel([got], [sk.fma_chain_plain(a, b, reps)]) <= TOL[dtype]
    short = sk.fma_chain_plain(a, b, reps - sk.UNROLL)
    assert _rel([got], [short]) > TOL[dtype]


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
@pytest.mark.parametrize("kernel", ["condense2", "fma_chain"])
def test_emulated_launch_refuses_other_geometry(libs, kernel, key, delta):
    """Each launch checks grid, threads and shared bytes against its
    source's constants and refuses (without running) what disagrees."""
    dtype = torch.float32
    if kernel == "condense2":
        args = _stage_data(7, 1, dtype)
        geo = ck.condense_launch_geometry(7, dtype)
        run = lambda g: emulate_k6(libs["condensed_c2.cu"], args, g)  # noqa
    else:
        (a, b), _ = sol.probe_inputs(7, dtype, "cpu")
        geo = sk.fma_launch_geometry(7, dtype)
        run = lambda g: emulate_p1(libs["sol_probes.cu"], a, b, 16, g)  # noqa
    with pytest.raises(RuntimeError, match="refused"):
        run(dict(geo, **{key: geo[key] + delta}))
