"""K10 `iter_sweep_c2`'s CUDA source on the CPU: `csrc/iter_c2.cu` compiled
with g++ against the port's thread emulator (`ops/cuda/emulated.py`,
`csrc/emu/`), float32 and float64, against its plain version
`iter_sweep_c2_ref` on CPU tensors.

The inputs are `chip_smoke.kernel_inputs`' (K1's condensed hover data plus
seeded slacks, duals, residuals and masks, a tenth of the bounds infinite),
and an all-finite case, at lane counts that cover K10's 8-lane tile: 1 and
7 (one ragged tile), 17 (full tiles whose rows are not 16-byte aligned,
and a ragged one) and 32 (full, aligned tiles), over 1 and 3 condensed
stages (the turn of the slot rings at odd M).  Tolerances are the card
check's (`chip_smoke.TOL`): both sides evaluate the same formulas, the
kernel its sums in stage order and the plain version over the whole
horizon at once.
"""

import functools

import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.ops.cuda import emulated
from _torch_shared import one_torch_thread  # noqa: F401

TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])
# the kernel's 25 inputs, in its entry's order (tau follows them in the
# wrapper's)
INPUTS = ("Abar", "Bbar", "c_res", "Qbar", "S1T", "R00", "qx", "ruu", "r1u",
          "s_l", "s_u", "lam_l", "lam_u", "r3", "r4", "m_l", "m_u", "z_dx",
          "z_du", "pT", "r1x_T", "dx0_res", "z_dxT", "n_ineq", "has_ineq")


@pytest.fixture(scope="module")
def lib():
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    return emulated.load("iter_c2.cu")


@functools.lru_cache(maxsize=None)
def _inputs(lanes, M, dtype, finite=0.9):
    import chip_smoke

    return chip_smoke.kernel_inputs(lanes, dtype, "cpu", n=2 * M,
                                    finite=finite)["iter_sweep_c2"][2]


def emulate(lib, args, geometry=None):
    """K10's launch, as its wrapper makes it, on the emulator: on copies
    of the carried inputs (updated in place), with NaN-filled scratch,
    alpha and mu; `geometry` overrides the wrapper's.  Returns (the 16
    outputs, {name: the tensor passed})."""
    *tensors, tau = args
    M, B = tensors[0].shape[0], tensors[0].shape[-1]
    dtype = tensors[0].dtype
    tensors = [t.clone() for t in tensors]
    scratch = {k: torch.full_like(v, float("nan"))
               for k, v in ck.iter_scratch(M, B, dtype, "cpu").items()}
    alpha, mu = (torch.full((1, B), float("nan"), dtype=dtype)
                 for _ in range(2))
    geo = geometry or ck.iter_launch_geometry(B, dtype)
    finfo = torch.finfo(dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    emulated.launch(lib, f"iter_sweep_c2_{sfx}",
                    tensors + list(scratch.values()) + [alpha, mu],
                    [M, B, geo["grid"], geo["threads"], geo["smem"]],
                    floats=(tau, 100.0 * finfo.eps ** 2, finfo.tiny))
    passed = dict(zip(INPUTS, tensors))
    return [passed[k] for k in ck._ITER_CARRIED] + [alpha, mu], passed


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def _check(lib, args, dtype):
    got, _ = emulate(lib, args)
    want = ck.iter_sweep_c2_ref(*args)
    assert all(torch.isfinite(g).all() for g in got)
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("lanes", [1, 7, 17, 32])
@DTYPES
def test_emulated_iter_matches_plain(lib, dtype, lanes, M):
    """Bounds partly infinite (the masked algebra runs)."""
    _check(lib, _inputs(lanes, M, dtype), dtype)


@DTYPES
def test_emulated_iter_matches_plain_all_finite(lib, dtype):
    _check(lib, _inputs(17, 3, dtype, finite=1.0), dtype)


def test_emulated_iter_updates_every_carry_in_place(lib):
    """The 14 carried inputs are the kernel's outputs: each tensor passed
    in comes back changed, equal to the plain version's output."""
    args = _inputs(7, 3, torch.float64)
    got, passed = emulate(lib, args)
    want = ck.iter_sweep_c2_ref(*args)
    originals = dict(zip(INPUTS, args))
    for name, out, ref in zip(ck._ITER_CARRIED, got, want):
        assert out is passed[name], name
        assert not torch.equal(out, originals[name]), name
        assert _rel([out], [ref]) <= TOL[torch.float64], name


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
def test_emulated_iter_launch_refuses_other_geometry(lib, key, delta):
    """The launch checks grid, threads and shared bytes against the
    source's constants and refuses (without running) what disagrees."""
    args = _inputs(7, 1, torch.float32)
    geo = ck.iter_launch_geometry(7, torch.float32)
    with pytest.raises(RuntimeError, match="refused"):
        emulate(lib, args, geometry=dict(geo, **{key: geo[key] + delta}))
