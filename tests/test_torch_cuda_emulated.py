"""K3's CUDA source on the CPU: `csrc/corrector_sweep_c2.cu` compiled with
g++ against the port's thread emulator (`ops/cuda/emulated.py`,
`csrc/emu/`), all four forms in float32 and float64, against the plain
version `corrector_sweep_c2_ref` on CPU tensors.

The inputs are `chip_smoke.kernel_inputs`' (K2's factorization of
condensed hover data, the bf16 forms' streams rounded from it), at lane
counts that cover both copy paths of the 16-lane tile: 1 and 7 (one ragged
tile), 17 (a full tile whose rows are not 16-byte aligned in any dtype,
and a ragged one) and 32 (two full tiles, 16-byte aligned in every dtype),
over 1 and 3 condensed stages (the turn of the slot ring at odd M).
Tolerances are the card check's (`chip_smoke.TOL`): both sides evaluate
the same sums in the same order, apart from `rsqrtf` (exact here) and FMA
contraction.
"""

import functools

import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
from crazyflie_nmpc_tpu_torch.ops.cuda import emulated
from _torch_shared import one_torch_thread  # noqa: F401

SOURCE = "corrector_sweep_c2.cu"
FORMS = ("corrector_sweep_c2", "corrector_sweep_c2 bf16 gains",
         "corrector_sweep_c2 bf16 stream",
         "corrector_sweep_c2 bf16 gains+stream")
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def lib():
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    return emulated.load(SOURCE)


@functools.lru_cache(maxsize=None)
def _inputs(lanes, M, dtype):
    import chip_smoke

    return chip_smoke.kernel_inputs(lanes, dtype, "cpu", n=2 * M)


def emulate_k3(lib, Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0,
               a_dev=False, geometry=None):
    """`corrector_sweep_c2`'s launch, as its wrapper makes it, on the
    emulator; `geometry` overrides `corr_launch_geometry`'s."""
    form, _ = ck._form(a_dev, (Abar, Bbar, cbar), K.dtype == torch.bfloat16)
    M, B = Abar.shape[0], Abar.shape[-1]
    dx = torch.full((M + 1, ck.NX, B), float("nan"), dtype=qx.dtype)
    du = torch.full((M, ck.NUC, B), float("nan"), dtype=qx.dtype)
    geo = geometry or ck.corr_launch_geometry(B, qx.dtype)
    sfx = "f32" if qx.dtype == torch.float32 else "f64"
    emulated.launch(lib, f"corrector_sweep_c2{form}_{sfx}",
                    [Abar, Bbar, cbar, qx, ru, K, L, Pc, p_term, dx0, dx, du],
                    [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return dx, du


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("lanes", [1, 7, 17, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("form", FORMS)
def test_corrector_sweep_c2_emulated_matches_plain(lib, form, dtype, lanes,
                                                   M):
    _, ref, args = _inputs(lanes, M, dtype)[form]
    a_dev = args[0].dtype == torch.bfloat16
    got = emulate_k3(lib, *args, a_dev=a_dev)
    want = ref(*args)
    assert all(torch.isfinite(g).all() for g in got)
    assert _rel(got, want) <= TOL[dtype], (form, _rel(got, want))


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
def test_emulated_launch_refuses_other_geometry(lib, key, delta):
    """The launch checks grid, threads and shared bytes against the
    source's constants and refuses (without running) what disagrees."""
    _, _, args = _inputs(7, 1, torch.float32)["corrector_sweep_c2"]
    geo = ck.corr_launch_geometry(7, torch.float32)
    with pytest.raises(RuntimeError, match="refused"):
        emulate_k3(lib, *args, geometry=dict(geo, **{key: geo[key] + delta}))


@pytest.mark.parametrize("lanes", [7, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("form", [FORMS[0], FORMS[3]])
def test_corrector_sweep_c2_group_of_8_emulated(form, dtype, lanes):
    """The timing tool's G=8 variant (32 lanes a block: at 40 lanes a
    full, aligned tile and a ragged one) computes the same answer."""
    from crazyflie_nmpc_tpu_torch.roofline import kkt_variants

    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    text = kkt_variants.sources("corrector_sweep_c2")["G=8"]
    group, threads = kkt_variants.shape(text)
    lib8 = emulated.load(SOURCE, text)
    _, ref, args = _inputs(lanes, 3, dtype)[form]
    per_block = threads // group
    geo = dict(grid=-(-lanes // per_block), threads=threads,
               smem=per_block * ck.CORR_LANE_VALUES * dtype.itemsize)
    got = emulate_k3(lib8, *args, a_dev=args[0].dtype == torch.bfloat16,
                     geometry=geo)
    assert _rel(got, ref(*args)) <= TOL[dtype]
