"""K1's CUDA source on the CPU: `csrc/prep_condense2.cu` compiled with g++
against the port's thread emulator (`ops/cuda/emulated.py`, `csrc/emu/`),
both VDE orders in float32 and float64, against the plain version
`prep_condense2_ref` on CPU tensors; K7's `csrc/prep_sweep.cu`, which
shares `csrc/prep_stage.cuh` with it, against `prep_sweep_ref`.

The inputs are `chip_smoke.kernel_inputs`' (perturbed hover trajectories
and the reference OCP's tiles), at lane counts that cover the 32-lane tile:
1 and 7 (one ragged tile) and 33 (a full tile and a ragged one of one
lane), over 1 and 2 stage pairs.  Every output starts as NaN, so an entry
the kernel does not store fails.  Tolerances are the card check's
(`chip_smoke.TOL`): both sides evaluate the same sums in the same order,
apart from FMA contraction, Abar = A1 A0 (the kernel pushes A0's columns
through the odd stage's chain, the plain version multiplies) and the
cost products' order of the factors.
"""

import functools

import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build, emulated
from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as pk
from _torch_shared import one_torch_thread  # noqa: F401

SOURCE = "prep_condense2.cu"
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])


def _need_gxx():
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")


@pytest.fixture(scope="module")
def lib():
    _need_gxx()
    return emulated.load(SOURCE)


@functools.lru_cache(maxsize=None)
def _inputs(lanes, n, dtype):
    import chip_smoke

    return chip_smoke.kernel_inputs(lanes, dtype, "cpu", n=n)


def emulate_k1(lib, args, vde_order=4, geometry=None):
    """`prep_condense2`'s launch, as its wrapper makes it, on the emulator,
    into NaN-filled outputs; `geometry` overrides `prep_launch_geometry`'s.
    Returns the outputs in the order of the plain version's flattened
    (cnd, Ae, Be, c, lb, ub)."""
    N, _, B = args[1].shape
    M, dt = N // 2, args[0].dtype
    nan = lambda *s: torch.full(s, float("nan"), dtype=dt)  # noqa: E731
    outs = (nan(M, 13, 13, B), nan(M, 13, 8, B), nan(M, 13, B),
            nan(M, 13, 13, B), nan(M, 4, 13, B), nan(M, 4, 4, B),
            nan(M, 13, B), nan(M, 8, B), nan(M, 13, 13, B), nan(M, 13, 4, B),
            nan(N, 13, B), nan(N, 4, B), nan(N, 4, B))
    geo = geometry or pk.prep_launch_geometry(B, dt, vde_order)
    form = pk._vde_form(vde_order)
    sfx = "f32" if dt == torch.float32 else "f64"
    emulated.launch(lib, f"prep_condense2{form}_{sfx}",
                    list(args) + list(outs),
                    [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def _plain(args, vde_order):
    cnd, *rest = pk.prep_condense2_ref(*args, vde_order=vde_order)
    return [*cnd.values(), *rest]


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("lanes", [1, 7, 33])
@DTYPES
@pytest.mark.parametrize("vde_order", [4, 2])
def test_prep_condense2_emulated_matches_plain(lib, vde_order, dtype, lanes,
                                               M):
    args = _inputs(lanes, 2 * M, dtype)["prep_condense2"][2]
    got = emulate_k1(lib, args, vde_order)
    want = _plain(args, vde_order)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _rel(got, want) <= TOL[dtype], _rel(got, want)


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
def test_emulated_prep_launch_refuses_other_geometry(lib, key, delta):
    """The launch checks grid, threads and shared bytes against the
    source's constants and refuses (without running) what disagrees."""
    args = _inputs(7, 2, torch.float32)["prep_condense2"][2]
    geo = pk.prep_launch_geometry(7, torch.float32)
    with pytest.raises(RuntimeError, match="refused"):
        emulate_k1(lib, args, geometry=dict(geo, **{key: geo[key] + delta}))


@pytest.mark.parametrize("variant", ["8-lane rows", "16-lane rows", "64 lanes",
                                     "4 warps", "16 warps"])
@pytest.mark.parametrize("vde_order", [4, 2])
def test_prep_condense2_shape_variants_emulated(variant, vde_order):
    """The parts study's shape variants (roofline/kkt_variants.py: 8 or 16
    lanes a warp instead of 32, 64 lanes a block instead of 32, 4 or 16
    workers a lane instead of 8) compute the same answer, here at 40 lanes
    (a full tile and a ragged one) and 2 stage pairs."""
    from crazyflie_nmpc_tpu_torch.roofline import kkt_variants

    _need_gxx()
    text = kkt_variants.sources("prep_condense2")[variant]
    group, threads = kkt_variants.shape(text)
    lanes_a_block = threads // group
    lib_v = emulated.load(SOURCE, text)
    dtype = torch.float32
    args = _inputs(40, 4, dtype)["prep_condense2"][2]
    geo = dict(grid=-(-40 // lanes_a_block), threads=threads,
               smem=lanes_a_block * kkt_variants.prep_lane_values(text)[
                   vde_order] * 4)
    got = emulate_k1(lib_v, args, vde_order, geometry=geo)
    assert _rel(got, _plain(args, vde_order)) <= TOL[dtype]


@DTYPES
@pytest.mark.parametrize("vde_order", [4, 2])
def test_prep_sweep_emulated_matches_plain(vde_order, dtype):
    """K7 (csrc/prep_sweep.cu, one thread per lane and stage) on the
    stage math it shares with K1, at 7 lanes and the odd horizon 3."""
    _need_gxx()
    lib7 = emulated.load("prep_sweep.cu")
    args = _inputs(7, 3, dtype)["prep_sweep"][2]
    N, _, B = args[1].shape
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in (
        (N, 13, 13, B), (N, 13, 4, B), (N, 13, B), (N, 13, B), (N, 4, B),
        (N, 4, B), (N, 4, B))]
    sfx = "f32" if dtype == torch.float32 else "f64"
    emulated.launch(lib7, f"prep_sweep{pk._vde_form(vde_order)}_{sfx}",
                    list(args) + outs, [N, B])
    want = pk.prep_sweep_ref(*args, vde_order=vde_order)
    assert all(bool(torch.isfinite(g).all()) for g in outs)
    assert _rel(outs, want) <= TOL[dtype]


@pytest.mark.parametrize("B", [1, 7, 33, 4096, 8192])
@DTYPES
@pytest.mark.parametrize("vde_order", [4, 2])
def test_prep_launch_geometry(vde_order, dtype, B):
    """K1's launch covers every lane exactly once with 32 lanes a block
    (a warp's store of an output entry is 32 consecutive lanes), fits a
    block's shared memory, opts in above 48 KB, and uses the source's
    constants; in float32 an SM's shared memory holds at least the 2
    blocks `__launch_bounds__` asks for."""
    geo = pk.prep_launch_geometry(B, dtype, vde_order)
    lanes = [blk * geo["lanes"] + i for blk in range(geo["grid"])
             for i in range(geo["lanes"])]
    assert sorted(b for b in lanes if b < B) == list(range(B))
    assert (geo["grid"] - 1) * geo["lanes"] < B      # no empty block
    assert geo["lanes"] == 32 and geo["threads"] % 32 == 0
    assert geo["smem"] <= 232_448
    assert geo["opt_in"] == (geo["smem"] > _build.SMEM_DEFAULT)
    assert geo["smem"] == (32 * pk.PREP_LANE_VALUES[vde_order]
                           * dtype.itemsize)
    src = (_build.CSRC / SOURCE).read_text()
    assert f"constexpr int kLanes = {pk.PREP_LANES};" in src
    assert f"constexpr int kThreads = {pk.PREP_THREADS};" in src
    assert ("static_assert(kLaneValues<4> == {} && kLaneValues<2> == {},"
            .format(pk.PREP_LANE_VALUES[4], pk.PREP_LANE_VALUES[2])) in src
    if dtype == torch.float32:
        assert 227 * 1024 // geo["smem"] >= 2
