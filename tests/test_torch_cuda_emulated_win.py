"""The windowed long-horizon sweeps' CUDA sources on the CPU: K5a `bwd_c2`
and K2 `kkt_sweep_c2` (`csrc/kkt_sweep_c2.cu`, one kernel body with a
compile-time switch), K5b `fwd_c2` (K3's rollout alone) and K5c
`bwd_vec_c2` (K3's kernel body with its rollout switched off), both in
`csrc/corrector_sweep_c2.cu`, compiled with g++ against the port's thread
emulator (`ops/cuda/emulated.py`, `csrc/emu/`), float32 and float64,
against their plain versions `bwd_c2_ref`, `kkt_sweep_c2_ref`,
`fwd_c2_ref` and `bwd_vec_c2_ref` on CPU tensors.

The inputs are `chip_smoke.kernel_inputs`' (K1's condensed hover data, K2's
factorization of it for K5b and K5c), at lane counts that cover both copy
paths of the 16-lane tile of K5b and K5c and K2's 8-lane one: 1 and 7 (one
ragged tile), 17 (full tiles whose rows are not 16-byte aligned, and a
ragged one) and 32 (full, 16-byte aligned tiles), over 1 and 3 condensed
stages (the turn of the slot rings, and of K5a's two sets of cost inputs,
at odd M).  Tolerances are the card check's (`chip_smoke.TOL`): both
sides evaluate the same sums in the same order, apart from `rsqrtf`
(exact here) and FMA contraction.  K5a and K2 run the same
factorization, K5b the rollout of K2 in the same order, and K5c then K5b
K3's two passes, so here, where neither contracts, their outputs are
equal bit for bit, as `chip_smoke.py` expects on the card.
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
# kernel: (source, its launch geometry, output shapes at (M, B))
KERNELS = {
    "bwd_c2": ("kkt_sweep_c2.cu", ck.bwd_launch_geometry,
               lambda M, B: ((M, ck.NUC, ck.NX, B), (M, ck.NUC, B),
                             (M, ck.NLC, B), (M, ck.NX, B))),
    "fwd_c2": ("corrector_sweep_c2.cu", ck.fwd_launch_geometry,
               lambda M, B: ((M + 1, ck.NX, B), (M, ck.NUC, B))),
    "kkt_sweep_c2": ("kkt_sweep_c2.cu", ck.kkt_launch_geometry,
                     lambda M, B: ((M, ck.NUC, ck.NX, B), (M, ck.NUC, B),
                                   (M, ck.NLC, B), (M, ck.NX, B),
                                   (M + 1, ck.NX, B), (M, ck.NUC, B))),
    "bwd_vec_c2": ("corrector_sweep_c2.cu", ck.bwd_vec_launch_geometry,
                   lambda M, B: ((M, ck.NUC, B),)),
}
# K3, the yardstick of K5c and K5b's bitwise test (held against its plain
# version by test_torch_cuda_emulated.py)
LAUNCHES = {**KERNELS,
            "corrector_sweep_c2": ("corrector_sweep_c2.cu",
                                   ck.corr_launch_geometry,
                                   lambda M, B: ((M + 1, ck.NX, B),
                                                 (M, ck.NUC, B)))}


@pytest.fixture(scope="module")
def libs():
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    return {src: emulated.load(src)
            for src in {s for s, _, _ in LAUNCHES.values()}}


@functools.lru_cache(maxsize=None)
def _inputs(lanes, M, dtype):
    import chip_smoke

    return chip_smoke.kernel_inputs(lanes, dtype, "cpu", n=2 * M)


def emulate(libs, kernel, args, geometry=None):
    """`kernel`'s launch, as its wrapper makes it, on the emulator, into
    NaN-filled outputs; `geometry` overrides the wrapper's."""
    source, launch_geometry, shapes = LAUNCHES[kernel]
    M, B = args[0].shape[0], args[0].shape[-1]
    dtype = args[0].dtype
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in shapes(M, B)]
    geo = geometry or launch_geometry(B, dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    emulated.launch(libs[source], f"{kernel}_{sfx}", list(args) + outs,
                    [M, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("lanes", [1, 7, 17, 32])
@DTYPES
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_emulated_matches_plain(libs, kernel, dtype, lanes, M):
    _, ref, args = _inputs(lanes, M, dtype)[kernel]
    got = emulate(libs, kernel, args)
    want = ref(*args)
    if isinstance(want, torch.Tensor):   # bwd_vec_c2's one output
        want = (want,)
    assert all(torch.isfinite(g).all() for g in got)
    assert _rel(got, want) <= TOL[dtype], (kernel, _rel(got, want))


@pytest.mark.parametrize("lanes", [7, 32])
@DTYPES
def test_emulated_split_sweeps_equal_k2_bitwise(libs, dtype, lanes):
    """K5a's gains are K2's, and K5b's rollout on them K2's, bit for bit."""
    inputs = _inputs(lanes, 3, dtype)
    k2_args = inputs["kkt_sweep_c2"][2]
    K, kff, L, Pc, dx, du = emulate(libs, "kkt_sweep_c2", k2_args)
    gains = emulate(libs, "bwd_c2", k2_args[:-1])
    assert all(torch.equal(g, w) for g, w in zip(gains, (K, kff, L, Pc)))
    A, Bm, c = k2_args[:3]
    roll = emulate(libs, "fwd_c2", (A, Bm, c, K, kff, k2_args[-1]))
    assert torch.equal(roll[0], dx) and torch.equal(roll[1], du)


@pytest.mark.parametrize("lanes", [7, 32])
@DTYPES
def test_emulated_vec_then_rollout_equals_k3_bitwise(libs, dtype, lanes):
    """K5c's kff, then K5b's rollout on it, give K3's dx and du bit for
    bit: the two halves keep K3's sums term for term."""
    args = _inputs(lanes, 3, dtype)["corrector_sweep_c2"][2]
    dx, du = emulate(libs, "corrector_sweep_c2", args)
    (kff,) = emulate(libs, "bwd_vec_c2", args[:2] + args[3:9])
    A, Bm, c, K = args[0], args[1], args[2], args[5]
    roll = emulate(libs, "fwd_c2", (A, Bm, c, K, kff, args[-1]))
    assert torch.equal(roll[0], dx) and torch.equal(roll[1], du)


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
@pytest.mark.parametrize("kernel", ["bwd_c2", "fwd_c2", "bwd_vec_c2"])
def test_emulated_launch_refuses_other_geometry(libs, kernel, key, delta):
    """The launch checks grid, threads and shared bytes against the
    source's constants and refuses (without running) what disagrees."""
    _, _, args = _inputs(7, 1, torch.float32)[kernel]
    geo = KERNELS[kernel][1](7, torch.float32)
    with pytest.raises(RuntimeError, match="refused"):
        emulate(libs, kernel, args, geometry=dict(geo, **{key: geo[key]
                                                           + delta}))
