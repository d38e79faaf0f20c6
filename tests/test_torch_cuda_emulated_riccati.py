"""K8a `kkt_sweep` and K9a `backward_sweep` (`csrc/riccati.cu`, one group
kernel body with a compile-time switch off its rollout), K9b
`forward_sweep` (a group kernel of its own on K5b's design, in the same
source) and K8b `corrector_sweep` and K9c `backward_vector_sweep` (one
group body on K3's design at 4 inputs, K9b's group and block, the rollout
switched off for K9c) compiled with g++ against the port's thread
emulator (`ops/cuda/emulated.py`, `csrc/emu/`), float32 and float64,
against their plain versions `kkt_sweep_ref`, `backward_sweep_ref`,
`forward_sweep_ref`, `corrector_sweep_ref` and `backward_vector_sweep_ref`
on CPU tensors.

The inputs are `chip_smoke.kernel_inputs`' (K7's stage QP of perturbed
hover trajectories plus a barrier shift, K8a's gains of it for K9b, K8a's
factorization of it and a perturbed input gradient for K8b and K9c), at
lane counts that cover K8a's 8-lane tile and both copy paths of the
16-lane one: 1 and 7 (one ragged tile), 17 (full tiles whose rows are not
16-byte aligned, and a ragged one) and 32 (full, 16-byte aligned tiles),
over 1, 2, 3 and 5 stages (fewer stages than a ring of input sets holds,
then its turn, with a set index out of step with the state's two
slots).
Tolerances are the card check's (`chip_smoke.TOL`): both sides evaluate
the same sums in the same order, apart from `rsqrtf` (exact here) and FMA
contraction.  K9a runs K8a's factorization, K9b's sums are K8a's
rollout's term for term, K9c runs K8b's vector pass and K8b's rollout
K9b's sums, so here their outputs are equal bit for bit, as
`chip_smoke.py` expects on the card.  The plain versions are
held against the JAX package's kernels by `test_torch_uncondensed.py`.
"""

import functools

import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import emulated
from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk
from _torch_shared import one_torch_thread  # noqa: F401

SOURCE = "riccati.cu"
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])
_GAINS = lambda N, B: ((N, rk.NU, rk.NX, B), (N, rk.NU, B),  # noqa: E731
                       (N, rk.NL, B), (N, rk.NX, B))
_ROLL = lambda N, B: ((N + 1, rk.NX, B), (N, rk.NU, B))  # noqa: E731
# kernel: (output shapes at (N, B), its launch geometry)
KERNELS = {"kkt_sweep": (lambda N, B: _GAINS(N, B) + _ROLL(N, B),
                         rk.riccati_launch_geometry),
           "backward_sweep": (_GAINS, rk.riccati_launch_geometry),
           "forward_sweep": (_ROLL, rk.forward_launch_geometry),
           "corrector_sweep": (_ROLL, rk.vector_launch_geometry),
           "backward_vector_sweep": (lambda N, B: ((N, rk.NU, B),),
                                     rk.vector_launch_geometry)}


@pytest.fixture(scope="module")
def lib():
    if emulated.gxx() is None:
        pytest.skip("needs g++ (the CPU rehearsal compiles the CUDA source)")
    return emulated.load(SOURCE)


@functools.lru_cache(maxsize=None)
def _inputs(lanes, N, dtype):
    import chip_smoke

    return chip_smoke.kernel_inputs(lanes, dtype, "cpu", n=N)


def emulate(lib, kernel, args, geometry=None):
    """`kernel`'s launch, as its wrapper makes it, on the emulator, into
    NaN-filled outputs; `geometry` overrides the wrapper's."""
    N, B = args[0].shape[0], args[0].shape[-1]
    dtype = args[0].dtype
    shapes, launch_geometry = KERNELS[kernel]
    outs = [torch.full(s, float("nan"), dtype=dtype) for s in shapes(N, B)]
    geo = geometry or launch_geometry(B, dtype)
    sfx = "f32" if dtype == torch.float32 else "f64"
    emulated.launch(lib, f"{kernel}_{sfx}", list(args) + outs,
                    [N, B, geo["grid"], geo["threads"], geo["smem"]])
    return outs


def _rel(got, want):
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("N", [1, 2, 3, 5])
@pytest.mark.parametrize("lanes", [1, 7, 17, 32])
@DTYPES
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_emulated_matches_plain(lib, kernel, dtype, lanes, N):
    _, ref, args = _inputs(lanes, N, dtype)[kernel]
    got = emulate(lib, kernel, args)
    want = ref(*args)
    if isinstance(want, torch.Tensor):   # K9c's one output
        want = (want,)
    assert all(torch.isfinite(g).all() for g in got)
    assert _rel(got, want) <= TOL[dtype], (kernel, _rel(got, want))


@pytest.mark.parametrize("lanes", [7, 32])
@DTYPES
def test_emulated_split_sweeps_equal_kkt_sweep_bitwise(lib, dtype, lanes):
    """K9a's K, kff, L and Pc are K8a's, and K9b's rollout on K8a's gains
    is K8a's own, bit for bit."""
    args = _inputs(lanes, 5, dtype)["kkt_sweep"][2]
    K, kff, L, Pc, dx, du = emulate(lib, "kkt_sweep", args)
    gains = emulate(lib, "backward_sweep", args[:-1])
    assert all(torch.equal(g, w) for g, w in zip(gains, (K, kff, L, Pc)))
    A, Bm, c = args[:3]
    roll = emulate(lib, "forward_sweep", (A, Bm, c, K, kff, args[-1]))
    assert torch.equal(roll[0], dx) and torch.equal(roll[1], du)


@pytest.mark.parametrize("lanes", [7, 32])
@DTYPES
def test_emulated_vector_then_forward_sweep_equal_corrector_sweep_bitwise(
        lib, dtype, lanes):
    """K9c's kff, then K9b's rollout on K8a's gains and that kff, equal
    K8b's dx and du bit for bit: K9c is K8b's kernel body without its
    rollout, and K8b's rollout evaluates K9b's sums in K9b's order."""
    args = _inputs(lanes, 5, dtype)["corrector_sweep"][2]
    dx, du = emulate(lib, "corrector_sweep", args)
    A, Bm, c, qx, ru, K, L, Pc, p_term, dx0 = args
    (kff,) = emulate(lib, "backward_vector_sweep",
                     (A, Bm, qx, ru, K, L, Pc, p_term))
    roll = emulate(lib, "forward_sweep", (A, Bm, c, K, kff, dx0))
    assert torch.equal(roll[0], dx) and torch.equal(roll[1], du)


@pytest.mark.parametrize("key, delta", [("grid", 1), ("threads", 32),
                                        ("smem", 16)])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_emulated_launch_refuses_other_geometry(lib, kernel, key, delta):
    """The launch checks grid, threads and shared bytes against the
    source's constants and refuses (without running) what disagrees."""
    _, _, args = _inputs(7, 1, torch.float32)[kernel]
    geo = KERNELS[kernel][1](7, torch.float32)
    with pytest.raises(RuntimeError, match="refused"):
        emulate(lib, kernel, args, geometry=dict(geo, **{key: geo[key]
                                                          + delta}))
