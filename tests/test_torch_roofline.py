"""The speed-of-light probes' plain versions vs the JAX tool's kernels
(float64, B=8, small reps), and the study's rules on the CPU.

fma_chain is held on `probe_inputs(parity=True)`, whose output depends on
every product (on the tool's own inputs the chain settles on its fixed
point within a few products, so a wrong product count would not show).

The JAX probes are closures inside `tools/ipm_iter_sol.py`, which has no
interpret flag, so their bodies are recomposed here from the JAX
package's own helpers (`riccati_kernels._mm`, `_mtm`, `_mv`, `_mtv`,
`_add_diag`; `condensed_kernels._chol_n`, `_cho_solve_n`,
`_cho_solve_n_vec`), line for line as the tool writes them, and jitted on
the CPU.  Tolerance 1e-12 relative to max(1, max |JAX|): the same
formulas, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.ops.pallas.condensed_kernels import (
    NUC,
    _chol_n,
    _cho_solve_n,
    _cho_solve_n_vec,
)
from crazyflie_nmpc_tpu.ops.pallas.riccati_kernels import (
    NX,
    _add_diag,
    _mm,
    _mtm,
    _mtv,
    _mv,
)
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol as sol
from crazyflie_nmpc_tpu_torch.roofline import kkt_variants
from _torch_shared import one_torch_thread  # noqa: F401

B = 8
TOL = 1e-12


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def _jax_fma_chain(a, b, reps):
    """measure_fma_rate's kernel body: `reps` products (a multiple of its
    unroll)."""
    c = a
    for _ in range(reps):
        c = _mm(c, b, NX, NX, NX) * 7.6e-4 + b
    return c


def _jax_stage(carry, A, Bm, c, Q, S1T, R00, qx, ruu, ru):
    """measure_stage_replay's `body`, as the tool writes it."""
    P, p = carry
    PA = _mm(P, A, NX, NX, NX)
    PB = _mm(P, Bm, NX, NX, NUC)
    Pc = _mv(P, c, NX, NX)
    m = p + Pc
    BtPB = _mtm(Bm, PB, NX, NUC, NUC)
    z44 = jnp.zeros_like(R00)
    R00p = jnp.concatenate([
        jnp.concatenate([R00, z44], axis=1),
        jnp.concatenate([z44, z44], axis=1)], axis=0)
    Quu = _add_diag(BtPB + R00p, ruu, NUC)
    SxT = jnp.concatenate([S1T, jnp.zeros_like(S1T)], axis=0)
    Qux = SxT + _mtm(Bm, PA, NX, NUC, NX)
    Qu = ru + _mtv(Bm, m, NX, NUC)
    L = _chol_n(Quu, NUC)
    K = -_cho_solve_n(L, Qux, NUC, NX)
    _ = -_cho_solve_n_vec(L, Qu, NUC)
    APA = _mtm(A, PA, NX, NX, NX)
    QK = _mtm(Qux, K, NUC, NX, NX)
    P_new = Q + APA + QK
    P_new = 0.5 * (P_new + jnp.swapaxes(P_new, 0, 1))
    p_new = qx + _mtv(A, m, NX, NX) + _mtv(K, Qu, NUC, NX)
    return P_new, p_new


def _jax_stage_replay(A, Bm, c, Q, S1T, R00, qx, ruu, ru, P0, p0, reps):
    carry = (P0, p0)
    for _ in range(reps):
        carry = _jax_stage(carry, A, Bm, c, Q, S1T, R00, qx, ruu, ru)
    return carry


@pytest.fixture(scope="module")
def inputs():
    return sol.probe_inputs(B, torch.float64, "cpu", seed=3, parity=True)


def _np(args):
    return [t.numpy() for t in args]


@pytest.mark.parametrize("reps", [16, 32])
def test_fma_chain_plain_matches_jax(inputs, reps):
    fma, _ = inputs
    want = jax.jit(lambda a, b: _jax_fma_chain(a, b, reps))(*_np(fma))
    kc.reset_launch_counts(kc.PROBES)
    _close(sk.fma_chain(*fma, reps=reps), want, "fma_chain")
    _close(sk.fma_chain_plain(*fma, reps=reps + 5), want, "reps rounding")
    assert kc.launch_counts(kc.PROBES)["fma_chain"] == 0


@pytest.mark.parametrize("reps", [1, 4])
def test_stage_replay_plain_matches_jax(inputs, reps):
    _, replay = inputs
    want = jax.jit(lambda *a: _jax_stage_replay(*a, reps))(*_np(replay))
    kc.reset_launch_counts(kc.PROBES)
    got = sk.stage_replay(*replay, reps=reps)
    for g, w, name in zip(got, want, ("P", "p")):
        _close(g, w, name)
    assert kc.launch_counts(kc.PROBES)["stage_replay"] == 0


def _rel(got, want):
    got, want = torch.cat([g.flatten() for g in got]), torch.cat(
        [w.flatten() for w in want])
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("probe", ["fma_chain", "stage_replay"])
def test_probe_checks_see_a_wrong_count(probe, dtype):
    """On the parity inputs, at the study's reps, the answer one unrolled
    group of products (fma_chain) or one stage (stage_replay) short
    differs from the full answer by more than the card check's tolerance
    (chip_smoke's TOL: 1e-10 float64, 1e-4 float32), so a kernel running
    the wrong count fails that check; the plain float32 answer stays
    within it of float64."""
    tol = {torch.float64: 1e-10, torch.float32: 1e-4}[dtype]
    fma, replay = sol.probe_inputs(B, torch.float64, "cpu", parity=True)
    fn, args, reps, step = {
        "fma_chain": (sk.fma_chain_plain, fma, sol.FMA_REPS, sk.UNROLL),
        "stage_replay": (sk.stage_replay_plain, replay, sol.REPLAY_REPS,
                         1)}[probe]
    out = lambda a, r: fn(*[t.to(dtype) for t in a], reps=r)  # noqa: E731
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    full = as_tuple(out(args, reps))
    exact = [t.double() for t in as_tuple(fn(*args, reps=reps))]
    assert _rel([t.double() for t in full], exact) <= tol
    assert _rel(full, as_tuple(out(args, reps - step))) > tol


@pytest.mark.parametrize("parity", [False, True])
def test_probe_inputs_are_contiguous(parity):
    """The kernels' wrappers refuse strided tensors on the card."""
    fma, replay = sol.probe_inputs(B, torch.float32, "cpu", parity=parity)
    assert all(t.is_contiguous() for t in fma + replay)


@pytest.mark.parametrize("reps", [0, -1, 2**31])
def test_probes_refuse_bad_reps(inputs, reps):
    fma, replay = inputs
    with pytest.raises(ValueError, match="reps"):
        sk.fma_chain(*fma, reps=reps)
    with pytest.raises(ValueError, match="reps"):
        sk.stage_replay(*replay, reps=reps)


def test_byte_counts_follow_the_port_kernels():
    """Per stage and lane: K2 reads 552 and writes 161 values in its
    backward phase, re-reads 398 and writes 21 in its rollout; K3 reads
    447 and writes 8 in its vector pass, then as K2's rollout."""
    assert sol.kkt_bytes(1, 1, 1) == 552 + 161 + 398 + 21 + 52
    assert sol.corr_bytes(1, 1, 1) == 447 + 8 + 398 + 21 + 39
    assert sol.kkt_bytes(25, 4096) == (25 * 1132 + 52) * 4096 * 4


@pytest.mark.parametrize("B_, bps, waves", [(4096, 4, 1), (33792, 4, 1),
                                            (33793, 4, 2), (4096, 1, 1)])
def test_waves(B_, bps, waves):
    assert sol.waves(B_, bps, 132) == waves


def test_study_needs_the_card(monkeypatch):
    """device=None is the card; the CPU is refused (the study measures the
    card), and the command line exits 1 without one."""
    with pytest.raises(RuntimeError, match="CUDA device only"):
        sol.study(8, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sol.study(8)
    assert sol.main(["--batch", "8"]) == 1


def test_kkt_variants_edit_the_kernel_source(monkeypatch):
    """Every K2 and K3 variant's edit applies to its kernel's source as it
    stands and changes it (a moved marker fails here, not on the card);
    the tool exits 1 without a card, for either kernel."""
    for kernel, (_, variants, _) in kkt_variants.KERNELS.items():
        texts = kkt_variants.sources(kernel)
        assert set(texts) == set(variants), kernel
        assert all(text != texts["kernel"] for name, text in texts.items()
                   if name != "kernel"), kernel
    assert kkt_variants.KERNELS["kkt_sweep_c2"][1] is kkt_variants.VARIANTS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kkt_variants.main([]) == 1
    assert kkt_variants.main(["--kernel", "corrector_sweep_c2"]) == 1


def test_iter_variants_cut_one_phase_each():
    """K10's study variants: each phase cut removes that phase's call and
    nothing else, the algebra cut flips the switch, and only the whole
    kernels are held against the plain version (`_whole`)."""
    texts = kkt_variants.sources("iter_sweep_c2")
    kernel = texts["kernel"]
    for name, call in kkt_variants._ITER_PHASES.items():
        assert kernel.count(call) == 1, name
        assert texts[name] == kernel.replace(call, ""), name
    assert "constexpr bool kAlgebra = false;" in texts["no barrier algebra"]
    assert [n for n in texts if kkt_variants._whole(n)] == ["kernel"]
    assert kkt_variants._whole("baseline")
    assert not kkt_variants._whole("baseline no phase 2")


def test_iter_study_inputs_and_fresh_copies():
    """K10's study inputs fit its entry (25 inputs, then the 7 scratch
    arrays), every bound finite; `calls` gives each launch its own copy
    of the 14 carried inputs and shares the others; the plain version
    steps from them."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    d = sol.condensed_data(4, "cpu")
    args = kkt_variants.iter_inputs(d, 4, "cpu")
    M = args[0].shape[0]
    assert len(args) == kkt_variants.SWEEPS["iter_sweep_c2"][0]
    shapes = ck._shapes(M, 4)
    names = ("Abar", "Bbar", "c_res", "Qbar", "S1T", "R00", "qx", "ruu",
             "r1u", "s_l", "s_u", "lam_l", "lam_u", "r3", "r4", "m_l",
             "m_u", "z_dx", "z_du", "pT", "r1x_T", "dx0_res", "z_dxT",
             "n_ineq", "has_ineq", *ck.iter_scratch(M, 4, torch.float32,
                                                   "cpu"))
    for name, a in zip(names, args):
        assert tuple(a.shape) == shapes[name] and a.is_contiguous(), name
    assert [names[i] for i in kkt_variants._ITER_CARRIED] == list(
        ck._ITER_CARRIED)
    assert bool((args[15] == 1).all() and (args[16] == 1).all())
    seen = []
    fn = kkt_variants.calls("iter_sweep_c2", lambda a: seen.append(a) or a,
                            args, 3)
    for _ in range(3):
        fn()
    for i, a in enumerate(args):
        owned = i in kkt_variants._ITER_CARRIED
        assert all((s[i] is a) != owned for s in seen), i
        assert i >= 25 or all(torch.equal(s[i], a) for s in seen), i
    out = kkt_variants._plain("iter_sweep_c2")(*args)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert bool(((out[-2] > 0) & (out[-2] <= 1)).all())


@pytest.mark.parametrize("kernel", ["kkt_sweep", "backward_sweep"])
def test_riccati_variants_find_their_anchors(kernel, tmp_path):
    """K8a's and K9a's study variants: each cut's start marker stands once
    in csrc/riccati.cu and the cut removes it (the loads, phases A-D, the
    stores), the shape edits change their constant, and only the whole
    kernels are held against the plain version.  The `--baseline` source
    of either is the one-thread riccati.cu, which names K9a
    `kkt_sweep_kernel<T, false>`; the study's inputs fit the entries."""
    texts = kkt_variants.sources(kernel)
    src = texts["kernel"]
    marks = {"no backward loads": "    stage_in<NX, RW>(sh, AT, A,",
             "no phase A": "    // P [A | B | c] (phase A)",
             "no phase B": "    // B' [PA | m",
             "no phase C": "    // L = chol(Quu)",
             "no stores": "    // the stage's gains out",
             "no phase D": "    // X = A'PA"}
    for name, mark in marks.items():
        assert src.count(mark) == 1 and mark not in texts[name], name
    assert "constexpr int kGroup = 8;" in texts["G=8"]
    assert "constexpr int kGroup = 32;" in texts["G=32"]
    assert "constexpr int kThreads = 256;" in texts["256 threads"]
    if kernel == "kkt_sweep":
        assert "constexpr int kSets = 2;" in texts["2 sets"]
        assert "if constexpr (false) {" in texts["no rollout"]
    else:
        assert "2 sets" not in texts and "no rollout" not in texts
    assert kkt_variants.lane_values(kernel, src) == 1004
    assert kkt_variants.shape(src) == (16, 128)
    assert "? 1024 : 256) / kThreads" in texts["8 blocks an SM"]
    assert [n for n in texts if kkt_variants._whole(n)] == [
        "kernel", "G=8", "G=32", "256 threads", "8 blocks an SM"] + (
        ["2 sets"] if kernel == "kkt_sweep" else [])
    (tmp_path / "riccati.cu").write_text(
        "template <typename T, bool ROLLOUT>\n__global__ void\n"
        "kkt_sweep_kernel(const T* A) {}\n")
    assert kkt_variants.baseline_source(kernel, tmp_path) == "riccati.cu"
    assert kkt_variants.lane_values(
        kernel, (tmp_path / "riccati.cu").read_text()) is None
    args = kkt_variants.inputs(kernel, 4, "cpu")
    n_in, shapes, _ = kkt_variants.SWEEPS[kernel]
    assert len(args) == n_in and all(a.is_contiguous() for a in args)
    out = kkt_variants._plain(kernel)(*args)
    assert [tuple(o.shape) for o in out] == list(shapes(50, 4))


_K5C_K9B_CUTS = {
    "bwd_vec_c2": {
        "no loads": ("      if (k - kVecSets + 1 >= 0) "
                     "vec_in(k - kVecSets + 1);"),
        "no m/Qu phase": "    // vector-pass Qu: m = p + Pc",
        "no p update": "    // vector-pass p update",
        "no kff solve": "    // vector-pass kff solve"},
    "forward_sweep": {
        "no loads": "    if (k + kFwdSets - 1 < N) roll_in(k + kFwdSets - 1);",
        "no u phase": "    // K9b's u = K x + kff",
        "no dx phase": "    // K9b's dx_{k+1}",
        "no stores": "    // K9b's x_k out"},
}


@pytest.mark.parametrize("kernel, source, values, sets_values, store", [
    ("bwd_vec_c2", "condensed_c2.cu", 954, 1414, "if (valid && B < 0) kff["),
    ("forward_sweep", "riccati.cu", 636, 939, "if (valid && B < 0) du[")])
def test_k5c_and_k9b_variants_find_their_anchors(kernel, source, values,
                                                 sets_values, store,
                                                 tmp_path):
    """K5c's and K9b's study variants: each cut's start marker stands once
    in the source and the cut removes it, the kept-alive stores test
    B < 0, the shape edits give their launch shape (K9b's from its own
    constants beside K8a's), and only the whole kernels are held against
    the plain version.  The `--baseline` source is the one-thread file
    (condensed_c2.cu, riccati.cu), whose entries take no launch shape;
    the study's inputs fit the entries."""
    texts = kkt_variants.sources(kernel)
    src = texts["kernel"]
    for name, mark in _K5C_K9B_CUTS[kernel].items():
        assert src.count(mark) == 1 and mark not in texts[name], name
    assert store in texts["no stores"] and store not in src
    shapes = {"kernel": (16, 256), "3 sets": (16, 256), "G=8": (8, 128),
              "32 lanes": (16, 512), "G=8, 32 lanes": (8, 256)}
    assert {n: kkt_variants.shape(texts[n], kernel) for n in shapes} == shapes
    assert kkt_variants.lane_values(kernel, src) == values
    assert kkt_variants.lane_values(kernel, texts["3 sets"]) == sets_values
    assert [n for n in texts if kkt_variants._whole(n)] == list(shapes)
    (tmp_path / source).write_text(
        f"template <typename T>\n__global__ void\n{kernel}_kernel("
        f"const T* A) {{}}\n")
    assert kkt_variants.baseline_source(kernel, tmp_path) == source
    one_thread = (tmp_path / source).read_text()
    assert kkt_variants.lane_values(kernel, one_thread) is None
    assert kkt_variants.shape(one_thread, kernel) == (1, 128)
    args = kkt_variants.inputs(kernel, 4, "cpu")
    n_in, out_shapes, _ = kkt_variants.SWEEPS[kernel]
    assert len(args) == n_in and all(a.is_contiguous() for a in args)
    out = kkt_variants._plain(kernel)(*args)
    assert [tuple(o.shape) for o in out] == list(
        out_shapes(args[0].shape[0], 4))


_K8B_K9C_CUTS = {
    "no loads": ("      vec_in(k - kVecSets + 1);",
                 "      if (k + kVecSets - 1 < N) roll_in(k + kVecSets - 1);"),
    "no m/Qu phase": ("    // K8b's and K9c's m = p + Pc",),
    "no p update": ("    // K8b's and K9c's p update",),
    "no kff solve": ("    // K8b's and K9c's kff solve",),
    "no stores": ("      // K8b's x_k out",),
}


@pytest.mark.parametrize("kernel", ["corrector_sweep",
                                    "backward_vector_sweep"])
def test_k8b_and_k9c_variants_find_their_anchors(kernel, tmp_path):
    """K8b's and K9c's study variants (one body in csrc/riccati.cu): each
    cut's markers stand once in the source and the cut removes them, the
    kept-alive stores test B < 0, K8b's "no rollout" switches its rollout
    off, the shape edits give their launch shape (K9b's constants), and
    only the whole kernels are held against the plain version.  The
    `--baseline` source is the one-thread riccati.cu, whose entries take
    no launch shape; the study's inputs fit the entries."""
    texts = kkt_variants.sources(kernel)
    src = texts["kernel"]
    for name, marks in _K8B_K9C_CUTS.items():
        for mark in marks:
            assert src.count(mark) == 1 and mark not in texts[name], name
    for store in ("if (valid && B < 0) kff[", "if (valid && B < 0) du["):
        assert store in texts["no stores"] and store not in src
    roll = "  if constexpr (false) {\n    // K8b's rollout."
    if kernel == "corrector_sweep":
        assert roll in texts["no rollout"] and roll not in src
    else:
        assert "no rollout" not in texts
    shapes = {"kernel": (16, 256), "2 sets": (16, 256), "G=8": (8, 128),
              "32 lanes": (16, 512), "G=8, 32 lanes": (8, 256)}
    assert {n: kkt_variants.shape(texts[n], kernel) for n in shapes} == shapes
    assert kkt_variants.lane_values(kernel, src) == 1059
    assert kkt_variants.lane_values(kernel, texts["2 sets"]) == 716
    assert [n for n in texts if kkt_variants._whole(n)] == list(shapes)
    (tmp_path / "riccati.cu").write_text(
        f"template <typename T>\n__global__ void\n{kernel}_kernel("
        f"const T* A) {{}}\n")
    assert kkt_variants.baseline_source(kernel, tmp_path) == "riccati.cu"
    assert kkt_variants.lane_values(
        kernel, (tmp_path / "riccati.cu").read_text()) is None
    args = kkt_variants.inputs(kernel, 4, "cpu")
    n_in, out_shapes, _ = kkt_variants.SWEEPS[kernel]
    assert len(args) == n_in and all(a.is_contiguous() for a in args)
    out = kkt_variants._plain(kernel)(*args)
    assert [tuple(o.shape) for o in out] == list(out_shapes(50, 4))


def test_fill_lanes_follow_p1s_launch_geometry():
    """The study's b_fill: P1's resident blocks an SM times the SMs times
    its launch geometry's lanes a block (8 lanes of a group of 16 threads
    each), not the one-thread probe's 64 threads."""
    assert sk.fma_launch_geometry(1, torch.float32)["lanes"] == sk.FMA_LANES
    assert sol.fill_lanes(8, 132) == 8 * 132 * sk.FMA_LANES == 8448
    assert sol.fill_lanes(1, 1) == sk.FMA_THREADS // sk.FMA_GROUP


_K6_P1_CUTS = {
    "condense2": {"no row jobs": "  // 2. the row jobs",
                  "no cost columns": "  // 3. the cost columns",
                  "no loads": "    return base[(size_t)r * B + b];",
                  "no stores": ("    if (valid) __stcs(base + (size_t)r * B"
                                " + b, v);")},
    "fma_chain": {},
}


@pytest.mark.parametrize("kernel, source, shapes, values", [
    ("condense2", "condensed_c2.cu",
     {"kernel": (8, 256), "4 workers": (4, 128), "16 workers": (16, 512),
      "64 lanes": (8, 512)}, 299),
    ("fma_chain", "sol_probes.cu",
     {"kernel": (16, 128), "16 lanes": (16, 256), "32 lanes": (16, 512),
      "2 blocks an SM": (16, 128), "packed 13": (13, 208),
      "packed 13, 32 lanes": (13, 416), "2 rows a thread": (8, 64),
      "4 rows a thread": (4, 32)}, 212)])
def test_k6_and_p1_variants_find_their_anchors(kernel, source, shapes,
                                               values, tmp_path):
    """K6's and P1's study variants: each cut's marker stands once in the
    source and the cut removes it (K6's stores summed into one kept alive
    behind B < 0), the shape edits give their launch shape (P1's from its
    own constants), and only the whole kernels are held against the plain
    version.  The `--baseline` source is the one-thread file of the same
    name, whose entry takes no launch shape; the study's inputs fit the
    entry and the plain version's outputs its shapes."""
    texts = kkt_variants.sources(kernel)
    src = texts["kernel"]
    for name, mark in _K6_P1_CUTS[kernel].items():
        assert src.count(mark) == 1 and mark not in texts[name], name
    if kernel == "condense2":
        assert "if (valid && B < 0) Abar[b] = sink;" in texts["no stores"]
    assert {n: kkt_variants.shape(texts[n], kernel) for n in shapes} == shapes
    assert kkt_variants.lane_values(kernel, src) == values
    assert [n for n in texts if kkt_variants._whole(n)] == list(shapes)
    (tmp_path / source).write_text(
        f"template <typename T>\n__global__ void\n{kernel}_kernel("
        f"const T* A) {{}}\n")
    assert kkt_variants.baseline_source(kernel, tmp_path) == source
    one_thread = (tmp_path / source).read_text()
    assert kkt_variants.lane_values(kernel, one_thread) is None
    assert kkt_variants.shape(one_thread, kernel) == (1, 128)
    args = kkt_variants.inputs(kernel, 4, "cpu")
    n_in, out_shapes, _ = kkt_variants.SWEEPS[kernel]
    assert len(args) == n_in and all(a.is_contiguous() for a in args)
    out = kkt_variants._plain(kernel)(*args)
    lead = args[0].shape[0] // 2 if kernel == "condense2" else 1
    assert [tuple(o.shape) for o in out] == list(out_shapes(lead, 4))


def test_bitwise_report_names_the_outputs_that_differ():
    """The study's comparison with the baseline's outputs: True when every
    output is equal bit for bit, else each differing output with its
    count of differing entries and its largest relative difference."""
    a = [torch.zeros(2, 3), torch.ones(4)]
    assert kkt_variants.bitwise_report(a, [t.clone() for t in a]) == "True"
    b = [a[0].clone(), a[1].clone()]
    b[1][2] = 1.5
    assert kkt_variants.bitwise_report(a, b) == (
        "False (output 1: 1 of 4 entries, 3.3e-01)")
