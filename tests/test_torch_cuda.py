"""The port's CUDA kernels on the card (`cuda` marker; skip without one).

This file imports torch and the port only, so on a GPU machine without
JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held against its plain version on the card with a ragged
lane count (37) that exercises the masked edge (the uncondensed
preparation and sweeps at an odd horizon too), and the batched step on
the card (the default path, the certified one, fused_iter=True,
windowed=True, condense=1 at an odd horizon, fused_prep_condense=False,
the split uncondensed sweeps, Gondzio correctors and the throughput mode)
against the same lanes through the plain versions on the CPU.
"""

import pytest
import torch

from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops import ipm_fast
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig, certified_config
from crazyflie_nmpc_tpu_torch.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (prepare_qp,
                                                         rti_step_batched,
                                                         rti_update,
                                                         to_batch_last)

B = 37


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 11])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol, n):
    """Every kernel and form at N=10; at the odd N=11 the uncondensed
    ones (the only ones that take an odd horizon)."""
    import chip_smoke

    inputs = chip_smoke.kernel_inputs(B, dtype, cuda_device, n=n)
    assert len(inputs) == (len(kc.KERNELS) + len(chip_smoke.FORMS)
                           if n % 2 == 0 else
                           len(chip_smoke.UNCONDENSED_KERNELS))
    for label, (kern, ref, args) in inputs.items():
        name = chip_smoke.FORMS.get(label, label)
        before = kc.launch_counts()[name]
        got = chip_smoke.flat(kern(*chip_smoke.fresh(args)))
        want = chip_smoke.flat(ref(*args))
        _, rel = chip_smoke.compare(got, want)
        assert rel <= tol, (label, rel)
        assert kc.launch_counts()[name] == before + 1, label


K2_FORMS = ("kkt_sweep_c2", "kkt_sweep_c2 bf16 gains",
            "kkt_sweep_c2 bf16 stream", "kkt_sweep_c2 bf16 gains+stream")
K3_FORMS = ("corrector_sweep_c2", "corrector_sweep_c2 bf16 gains",
            "corrector_sweep_c2 bf16 stream",
            "corrector_sweep_c2 bf16 gains+stream")


def _check_forms(device, dtype, tol, lanes, M, name, labels):
    """Each form in `labels` of the group kernel `name` against the plain
    version, one launch each.  At M=200 in float32 both evaluations drift
    apart through the recursion, so each is held to the float64 answer on
    the same inputs instead: the kernel's error there may be at most 3x
    the plain float32 version's (or the tolerance), chip_smoke's N=400
    rule."""
    import chip_smoke

    inputs = chip_smoke.kernel_inputs(lanes, dtype, device, n=2 * M)
    for label in labels:
        kern, ref, args = inputs[label]
        before = kc.launch_counts()[name]
        got = chip_smoke.flat(kern(*args))
        assert kc.launch_counts()[name] == before + 1, label
        want = chip_smoke.flat(ref(*args))
        if M < 200 or dtype == torch.float64:
            _, rel = chip_smoke.compare(got, want)
            assert rel <= tol, (label, rel)
            continue
        exact = chip_smoke.flat(ref(*[
            a.double() if a.dtype == torch.float32 else a for a in args]))
        _, e_kern = chip_smoke.compare(got, exact)
        _, e_plain = chip_smoke.compare(want, exact)
        assert e_kern <= max(tol, 3 * e_plain), (label, e_kern, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 25, 200])
@pytest.mark.parametrize("lanes", [1, 7, 1000])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_kkt_sweep_c2_forms_on_card(cuda_device, dtype, tol, lanes, M):
    """K2's group kernel, all four forms, against the plain version at a
    partial lane tile (1, 7) and a partial last block (1000), over 1, 25
    and 200 condensed stages (`_check_forms`)."""
    _check_forms(cuda_device, dtype, tol, lanes, M, "kkt_sweep_c2",
                 K2_FORMS)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 25, 200])
@pytest.mark.parametrize("lanes", [1, 7, 1000])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_corrector_sweep_c2_forms_on_card(cuda_device, dtype, tol, lanes, M):
    """K3's group kernel, all four forms, against the plain version over
    1, 25 and 200 condensed stages (`_check_forms`): at 1 and 7 lanes one
    ragged tile (the value-by-value copies), at 1000 62 full tiles whose
    rows are 16-byte aligned in every dtype (the 16-byte copies) and a
    ragged one."""
    _check_forms(cuda_device, dtype, tol, lanes, M, "corrector_sweep_c2",
                 K3_FORMS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
def test_probes_match_plain_on_card(cuda_device, dtype, tol):
    """The speed-of-light probes fma_chain and stage_replay against their
    plain versions (the masked lane edge at B=37), one launch each, on
    inputs whose output depends on every product and stage: the kernel
    also disagrees with the plain version one unrolled group of products
    or one stage short."""
    import chip_smoke
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
    from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol as sol

    fma, replay = sol.probe_inputs(B, dtype, cuda_device, parity=True)
    for name, fn, plain, args, reps, step in (
            ("fma_chain", sk.fma_chain, sk.fma_chain_plain, fma, 48,
             sk.UNROLL),
            ("stage_replay", sk.stage_replay, sk.stage_replay_plain, replay,
             7, 1)):
        before = kc.launch_counts(kc.PROBES)[name]
        got = chip_smoke.flat(fn(*args, reps=reps))
        want = chip_smoke.flat(plain(*args, reps=reps))
        _, rel = chip_smoke.compare(got, want)
        assert rel <= tol, (name, rel)
        _, rel_short = chip_smoke.compare(
            got, chip_smoke.flat(plain(*args, reps=reps - step)))
        assert rel_short > tol, (name, rel_short)
        assert kc.launch_counts(kc.PROBES)[name] == before + 1, name
    assert sk.blocks_per_sm("fma_chain", dtype) >= 1


def _step(device, x0s, config, N=10, fused=True, sim_steps=1, **opts):
    """One batch-last step: `rti_step_batched`, or with fused=False the
    stage QP of `prepare_qp(fused_condense=False)` solved by
    `solve_batched(fused=False)` (the split uncondensed sweeps) with the
    step's update `rti_update`."""
    spec = default_ocp(N=N, sim_steps=sim_steps, dtype=torch.float64,
                       device=device)
    yref, yref_e = hover_yref(spec, device=device)
    x0s = x0s.to(device)
    st = to_batch_last(init_rti(spec, x0s, device=device))
    if fused:
        return rti_step_batched(spec, st, x0s, yref, yref_e, config,
                                layout="batch_last", **opts)[1]
    x_bl, u_bl, qp = prepare_qp(spec, st, x0s, yref, yref_e, True,
                                fused_condense=False)
    sol = ipm_fast.solve_batched(qp, config, fused=False)
    return rti_update(qp, sol, x_bl, u_bl, True)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("config", [IPMConfig(iters=8),
                                    certified_config(capacity=8)],
                         ids=["iters8", "certified"])
def test_rti_step_on_card_matches_cpu(cuda_device, config):
    gen = torch.Generator().manual_seed(4)
    x0s = torch.zeros(B, 13, dtype=torch.float64)
    x0s[:, 3] = 1.0
    x0s += 0.05 * torch.randn(B, 13, generator=gen, dtype=torch.float64)
    x0s[:5, 0] += 1.5                 # saturating lanes that escalate
    kc.reset_launch_counts()
    card = _step(cuda_device, x0s, config)
    counts = kc.launch_counts()
    cpu = _step("cpu", x0s, config)
    iters = config.iters + (config.escalate_iters
                            if config.escalate_capacity else 0)
    assert counts["prep_condense2"] == 1
    assert counts["kkt_sweep_c2"] == counts["corrector_sweep_c2"] == iters
    _assert_close(card, cpu)


def _assert_close(card, cpu, tol=1e-8):
    for field in ("u0", "x_plan", "u_plan", "kkt_res"):
        got, want = getattr(card, field).cpu(), getattr(cpu, field)
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol * scale, field


@pytest.mark.cuda
@pytest.mark.parametrize("option, per_iter", [
    ("fused_iter", dict(iter_sweep_c2=1)),
    ("windowed", dict(bwd_c2=1, bwd_vec_c2=1, fwd_c2=2)),
])
def test_sweep_options_on_card_match_cpu(cuda_device, option, per_iter):
    """fused_iter=True and windowed=True on the card: their kernels, and
    no other sweep kernel, launch once per iteration (fwd_c2 twice), and
    the step matches the CPU's plain versions."""
    gen = torch.Generator().manual_seed(5)
    x0s = torch.zeros(B, 13, dtype=torch.float64)
    x0s[:, 3] = 1.0
    x0s += 0.05 * torch.randn(B, 13, generator=gen, dtype=torch.float64)
    x0s[:5, 0] += 1.5
    config = IPMConfig(iters=8)
    kc.reset_launch_counts()
    card = _step(cuda_device, x0s, config, **{option: True})
    counts = kc.launch_counts()
    cpu = _step("cpu", x0s, config, **{option: True})
    want = dict.fromkeys(kc.KERNELS, 0)
    want.update(prep_condense2=1, expand2=1,
                **{k: v * config.iters for k, v in per_iter.items()})
    assert counts == want
    _assert_close(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("N, opts, per_step, per_iter", [
    (9, {}, dict(prep_sweep=1), dict(kkt_sweep=1, corrector_sweep=1)),
    (10, dict(fused_prep_condense=False),
     dict(prep_sweep=1, condense2=1, expand2=1),
     dict(kkt_sweep_c2=1, corrector_sweep_c2=1)),
], ids=["odd_N", "unfused_prep"])
def test_uncondensed_and_unfused_paths_on_card_match_cpu(
        cuda_device, N, opts, per_step, per_iter):
    """The odd horizon (condense=1: prep_sweep, kkt_sweep,
    corrector_sweep) and fused_prep_condense=False (prep_sweep, condense2,
    the condensed sweeps, the stride-2 expand2) on the card launch exactly
    their kernels and match the CPU's plain versions."""
    gen = torch.Generator().manual_seed(6)
    x0s = torch.zeros(B, 13, dtype=torch.float64)
    x0s[:, 3] = 1.0
    x0s += 0.05 * torch.randn(B, 13, generator=gen, dtype=torch.float64)
    x0s[:5, 0] += 1.5
    config = IPMConfig(iters=8)
    kc.reset_launch_counts()
    card = _step(cuda_device, x0s, config, N=N, **opts)
    counts = kc.launch_counts()
    cpu = _step("cpu", x0s, config, N=N, **opts)
    want = dict.fromkeys(kc.KERNELS, 0)
    want.update(**per_step,
                **{k: v * config.iters for k, v in per_iter.items()})
    assert counts == want
    _assert_close(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("N, config, opts, per_step, per_iter, tol", [
    (9, IPMConfig(iters=8), dict(fused=False), dict(prep_sweep=1),
     dict(backward_sweep=1, forward_sweep=2, backward_vector_sweep=1), 1e-8),
    (10, IPMConfig(iters=5, gondzio_correctors=2), {},
     dict(prep_condense2=1, expand2=1),
     dict(kkt_sweep_c2=1, corrector_sweep_c2=3), 1e-8),
    (9, IPMConfig(iters=5, gondzio_correctors=2), {}, dict(prep_sweep=1),
     dict(kkt_sweep=1, corrector_sweep=3), 1e-8),
    # bf16 gains: a float64 difference in the last bits can move a gain by
    # one bf16 rounding step, which moves the step by ~1e-7 of its scale
    (10, IPMConfig(iters=8, compress_gains=True, compress_ab=True),
     dict(prep_vde_order=2), dict(prep_condense2=1, expand2=1),
     dict(kkt_sweep_c2=1, corrector_sweep_c2=1), 1e-5),
], ids=["split", "gondzio_c2", "gondzio_odd_N", "throughput_mode"])
def test_solver_options_on_card_match_cpu(cuda_device, N, config, opts,
                                          per_step, per_iter, tol):
    """solve_batched(fused=False) (the K9 kernels), Gondzio correctors and
    the throughput mode (bf16-stream K2/K3 forms, order-2 K1) on the card
    launch exactly their kernels and match the CPU's plain versions."""
    gen = torch.Generator().manual_seed(7)
    x0s = torch.zeros(B, 13, dtype=torch.float64)
    x0s[:, 3] = 1.0
    x0s += 0.05 * torch.randn(B, 13, generator=gen, dtype=torch.float64)
    x0s[:5, 0] += 1.5
    kc.reset_launch_counts()
    card = _step(cuda_device, x0s, config, N=N, **opts)
    counts = kc.launch_counts()
    cpu = _step("cpu", x0s, config, N=N, **opts)
    want = dict.fromkeys(kc.KERNELS, 0)
    want.update(**per_step,
                **{k: v * config.iters for k, v in per_iter.items()})
    assert counts == want
    _assert_close(card, cpu, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(fused_prep=False), dict(sim_steps=2)],
                         ids=["fused_prep_false", "sim_steps2"])
def test_xla_preparation_on_card_matches_cpu(cuda_device, opts):
    """The XLA-style preparation on the card (plain PyTorch, jacfwd), then
    condense2, the condensed sweeps and the stride-2 expand2: exactly those
    kernels, and the CPU's answer."""
    gen = torch.Generator().manual_seed(8)
    x0s = torch.zeros(B, 13, dtype=torch.float64)
    x0s[:, 3] = 1.0
    x0s += 0.05 * torch.randn(B, 13, generator=gen, dtype=torch.float64)
    x0s[:5, 0] += 1.5
    config = IPMConfig(iters=8)
    kc.reset_launch_counts()
    card = _step(cuda_device, x0s, config, **opts)
    counts = kc.launch_counts()
    cpu = _step("cpu", x0s, config, **opts)
    want = dict.fromkeys(kc.KERNELS, 0)
    want.update(condense2=1, expand2=1, kkt_sweep_c2=config.iters,
                corrector_sweep_c2=config.iters)
    assert counts == want
    _assert_close(card, cpu)


@pytest.mark.cuda
def test_single_rti_step_on_card_matches_cpu(cuda_device):
    """solver.rti.rti_step on the card: with escalation off no host sync
    (set_sync_debug_mode("error")), no hand-written kernel; two chained
    ticks and a certified one match the CPU's."""
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as Cfg
    from crazyflie_nmpc_tpu_torch.solver import rti_step

    def problem(device):
        """spec, yref, yref_e, x0, warm start on `device` (made before the
        sync check: a tensor made from host values is a copy)."""
        spec = default_ocp(N=10, dtype=torch.float64, device=device)
        yref, yref_e = hover_yref(spec, device=device)
        x0 = torch.zeros(13, dtype=torch.float64)
        x0[3], x0[0] = 1.0, 1.5
        x0 = x0.to(device)
        return spec, yref, yref_e, x0, init_rti(spec, x0, device=device)

    def ticks(prob, config, n):
        spec, yref, yref_e, x0, st = prob
        outs = []
        for _ in range(n):
            st, out = rti_step(spec, st, x0, yref, yref_e, config)
            outs.append(out)
        return outs

    card, cpu = problem(cuda_device), problem("cpu")
    ticks(card, Cfg(iters=8), 1)                     # warm-up
    kc.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ticks(card, Cfg(iters=8), 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)
    for g, w in zip(got, ticks(cpu, Cfg(iters=8), 2)):
        _assert_close(g, w)
    _assert_close(ticks(card, certified_config(), 1)[0],
                  ticks(cpu, certified_config(), 1)[0])
