"""Rules the port keeps: no JAX, the card by default (constructors and the
roofline study take device=None as the card and raise without one), no
hidden fallback, every option of the batched step run on CPU tensors
through the plain versions, and the JAX package's ValueErrors kept."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from crazyflie_nmpc_tpu_torch import (bringup, convert, estimator, parallel,
                                      pid, tools)
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import (QuadrotorParams, firmware,
                                             hover_state, rotations)
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops import ipm_fast
from crazyflie_nmpc_tpu_torch.ops.cuda import _build
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol
from crazyflie_nmpc_tpu_torch.runtime import (batch, closed_loop, serving,
                                              swarm)
from crazyflie_nmpc_tpu_torch.solver import outputs
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from crazyflie_nmpc_tpu_torch.utils import trajectories
from _torch_shared import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "crazyflie_nmpc_tpu_torch").rglob("*.py")) + [
        "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "crazyflie_nmpc_tpu")


def _imported_roots(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_no_jax_rule_covers_every_subpackage():
    """Every module of the port is among the files the rule reads, the
    closed loop's subpackages (estimator, runtime, utils), the serving
    stack (runtime's serving and swarm, native, bringup) and the launch
    layer (bringup, tools, pid, demo, ops.riccati_pscan) included."""
    for sub in ("estimator", "runtime", "utils", "models", "ops", "solver",
                "roofline", "native", "parallel", "demo"):
        files = [p for p in PORT_FILES
                 if p.startswith(f"crazyflie_nmpc_tpu_torch/{sub}/")]
        assert f"crazyflie_nmpc_tpu_torch/{sub}/__init__.py" in files
    for mod in ("models/firmware.py", "estimator/lpf.py",
                "estimator/pipeline.py", "estimator/sysid.py",
                "utils/trajectories.py", "runtime/closed_loop.py",
                "runtime/batch.py", "runtime/serving.py", "runtime/swarm.py",
                "runtime/bag.py", "runtime/telemetry.py", "bringup.py",
                "native/__init__.py", "native/bindings.py",
                "native/channels.py", "native/firmware_sim.py",
                "native/hl_executor.py", "parallel/mesh.py",
                "parallel/pod.py", "parallel/sharded.py",
                "utils/profiling.py", "utils/checkpoint.py",
                "utils/config.py", "utils/debug.py", "utils/coherence.py",
                "utils/tree.py", "pid.py", "tools.py", "demo/hover.py",
                "demo/position.py", "demo/waypoints.py", "demo/mocap.py",
                "demo/teleop.py", "demo/full_state_stream.py",
                "ops/riccati_pscan.py"):
        assert f"crazyflie_nmpc_tpu_torch/{mod}" in PORT_FILES


@pytest.mark.parametrize("make", [
    lambda: ts.default_ocp(),
    lambda: hover_state(ts.default_ocp(device="cpu").params),
    lambda: ts.init_rti(ts.default_ocp(device="cpu"), torch.zeros(13)),
    lambda: ts.hover_yref(ts.default_ocp(device="cpu")),
    lambda: convert.state_from_numpy(torch.zeros(3, 13).numpy(),
                                     torch.zeros(2, 4).numpy()),
    lambda: ts.policies.regulation_state(),
    lambda: ts.policies.tracking_state(),
    lambda: ts.policies.regulation_table(ts.default_ocp(device="cpu")),
    lambda: convert.qp_from_numpy({}),
    lambda: ipm_iter_sol.study(8),
    lambda: trajectories.helix_trajectory(QuadrotorParams()),
    lambda: trajectories.smooth_step_trajectory(QuadrotorParams()),
    lambda: trajectories.sample_poly_trajectory([1.0], [[[0.0] * 8] * 4],
                                                QuadrotorParams()),
    lambda: convert.gains_from_numpy({"kp_att": 10.0}),
    lambda: convert.estimator_state_from_numpy({}),
    lambda: serving.ServingLoop(ts.default_ocp(N=6, device="cpu")),
    lambda: serving.measure_transport_floor(n=1),
    lambda: swarm.SwarmNMPC(ts.default_ocp(N=6, device="cpu"),
                            [[0.0, 0.0, 0.4]]),
    lambda: bringup.swarm_serving(n=1, ticks=1, base_port=0),
    lambda: parallel.init_distributed(),
    lambda: parallel.pod_rti_step(ts.default_ocp(N=6, device="cpu"),
                                  parallel.make_mesh()),
    lambda: parallel.batch_sharded_rti(ts.default_ocp(N=6, device="cpu"),
                                       parallel.make_mesh()),
    lambda: pid.default_gains(),
    lambda: pid.init_pid(),
    lambda: convert.pid_gains(pid.default_gains(device="cpu")),
    lambda: convert.pid_state(pid.init_pid(device="cpu")),
    lambda: bringup.nmpc_predictor(steps=1),
    lambda: bringup.nmpc_attitude_bench(steps=1, port=0),
    lambda: bringup.pid_waypoints(max_steps=1),
    lambda: bringup.system_identification(steps=1, port=0),
    lambda: tools.main(["fly", "--steps", "1"]),
], ids=["default_ocp", "hover_state", "init_rti", "hover_yref",
        "state_from_numpy", "regulation_state", "tracking_state",
        "regulation_table", "qp_from_numpy", "roofline_study",
        "helix_trajectory", "smooth_step_trajectory",
        "sample_poly_trajectory", "gains_from_numpy",
        "estimator_state_from_numpy", "ServingLoop",
        "measure_transport_floor", "SwarmNMPC", "swarm_serving",
        "init_distributed", "pod_rti_step", "batch_sharded_rti",
        "pid_default_gains", "init_pid", "pid_gains", "pid_state",
        "nmpc_predictor", "nmpc_attitude_bench", "pid_waypoints",
        "system_identification", "tools_fly"])
def test_constructors_need_a_gpu_unless_asked_for_the_cpu(monkeypatch,
                                                           make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("run", [
    lambda: rotations.quat_to_euler(torch.tensor([[1.0, 0.0, 0.0, 0.0]])),
    lambda: outputs.to_cmd_vel(torch.full((4,), 15.0),
                               torch.zeros(13)).thrust_pwm,
    lambda: ts.policies.make_yref(
        ts.default_ocp(N=4, device="cpu"),
        ts.policies.regulation_state(device="cpu"),
        ts.policies.regulation_table(ts.default_ocp(N=4, device="cpu"),
                                     device="cpu"))[0],
    lambda: ts.rti_step(*_single_cpu_problem(), IPMConfig(iters=2))[1].u0,
    lambda: firmware.attitude_plant_step(
        QuadrotorParams(), hover_state(QuadrotorParams(), device="cpu"),
        torch.tensor([0.0, 0.0, 0.0, 40000.0]), 0.015)[0],
    lambda: estimator.fuse(estimator.init_estimator(QuadrotorParams(),
                                                    torch.zeros(3)),
                           torch.zeros(3), torch.zeros(3), torch.zeros(3),
                           0.015)[1],
    lambda: closed_loop.hover_regulation(
        *_single_cpu_problem()[0:3:2], steps=2,
        config=closed_loop.LoopConfig(ipm=IPMConfig(iters=2))).u_cmd,
    lambda: batch.swarm_hover(
        _single_cpu_problem()[0], _single_cpu_problem()[2].expand(2, 13),
        torch.zeros(2, 3, dtype=torch.float64), 2,
        config=IPMConfig(iters=2)).u,
], ids=["rotations", "to_cmd_vel", "make_yref", "rti_step",
        "attitude_plant_step", "fuse", "hover_regulation", "swarm_hover"])
def test_tensor_functions_run_where_their_inputs_are(monkeypatch, run):
    """Functions on tensors take no device: with no GPU they run on CPU
    inputs (and make their own tensors there)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = run()
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


def _single_cpu_problem():
    spec = ts.default_ocp(N=4, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0 = hover_state(spec.params, dtype=torch.float64, device="cpu")
    return (spec, ts.init_rti(spec, x0, device="cpu"), x0, yref, yref_e)


@pytest.fixture(scope="module")
def small():
    spec = ts.default_ocp(N=6, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0s = (hover_state(spec.params, dtype=torch.float64, device="cpu")[None]
           + 0.02 * torch.randn(3, 13, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(0)))
    return spec, ts.init_rti(spec, x0s, device="cpu"), x0s, yref, yref_e


def test_cpu_tensors_take_the_plain_versions(small):
    spec, st, x0s, yref, yref_e = small
    kc.reset_launch_counts()
    _, out = rti_step_batched(spec, st, x0s, yref, yref_e,
                              IPMConfig(iters=3, escalate_iters=2,
                                        escalate_capacity=2))
    assert bool(torch.isfinite(out.u_plan).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


@pytest.mark.parametrize("option", ["windowed", "fused_iter"])
def test_sweep_options_run_the_plain_versions_on_cpu(small, option):
    """windowed=True and fused_iter=True run on CPU tensors through the
    plain versions, escalation included, and launch no kernel."""
    spec, st, x0s, yref, yref_e = small
    kc.reset_launch_counts()
    _, out = rti_step_batched(spec, st, x0s, yref, yref_e,
                              IPMConfig(iters=3, escalate_iters=2,
                                        escalate_capacity=2),
                              **{option: True})
    assert bool(torch.isfinite(out.u_plan).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


@pytest.mark.parametrize("change, kwargs", [
    ({}, dict(condense=1)),
    ({}, dict(fused_prep_condense=False)),
    ({}, dict(prep_batch_rows=2)),
    (dict(N=7), {}),
], ids=["condense", "fused_prep_condense", "prep_batch_rows", "odd_N"])
def test_uncondensed_and_unfused_paths_run_on_cpu(small, change, kwargs):
    """condense=1, the unfused preparation and odd horizons run on CPU
    tensors through the plain versions, escalation included, and launch
    no kernel."""
    spec, st, x0s, yref, yref_e = small
    if change:
        spec = dataclasses.replace(spec, **change)
        st = ts.init_rti(spec, x0s, device="cpu")
        yref, yref_e = ts.hover_yref(spec, device="cpu")
    kc.reset_launch_counts()
    _, out = rti_step_batched(spec, st, x0s, yref, yref_e,
                              IPMConfig(iters=3, escalate_iters=2,
                                        escalate_capacity=2), **kwargs)
    assert out.u_plan.shape == (3, spec.N, 4)
    assert bool(torch.isfinite(out.u_plan).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


@pytest.mark.parametrize("kwargs", [
    dict(config=IPMConfig(gondzio_correctors=1)),
    dict(config=IPMConfig(compress_gains=True)),
    dict(config=IPMConfig(compress_ab=True)),
    dict(prep_vde_order=2),
    dict(fused_prep=False),
], ids=lambda kw: next(iter(kw)) if "config" not in kw else
    next(k for k, v in vars(kw["config"]).items()
         if v != getattr(IPMConfig(), k)))
def test_unported_options_raise(small, kwargs):
    """The step's options, each ported: the XLA-style preparation
    (fused_prep=False), Gondzio correctors, the bf16 streams and the
    order-2 VDE run on CPU tensors through the plain versions (escalation
    included) and launch no kernel."""
    spec, st, x0s, yref, yref_e = small
    kw = dict(kwargs)
    cfg = dataclasses.replace(kw.pop("config", IPMConfig()), iters=3,
                              escalate_iters=2, escalate_capacity=2)
    kc.reset_launch_counts()
    _, out = rti_step_batched(spec, st, x0s, yref, yref_e, cfg, **kw)
    assert bool(torch.isfinite(out.u_plan).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


@pytest.mark.parametrize("change, error, match", [
    (dict(sim_steps=2), None, None),
    (dict(f=lambda p, x, u: x), ValueError, "rti_step"),
], ids=["sim_steps", "custom_ode"])
def test_unported_specs_raise(small, change, error, match):
    """sim_steps > 1 runs the XLA-style preparation on CPU tensors (plain
    PyTorch, then the plain sweeps) and launches no kernel; a custom model
    ODE is refused as in the JAX package (ValueError: such specs use
    solver.rti.rti_step)."""
    spec, st, x0s, yref, yref_e = small
    spec = dataclasses.replace(spec, **change)
    if error is not None:
        with pytest.raises(error, match=match):
            rti_step_batched(spec, st, x0s, yref, yref_e)
        return
    st = ts.init_rti(spec, x0s, device="cpu")
    kc.reset_launch_counts()
    _, out = rti_step_batched(spec, st, x0s, yref, yref_e,
                              IPMConfig(iters=3, escalate_iters=2,
                                        escalate_capacity=2))
    assert out.u_plan.shape == (3, spec.N, 4)
    assert bool(torch.isfinite(out.u_plan).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


def test_solve_batched_runs_condense_1(small):
    """solve_batched's default form (condense=1) on the stage-wise QP of
    the unfused preparation, through the plain sweeps."""
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import prepare_qp

    spec, st, x0s, yref, yref_e = small
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False,
                          fused_condense=False)
    kc.reset_launch_counts()
    sol = ipm_fast.solve_batched(qp, IPMConfig(iters=3))
    assert sol.dx.shape == (spec.N + 1, 13, 3)
    assert bool(torch.isfinite(sol.du).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


def test_solve_batched_refuses_the_split_uncondensed_sweeps(small):
    """fused=False runs the split uncondensed sweeps on CPU tensors through
    the plain versions (no kernel launched); with condense=2 it raises
    ValueError, as in the JAX package."""
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import prepare_qp

    spec, st, x0s, yref, yref_e = small
    _, _, qp = prepare_qp(spec, st, x0s, yref, yref_e, batch_last=False,
                          fused_condense=False)
    kc.reset_launch_counts()
    sol = ipm_fast.solve_batched(qp, IPMConfig(iters=3), fused=False)
    assert sol.dx.shape == (spec.N + 1, 13, 3)
    assert bool(torch.isfinite(sol.du).all())
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)
    with pytest.raises(ValueError, match="fused"):
        ipm_fast.solve_batched({}, IPMConfig(), fused=False, condense=2)


@pytest.mark.parametrize("bad, match", [
    ("dtype", "float32 or float64"),
    ("shape", "expected"),
    ("layout", "contiguous"),
    ("device", "expected"),
    ("bf16", "expected torch.float32"),
])
def test_kernel_input_checks_raise(bad, match):
    """What the wrappers check before any launch (bf16: a bfloat16 tensor
    not named as a compressed stream)."""
    good = torch.zeros(4, 3, dtype=torch.float32)
    t, dtype, device = good, torch.float32, good.device
    if bad == "dtype":
        t, dtype = good.half(), torch.float16
    elif bad == "bf16":
        t = good.bfloat16()
    elif bad == "shape":
        t = torch.zeros(4, 2)
    elif bad == "layout":
        t = torch.zeros(3, 4).t()
    elif bad == "device":
        device = torch.device("meta")
    with pytest.raises((TypeError, ValueError), match=match):
        _build.check("k", dict(a=t), dict(a=(4, 3)), dtype, device)


def test_kernel_input_checks_take_the_named_bf16_streams():
    """The compressed streams named in `bf16` must be bfloat16, the rest
    the working dtype."""
    f32 = torch.zeros(4, 3)
    shapes = dict(a=(4, 3), K=(4, 3))
    _build.check("k", dict(a=f32, K=f32.bfloat16()), shapes, torch.float32,
                 f32.device, bf16=("K",))
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        _build.check("k", dict(a=f32, K=f32), shapes, torch.float32,
                     f32.device, bf16=("K",))


def test_build_hash_covers_sources_and_flags():
    libs = {src: _build._lib_path(src) for src in _build.SOURCES}
    assert len(set(libs.values())) == len(libs)
    for src, lib in libs.items():
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(Path(src).stem + "-")


@pytest.mark.parametrize("package", ["crazyflie_nmpc_tpu",
                                     "crazyflie_nmpc_tpu.ops",
                                     "crazyflie_nmpc_tpu.estimator",
                                     "crazyflie_nmpc_tpu.native",
                                     "crazyflie_nmpc_tpu.runtime",
                                     "crazyflie_nmpc_tpu.models",
                                     "crazyflie_nmpc_tpu.parallel",
                                     "crazyflie_nmpc_tpu.utils",
                                     "crazyflie_nmpc_tpu.demo"])
def test_package_exports_match_jax(package):
    """Every public name the JAX package's `__init__` exports (its
    `__version__` too; submodules aside) is exported by the port's
    counterpart."""
    import importlib
    import inspect

    jax_pkg = importlib.import_module(package)
    port = importlib.import_module(package.replace(
        "crazyflie_nmpc_tpu", "crazyflie_nmpc_tpu_torch", 1))
    names = getattr(jax_pkg, "__all__", None) or [
        n for n in dir(jax_pkg)
        if (not n.startswith("_") or n == "__version__")
        and not inspect.ismodule(getattr(jax_pkg, n))]
    assert names
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


# Names the JAX package's `__init__`s export that the port does not have
# yet, each with its ROADMAP Queue 1 item.
UNPORTED_EXPORTS = {
    "crazyflie_nmpc_tpu.runtime": {},
    "crazyflie_nmpc_tpu.utils": {},
    "crazyflie_nmpc_tpu.models": {},
}


def _init_exports(package):
    """The names a package's `__init__.py` imports, read from its source
    (modules too; what else the process has imported does not count)."""
    path = ROOT / package.replace(".", "/") / "__init__.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


@pytest.mark.parametrize("package", sorted(UNPORTED_EXPORTS))
def test_subpackage_exports_match_jax_but_the_unported(package):
    """The port's runtime, utils and models export every name the JAX
    package's `__init__` does, except the listed unported ones; and
    those are indeed absent (the list is kept current)."""
    import importlib

    port = importlib.import_module(package.replace(
        "crazyflie_nmpc_tpu", "crazyflie_nmpc_tpu_torch", 1))
    unported = UNPORTED_EXPORTS[package]
    names = _init_exports(package)
    assert set(unported) <= names
    missing = sorted(n for n in names - set(unported)
                     if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"
    present = sorted(n for n in unported if n in _init_exports(
        port.__name__))
    assert not present, f"{present} are ported: drop them from the list"


@pytest.mark.parametrize("option", [dict(block_b=128),
                                    dict(stages_per_step=25),
                                    dict(interpret=True)],
                         ids=["block_b", "stages_per_step", "interpret"])
def test_pod_step_refuses_the_tpu_blocking_arguments(option):
    """`parallel/pod.py:72-76` of the JAX package passes them to its
    `rti_step_batched`; the port's has no counterpart (ROADMAP)."""
    with pytest.raises(TypeError, match=list(option)[0]):
        parallel.pod_rti_step(ts.default_ocp(N=6, device="cpu"),
                              parallel.make_mesh(), device="cpu", **option)


@pytest.mark.parametrize("batch,stage", [(2, 1), (1, 2), (2, 2)])
def test_make_mesh_raises_on_a_small_world(batch, stage):
    """One process (no torch.distributed) is a world of one rank, as one
    device is for JAX's `make_mesh` (`parallel/mesh.py:24-25`)."""
    with pytest.raises(ValueError, match=f"need {batch * stage} devices, "
                                         "have 1"):
        parallel.make_mesh(batch=batch, stage=stage)
    with pytest.raises(ValueError, match="have 3"):
        parallel.make_mesh(batch=2, stage=2, devices=[0, 1, 2])


def _check_group_geometry(geo, B, group, source, consts):
    """A group kernel's launch covers every lane exactly once, fits a
    block's shared memory, opts in above 48 KB, and uses the source's
    constants (`consts`: {name in the source: value})."""
    lanes = [blk * geo["lanes"] + i for blk in range(geo["grid"])
             for i in range(geo["lanes"])]
    assert sorted(b for b in lanes if b < B) == list(range(B))
    assert (geo["grid"] - 1) * geo["lanes"] < B      # no empty block
    assert geo["threads"] == geo["lanes"] * group
    assert geo["smem"] <= 232_448          # a block's most on the H100
    assert geo["smem"] <= 48 * 1024 or geo["opt_in"]
    assert geo["opt_in"] == (geo["smem"] > 48 * 1024)
    src = (_build.CSRC / source).read_text()
    for const, value in consts.items():
        assert (f"constexpr int {const} = {value};" in src
                or f"static_assert({const} == {value}," in src), const


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kkt_launch_geometry(B, dtype):
    """K2's launch (`_check_group_geometry`)."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    _check_group_geometry(ck.kkt_launch_geometry(B, dtype), B, ck.KKT_GROUP,
                          "kkt_sweep_c2.cu", {
                              "kGroup": ck.KKT_GROUP,
                              "kThreads": ck.KKT_THREADS,
                              "kStride": ck.KKT_LANE_VALUES})


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_corr_launch_geometry(B, dtype):
    """K3's launch (`_check_group_geometry`); its shared memory lets an SM
    hold 3 blocks in float32 and 1 in float64 (with the 1 KB each block
    reserves of the SM's 228 KB), and does not depend on M."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    geo = ck.corr_launch_geometry(B, dtype)
    _check_group_geometry(geo, B, ck.CORR_GROUP, "corrector_sweep_c2.cu", {
        "kGroup": ck.CORR_GROUP, "kThreads": ck.CORR_THREADS,
        "kLaneValues": ck.CORR_LANE_VALUES})
    blocks = {torch.float32: 3, torch.float64: 1}[dtype]
    assert blocks * (geo["smem"] + 1024) <= 228 * 1024
    assert 227 * 1024 // geo["smem"] == blocks


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_iter_launch_geometry(B, dtype):
    """K10's launch (K2's group and block, a lane of its own in
    csrc/iter_c2.cu; `_check_group_geometry`): 4 blocks an SM in float32
    and 2 in float64 (with the 1 KB each block reserves of the SM's 228
    KB), whatever M."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    geo = ck.iter_launch_geometry(B, dtype)
    _check_group_geometry(geo, B, ck.ITER_GROUP, "iter_c2.cu", {
        "kGroup": ck.ITER_GROUP, "kThreads": ck.ITER_THREADS,
        "kStride": ck.ITER_LANE_VALUES})
    blocks = {torch.float32: 4, torch.float64: 2}[dtype]
    assert blocks * (geo["smem"] + 1024) <= 228 * 1024
    assert 227 * 1024 // geo["smem"] == blocks


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kernel", ["bwd_c2", "fwd_c2"])
def test_windowed_launch_geometry(kernel, B, dtype):
    """K5a's launch (K2's group and block, a lane of its own in K2's
    source) and K5b's (K3's group and block, a lane of its own in K3's
    source; `_check_group_geometry`); each lets an SM hold 4
    blocks in float32 and 2 in float64 (with the 1 KB each block reserves
    of the SM's 228 KB), and neither depends on M."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    if kernel == "bwd_c2":
        geo = ck.bwd_launch_geometry(B, dtype)
        _check_group_geometry(geo, B, ck.KKT_GROUP, "kkt_sweep_c2.cu", {
            "kGroup": ck.KKT_GROUP, "kThreads": ck.KKT_THREADS,
            "kBwdStride": ck.BWD_LANE_VALUES})
    else:
        geo = ck.fwd_launch_geometry(B, dtype)
        _check_group_geometry(geo, B, ck.FWD_GROUP, "corrector_sweep_c2.cu", {
            "kGroup": ck.FWD_GROUP, "kThreads": ck.FWD_THREADS,
            "kFwdLaneValues": ck.FWD_LANE_VALUES})
    blocks = {torch.float32: 4, torch.float64: 2}[dtype]
    assert blocks * (geo["smem"] + 1024) <= 228 * 1024
    assert 227 * 1024 // geo["smem"] == blocks


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_riccati_launch_geometry(B, dtype):
    """K8a's and K9a's launch (K2's group and block, a lane of its own in
    csrc/riccati.cu; `_check_group_geometry`): its shared memory would let
    an SM hold 7 blocks in float32 and 3 in float64 (with the 1 KB each
    block reserves of the SM's 228 KB), so registers decide, and the
    float64 block needs the opt-in attribute; it does not depend on N."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    geo = rk.riccati_launch_geometry(B, dtype)
    _check_group_geometry(geo, B, rk.RICCATI_GROUP, "riccati.cu", {
        "kGroup": rk.RICCATI_GROUP, "kThreads": rk.RICCATI_THREADS,
        "kStride": rk.RICCATI_LANE_VALUES})
    blocks = {torch.float32: 7, torch.float64: 3}[dtype]
    assert blocks * (geo["smem"] + 1024) <= 228 * 1024
    assert 227 * 1024 // geo["smem"] == blocks
    assert geo["opt_in"] == (dtype == torch.float64)


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kernel", ["bwd_vec_c2", "forward_sweep"])
def test_k5c_and_k9b_launch_geometry(kernel, B, dtype):
    """K5c's launch (K3's group and block, a lane of its own in K3's
    source: 3 blocks an SM in float32, 1 in float64) and K9b's (K5b's
    group and block at 4 inputs, in csrc/riccati.cu beside K8a's
    constants: 5 and 2), by shared memory with the 1 KB each block
    reserves of the SM's 228 KB (`_check_group_geometry`); neither
    depends on the horizon."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    if kernel == "bwd_vec_c2":
        geo = ck.bwd_vec_launch_geometry(B, dtype)
        _check_group_geometry(geo, B, ck.BWD_VEC_GROUP,
                              "corrector_sweep_c2.cu", {
                                  "kGroup": ck.BWD_VEC_GROUP,
                                  "kThreads": ck.BWD_VEC_THREADS,
                                  "kVecLaneValues": ck.BWD_VEC_LANE_VALUES})
        blocks = {torch.float32: 3, torch.float64: 1}[dtype]
    else:
        geo = rk.forward_launch_geometry(B, dtype)
        _check_group_geometry(geo, B, rk.FORWARD_GROUP, "riccati.cu", {
            "kFwdGroup": rk.FORWARD_GROUP,
            "kFwdThreads": rk.FORWARD_THREADS,
            "kFwdLaneValues": rk.FORWARD_LANE_VALUES})
        blocks = {torch.float32: 5, torch.float64: 2}[dtype]
    assert blocks * (geo["smem"] + 1024) <= 228 * 1024
    assert 227 * 1024 // geo["smem"] == blocks


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_k8b_and_k9c_launch_geometry(B, dtype):
    """K8b's and K9c's launch (one body on K9b's group and block, its own
    lane of 1059 values, a ring of 3 sets, in csrc/riccati.cu;
    `_check_group_geometry`): with the 1 KB each block reserves of the
    SM's 228 KB, shared memory lets an SM hold 3 blocks in float32 (what
    `__launch_bounds__` asks for) and 1 in float64, and both blocks need
    the opt-in attribute; it does not depend on the horizon."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    geo = rk.vector_launch_geometry(B, dtype)
    _check_group_geometry(geo, B, rk.VECTOR_GROUP, "riccati.cu", {
        "kFwdGroup": rk.VECTOR_GROUP, "kFwdThreads": rk.VECTOR_THREADS,
        "kVecLaneValues": rk.VECTOR_LANE_VALUES, "kVecSets": 3})
    assert (rk.VECTOR_GROUP, rk.VECTOR_LANES) == (16, 16)
    blocks = {torch.float32: 3, torch.float64: 1}[dtype]
    assert 228 * 1024 // (geo["smem"] + 1024) == blocks
    assert geo["opt_in"]


@pytest.mark.parametrize("B", [1, 7, 1000, 1003, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_p2_launch_geometry(B, dtype):
    """P2's launch: K2's group and block (16 threads a lane, 8 lanes a
    block, K2's 1548 values a lane), the wrapper's REPLAY_* constants
    those of csrc/sol_probes.cu (`_check_group_geometry`), and the same
    numbers as K2's launch.  By shared memory an SM holds 4 blocks in
    float32 and 2 in float64 (with the 1 KB each block reserves of the
    SM's 228 KB), both over 48 KB, so the launch opts in."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk

    geo = sk.replay_launch_geometry(B, dtype)
    _check_group_geometry(geo, B, sk.REPLAY_GROUP, "sol_probes.cu", {
        "kGroup": sk.REPLAY_GROUP, "kThreads": sk.REPLAY_THREADS,
        "kStride": sk.REPLAY_LANE_VALUES})
    assert (sk.REPLAY_GROUP, sk.REPLAY_LANES) == (16, 8)
    assert geo == ck.kkt_launch_geometry(B, dtype)
    blocks = {torch.float32: 4, torch.float64: 2}[dtype]
    assert 228 * 1024 // (geo["smem"] + 1024) == blocks
    assert geo["opt_in"]


@pytest.mark.parametrize("B", [1, 7, 1000, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kernel", ["condense2", "fma_chain"])
def test_k6_and_p1_launch_geometry(kernel, B, dtype):
    """K6's launch (K1's block: 32 lanes of one stage pair, 8 threads a
    lane, 299 values a lane in csrc/condensed_c2.cu; the grid's second
    axis is the pairs) and P1's (16 threads a lane, K2's 8 lanes a
    block, b's 13 rows at pitch 16 and a 16-byte pad a lane in
    csrc/sol_probes.cu; `_check_group_geometry`).  By shared memory, with
    the 1 KB each block reserves of the SM's 228 KB, an SM would hold 5
    K6 blocks in float32 and 3 in float64, whose block needs the opt-in
    attribute (registers hold them to the 2 and 1 `__launch_bounds__`
    asks for); P1's blocks fit 29 and 16, above the 8 and 4 its
    registers allow."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk

    if kernel == "condense2":
        geo = ck.condense_launch_geometry(B, dtype)
        _check_group_geometry(
            geo, B, ck.CONDENSE_THREADS // ck.CONDENSE_LANES,
            "condensed_c2.cu", {"kLanes": ck.CONDENSE_LANES,
                                "kThreads": ck.CONDENSE_THREADS,
                                "kLaneValues": ck.CONDENSE_LANE_VALUES})
        assert (ck.CONDENSE_LANES, geo["threads"]) == (32, 256)
        blocks = {torch.float32: 5, torch.float64: 3}[dtype]
        assert geo["opt_in"] == (dtype == torch.float64)
    else:
        geo = sk.fma_launch_geometry(B, dtype)
        _check_group_geometry(geo, B, sk.FMA_GROUP, "sol_probes.cu", {
            "kFmaGroup": sk.FMA_GROUP, "kFmaThreads": sk.FMA_THREADS,
            "kFmaLaneValues": sk.FMA_LANE_VALUES})
        assert (sk.FMA_GROUP, sk.FMA_LANES) == (16, 8)
        blocks = {torch.float32: 29, torch.float64: 16}[dtype]
        assert not geo["opt_in"]
    assert 228 * 1024 // (geo["smem"] + 1024) == blocks
