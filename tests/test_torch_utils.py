"""The port's `utils` remainder against the JAX package's, on the CPU:
checkpoints and config JSON interchangeable in both directions, the
coherence audit on the JAX tests' cases, the debug plane on trees of
tensors, the profiler trace, and the tree order the checkpoint relies
on (the JAX leaf order)."""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.solver import default_ocp as jdefault_ocp
from crazyflie_nmpc_tpu.solver import init_rti as jinit_rti
from crazyflie_nmpc_tpu.solver import policies as jpolicies
from crazyflie_nmpc_tpu.solver.ocp import default_cost as jdefault_cost
from crazyflie_nmpc_tpu.utils import checkpoint as jcheckpoint
from crazyflie_nmpc_tpu.utils import coherence as jcoherence
from crazyflie_nmpc_tpu.utils import config as jconfig
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import hover_state
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from crazyflie_nmpc_tpu_torch.utils import (checkpoint, coherence, config,
                                            debug, profiling, tree)
from _torch_shared import one_torch_thread  # noqa: F401

N, B = 10, 4


def _x0s(seed=3):
    rng = np.random.default_rng(seed)
    x = hover_state(ts.default_ocp(N=N, device="cpu").params,
                    dtype=torch.float64, device="cpu").numpy()
    return x + 0.05 * rng.standard_normal((B, 13))


def _jax_tree(x0s):
    """A carried swarm state of the JAX package: the batched RTIState, a
    policy state, and a dict with a None entry."""
    spec = jdefault_ocp(N=N, dtype=jnp.float64)
    st = jax.vmap(lambda x: jinit_rti(spec, x))(jnp.asarray(x0s))
    return {"rti": st, "policy": jpolicies.tracking_state((0.1, 0.2, 0.3)),
            "extra": (jnp.arange(3.0), None)}


def _port_tree(x0s):
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    st = ts.init_rti(spec, torch.as_tensor(x0s), device="cpu")
    return {"rti": st,
            "policy": ts.policies.tracking_state((0.1, 0.2, 0.3),
                                                 device="cpu"),
            "extra": (torch.arange(3.0, dtype=torch.float64), None)}


def test_tree_order_is_jax_order():
    x0s = _x0s()
    jleaves = jax.tree.leaves(_jax_tree(x0s))
    pleaves, _ = tree.flatten(_port_tree(x0s))
    assert len(pleaves) == len(jleaves)
    for j, p in zip(jleaves, pleaves):
        assert tuple(p.shape) == np.shape(j)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12)
    paths = [tree.keystr(p) for p, _ in tree.flatten_with_path(
        _port_tree(x0s))]
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(_jax_tree(x0s))[0]]
    assert paths == jpaths


def _scramble(t):
    """The same structure with every leaf zeroed: what a resume loads
    into."""
    return tree.tree_map(torch.zeros_like, t)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_interchange(tmp_path, direction):
    """A swarm state saved by one package loads, leaf for leaf, in the
    other; loaded in the port it resumes: the next batched step equals
    the step from the port's own state."""
    x0s = _x0s()
    path = str(tmp_path / "swarm.npz")
    if direction == "jax_to_port":
        jcheckpoint.save_state(path, _jax_tree(x0s))
        got = checkpoint.load_state(path, _scramble(_port_tree(x0s)))
        want = jax.tree.leaves(_jax_tree(x0s))
        leaves = [x.numpy() for x in tree.flatten(got)[0]]
        assert isinstance(got["rti"], ts.RTIState)
        assert got["policy"].mode.dtype == torch.int32
    else:
        checkpoint.save_state(path, _port_tree(x0s))
        like = jax.tree.map(jnp.zeros_like, _jax_tree(x0s))
        got = jcheckpoint.load_state(path, like)
        want = [x.numpy() for x in tree.flatten(_port_tree(x0s))[0]]
        leaves = [np.asarray(x) for x in jax.tree.leaves(got)]
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if direction == "jax_to_port":
        spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
        yref, yref_e = ts.hover_yref(spec, device="cpu")
        x = torch.as_tensor(x0s)
        cfg = IPMConfig(iters=8)
        _, resumed = rti_step_batched(spec, got["rti"], x, yref, yref_e, cfg)
        _, own = rti_step_batched(spec, _port_tree(x0s)["rti"], x, yref,
                                  yref_e, cfg)
        assert float((resumed.u_plan - own.u_plan).abs().max()) < 1e-10


def test_checkpoint_keeps_dtype_and_device_of_like(tmp_path):
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, {"a": torch.arange(4, dtype=torch.float64),
                                 "n": np.float32(2.5)})
    back = checkpoint.load_state(path, {"a": torch.zeros(4),
                                        "n": np.float64(0.0)})
    assert back["a"].dtype == torch.float32
    assert back["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert back["n"].dtype == np.float64 and float(back["n"]) == 2.5


def _app(pkg):
    return pkg.AppConfig(
        controller=pkg.ControllerConfig(
            tracking=True, setpoint=(1.0, 2.0, 3.0), ipm_iters=12,
            horizon=20, tf=0.3, wn_factor=25.0,
            q_diag=(200.0,) + (1.0,) * 12, r_diag=(0.1,) * 4),
        estimator=pkg.EstimatorConfig(delay=0.06, predictor_substeps=2))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_config_json_interchange(tmp_path, direction):
    """The JSON one package writes loads in the other to the same
    dataclasses (the same JSON again), and builds the same OCP."""
    src, dst = (jconfig, config) if direction == "jax_to_port" else (
        config, jconfig)
    p = tmp_path / "app.json"
    _app(src).save(str(p))
    back = dst.AppConfig.load(str(p))
    assert back == dst.AppConfig.from_json(_app(dst).to_json())
    assert back.to_json() == _app(src).to_json()
    assert back.controller.ipm().iters == 12

    c = config.AppConfig.load(str(p)).controller
    jc = jconfig.AppConfig.load(str(p)).controller
    spec = dataclasses.replace(
        ts.default_ocp(N=c.horizon, tf=c.tf, dtype=torch.float64,
                       device="cpu"),
        cost=ts.default_cost(c.q_diag, c.r_diag, c.wn_factor,
                             dtype=torch.float64, device="cpu"))
    jspec = dataclasses.replace(
        jdefault_ocp(N=jc.horizon, tf=jc.tf, dtype=jnp.float64),
        cost=jdefault_cost(np.asarray(jc.q_diag), np.asarray(jc.r_diag),
                           jc.wn_factor, dtype=jnp.float64))
    assert spec.N == jspec.N == 20
    for name in ("W", "W_e", "Vx", "Vu", "Vx_e"):
        np.testing.assert_array_equal(getattr(spec.cost, name).numpy(),
                                      np.asarray(getattr(jspec.cost, name)))
    np.testing.assert_array_equal(spec.dt.numpy(), np.asarray(jspec.dt))


def test_config_defaults_match_jax():
    assert config.AppConfig().to_json() == jconfig.AppConfig().to_json()


_GOOD_PARITY = dict(fused_iter_du=5.7e-6, windowed_du=0.0,
                    longN_vs_xla_du=5.28e-3, longN_vs_xla_du_rel=2.4e-4,
                    longN_windowed_vs_f64=3.1e-3, longN_xla_vs_f64=2.7e-3)
_SERVING = {"sync_66hz": {"p50_ms": 27.0, "p99_ms": 91.0}}
# tests/test_runtime_extras.py's cases: a coherent run, a windowed-kernel
# regression, the contaminated-run signature, a partial artifact
COHERENCE_CASES = {
    "good": dict(
        b_sweep={"1024": 260800.0, "2048": 264800.0, "4096": 242400.0,
                 "8192": 226300.0},
        certified={"esc16": 182100.0, "esc32": 168600.0},
        serving=_SERVING, parity=_GOOD_PARITY,
        swarm=dict(n_vehicles=16, ticks=200, final_err_max_m=0.05,
                   stale_ticks=12)),
    "regressed": dict(
        b_sweep={"1024": 260800.0, "2048": 264800.0},
        certified={"esc16": 182100.0, "esc32": 168600.0},
        serving=_SERVING,
        parity=dict(fused_iter_du=5.7e-6, windowed_du=0.0,
                    longN_vs_xla_du=0.31, longN_vs_xla_du_rel=1.4e-2,
                    longN_windowed_vs_f64=0.30, longN_xla_vs_f64=2.7e-3),
        swarm=dict(n_vehicles=16, ticks=200, final_err_max_m=0.9,
                   stale_ticks=2000)),
    "bad": dict(
        b_sweep={"1024": 310000.0, "2048": 150000.0, "4096": 240000.0,
                 "8192": 225000.0},
        certified={"esc16": 150000.0, "esc32": 170000.0},
        serving={"sync_66hz": {"p50_ms": 30.0, "p99_ms": 2300.0}}),
    "partial": dict(
        b_sweep={"1024": 260000.0, "2048": 264000.0}, certified=None,
        serving={"error": "RuntimeError: tunnel"}),
}
COHERENCE_OK = {"good": True, "regressed": False, "bad": None,
                "partial": None}


@pytest.mark.parametrize("case", sorted(COHERENCE_CASES))
def test_coherence_matches_jax(case):
    got = coherence.run_coherence(**COHERENCE_CASES[case])
    assert got == jcoherence.run_coherence(**COHERENCE_CASES[case])
    assert got["ok"] is COHERENCE_OK[case]
    if case == "bad":      # fails its checks; parity and swarm skipped
        assert not (got["b_sweep_consistent"] or got["esc16_not_slower"]
                    or got["serving_p99_same_order"])


def test_check_finite_and_fallback():
    """The JAX test's cases (tests/test_runtime_extras.py), on tensors,
    and a nested tree whose report names the leaf by its path."""
    good = {"a": torch.ones(3), "b": torch.zeros((2, 2))}
    debug.check_finite(good)  # no raise
    bad = {"a": torch.tensor([1.0, float("nan")]), "b": torch.zeros(2)}
    with pytest.raises(FloatingPointError, match="a"):
        debug.check_finite(bad, where="test")
    state = ts.RTIState(x_traj=torch.zeros(3, 13),
                        u_traj=torch.tensor([[float("inf")] * 4]))
    with pytest.raises(FloatingPointError,
                       match=r"\['s'\]\.u_traj: 4 non-finite"):
        debug.check_finite({"s": state})

    fb = {"a": torch.zeros(2), "b": torch.ones(2)}
    out = debug.finite_or_fallback(bad, fb)
    assert out["a"].tolist() == [0.0, 0.0] and out["b"].tolist() == [1.0,
                                                                      1.0]
    out2 = debug.finite_or_fallback({"a": torch.ones(2),
                                     "b": torch.ones(2)}, fb)
    assert out2["a"].tolist() == [1.0, 1.0]


def test_assert_deterministic():
    spec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    x0 = torch.as_tensor(_x0s())

    def run():
        st = ts.init_rti(spec, x0, device="cpu")
        return rti_step_batched(spec, st, x0, yref, yref_e,
                                IPMConfig(iters=4))
    debug.assert_deterministic(run)

    calls = []

    def drifting():
        calls.append(1)
        return {"v": torch.full((2,), float(len(calls)))}
    with pytest.raises(AssertionError, match="differs"):
        debug.assert_deterministic(drifting)


def test_profiler_trace_capture(tmp_path):
    """A trace is written with the named phases in it (the JAX test's
    check, tests/test_runtime_extras.py, on torch.profiler)."""
    import json

    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.phase("test-phase"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = profiling.trace_files(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "test-phase" in names


class _Pair(NamedTuple):
    a: object
    b: object


def test_tree_roundtrip_and_statics():
    @dataclasses.dataclass(frozen=True)
    class Spec:
        w: object
        n: int = dataclasses.field(default=5, metadata=dict(static=True))

    t = {"z": _Pair(torch.ones(1), [torch.zeros(2), None]),
         "a": Spec(w=torch.full((3,), 2.0), n=7)}
    leaves, treedef = tree.flatten(t)
    assert [x.shape[0] for x in leaves] == [3, 1, 2]     # sorted keys
    back = tree.unflatten(treedef, [x + 1 for x in leaves])
    assert back["a"].n == 7 and isinstance(back["z"], _Pair)
    assert back["z"].b[1] is None and back["a"].w.tolist() == [3.0] * 3
    with pytest.raises(ValueError, match="more leaves"):
        tree.unflatten(treedef, leaves + [torch.ones(1)])
