"""The serving loop (`runtime.serving`) vs the JAX package's, on the CPU.

The scheduler and report tests of tests/test_serving.py with a fake
clock; the 30-tick plant-in-the-loop run at N=16 (15 ms stages), float64,
at depth 0, depth 2 and depth 2 without the gap prediction, held tick by
tick against JAX's `ServingLoop(use_fused=False)` (each JAX program jitted
once): the port's per-lane path (`use_fused=False`, `rti_step` per lane)
to 1e-9 kRPM, its batched path (`rti_step_batched`, the plain K1-K4
versions on the CPU: the block-2 condensed solve) at depth 2 to 1e-5
(measured 1.5e-6 at both depths: eight Mehrotra iterations of the
condensed and the stage-wise problem stop at slightly different
points).  The no-prediction arm
diverges in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import dynamics as jdynamics
from crazyflie_nmpc_tpu.models import hover_state as jhover_state
from crazyflie_nmpc_tpu.ops.integrators import rk4_step as jrk4_step
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.runtime import serving as jserving
from crazyflie_nmpc_tpu.solver import default_ocp as jdefault_ocp
from crazyflie_nmpc_tpu.solver import hover_yref as jhover_yref
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch.models import dynamics
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime.serving import (ServeConfig,
                                                      ServeReport,
                                                      ServingLoop,
                                                      TickScheduler,
                                                      measure_transport_floor)
from crazyflie_nmpc_tpu_torch.solver import default_ocp, hover_yref
from _torch_shared import one_torch_thread  # noqa: F401

N, TICKS = 16, 30
SETPOINT = (0.0, 0.0, 0.4)
START = (0.15, -0.1, 0.2)
TOL_LANE = 1e-9
TOL_BATCHED = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += max(s, 1e-4)

    def spend(self, s):
        self.t += s


def test_scheduler_absolute_anchoring():
    clk = FakeClock()
    sched = TickScheduler(0.015, clock=clk, sleep=clk.sleep)
    sched.start()
    # a slow tick must not shift later ticks' scheduled starts
    sched.wait_for_tick(0)
    clk.spend(0.040)  # tick 0 overruns by 2.5 periods
    t2 = sched.wait_for_tick(2)
    assert t2 == pytest.approx(0.040, abs=1e-9)  # already past: no wait
    t4 = sched.wait_for_tick(4)
    assert t4 == pytest.approx(4 * 0.015, abs=2e-3)  # back on schedule


def test_scheduler_counts_slips():
    clk = FakeClock()
    sched = TickScheduler(0.015, clock=clk, sleep=clk.sleep)
    sched.start()
    sched.wait_for_tick(0)
    clk.spend(0.015 + 0.010)  # next start slips by 10 ms > period/2
    sched.wait_for_tick(1)
    sched.wait_for_tick(2)  # on time again
    assert sched.slips == 1


def test_report_deadline_semantics():
    cfg = ServeConfig(rate_hz=100.0, budget_s=0.010, pipeline_depth=0)
    rep = ServeReport(config=cfg,
                      latency_s=np.array([0.004, 0.009, 0.011, 0.02]),
                      service_s=np.zeros(4), schedule_slips=0, ticks=4)
    assert rep.deadline_misses == 2
    # pipelined: the deadline extends by depth periods
    cfg2 = ServeConfig(rate_hz=100.0, budget_s=0.010, pipeline_depth=2)
    rep2 = ServeReport(config=cfg2, latency_s=rep.latency_s,
                       service_s=np.zeros(4), schedule_slips=0, ticks=4)
    assert rep2.deadline_misses == 0
    s = rep.summary()
    assert s["ticks"] == 4 and s["deadline_misses"] == 2
    assert "issue_ms" not in s


@pytest.fixture(scope="module")
def specs():
    js = jdefault_ocp(N=N, tf=0.015 * N, dtype=jnp.float64)
    ts = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                 device="cpu", dtype=torch.float64)
    x0 = np.asarray(jhover_state(js.params, pos=START, dtype=jnp.float64))
    return js, ts, x0


def _jax_run(specs, depth, predict_gap):
    """JAX's loop: (u_apply per tick (T, 4), final plant state)."""
    js, _, x0 = specs
    loop = jserving.ServingLoop(
        js, JCfg(iters=8), jserving.ServeConfig(rate_hz=500.0,
                                                pipeline_depth=depth),
        batch=1, use_fused=False, predict_gap=predict_gap)
    yref, yref_e = jhover_yref(js, pos=SETPOINT)
    plant = {"x": jnp.asarray(x0)}
    applied = []

    def source(k):
        return np.asarray(plant["x"])[None, :]

    def sink(k, cmd, u_apply):
        plant["x"] = jrk4_step(jdynamics, js.params, plant["x"],
                               jnp.asarray(u_apply[0]), float(js.dt))
        applied.append(u_apply[0].copy())

    loop.warmup(source(0), yref, yref_e)
    loop.reset(source(0))
    loop.run(TICKS, source, sink, yref, yref_e)
    return np.array(applied), np.asarray(plant["x"])


def _port_run(specs, depth, predict_gap, use_fused):
    """The port's loop, the same plant in the sink: (u_apply per tick,
    final state, the report, the ticks the sink saw, the launches)."""
    _, ts, x0 = specs
    loop = ServingLoop(ts, IPMConfig(iters=8),
                       ServeConfig(rate_hz=500.0, pipeline_depth=depth),
                       batch=1, use_fused=use_fused,
                       predict_gap=predict_gap, device="cpu")
    yref, yref_e = hover_yref(ts, pos=SETPOINT, device="cpu")
    plant = {"x": torch.as_tensor(x0)}
    applied, ticks = [], []

    def source(k):
        return plant["x"][None, :]

    def sink(k, cmd, u_apply):
        assert cmd.thrust_pwm.shape == (1,) and u_apply.shape == (1, 4)
        plant["x"] = rk4_step(dynamics, ts.params, plant["x"],
                              torch.as_tensor(u_apply[0]), float(ts.dt))
        applied.append(u_apply[0].copy())
        ticks.append(k)

    loop.warmup(source(0), yref, yref_e)
    loop.reset(source(0))
    kc.reset_launch_counts()
    rep = loop.run(TICKS, source, sink, yref, yref_e)
    return (np.array(applied), plant["x"].numpy(), rep, ticks,
            kc.launch_counts())


ARMS = {"sync": (0, True), "pipelined": (2, True),
        "pipelined_no_prediction": (2, False)}


@pytest.fixture(scope="module")
def jax_runs(specs):
    return {arm: _jax_run(specs, *args) for arm, args in ARMS.items()}


def _err(x):
    x = np.asarray(x)
    return float(np.abs(x[:3] - np.asarray(SETPOINT)).max())


@pytest.mark.parametrize("arm, use_fused", [
    ("sync", False), ("pipelined", False), ("pipelined", None)],
    ids=["sync-per_lane", "pipelined-per_lane", "pipelined-batched"])
def test_closed_loop_matches_jax(specs, jax_runs, arm, use_fused):
    """Every tick's emitted rotor command against JAX's, and the loop
    converging from 0.2 m off (to within 3 cm in 0.45 s of flight)."""
    depth, predict = ARMS[arm]
    want_u, want_x = jax_runs[arm]
    got_u, got_x, rep, ticks, counts = _port_run(specs, depth, predict,
                                                 use_fused)
    assert ticks == list(range(TICKS))           # every tick, in order
    assert rep.latency_s.shape == (TICKS,) and rep.issue_s.shape == (TICKS,)
    tol = TOL_LANE if use_fused is False else TOL_BATCHED
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=tol)
    assert abs(_err(got_x) - _err(want_x)) <= tol
    assert _err(want_x) < 0.03 and _err(got_x) < 0.03
    if depth:
        # pipelined latency includes the depth: >= depth periods
        assert rep.latency_s.min() >= depth * rep.config.period_s - 1e-3
    assert counts == dict.fromkeys(kc.KERNELS, 0)   # CPU: plain versions


def test_no_gap_prediction_diverges_in_both(specs, jax_runs):
    """Depth 2 with predict_gap=False: solves anchored to the 2-tick-stale
    state.  Both packages agree while the loop is near the set-point, and
    both leave it (the ablation arm of the delay-compensation claim)."""
    want_u, want_x = jax_runs["pipelined_no_prediction"]
    got_u, got_x, _, _, _ = _port_run(specs, 2, False, False)
    np.testing.assert_allclose(got_u[:10], want_u[:10], rtol=0,
                               atol=TOL_LANE)
    for x in (want_x, got_x):
        assert (not np.all(np.isfinite(x))) or _err(x) > 0.05, x


def test_transport_floor_reports():
    d = measure_transport_floor(batch=4, n=10, device="cpu")
    assert d["platform"] == "cpu"
    assert 0.0 < d["p50_ms"] < 1e3


def test_short_horizon_guard():
    spec = default_ocp(N=4, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="N >= 5"):
        ServingLoop(spec, batch=1, use_fused=False, device="cpu")


def test_spec_on_another_device_is_refused():
    spec = default_ocp(N=6, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        ServingLoop(spec, batch=1, device="meta")


def test_default_config_is_certified_at_jax_capacity():
    """The batched path's default: certified_config with JAX's escalation
    capacity, 128, capped at the lane count; the per-lane path 0."""
    spec = default_ocp(N=6, dtype=torch.float64, device="cpu")
    for batch, fused, cap in ((256, None, 128), (5, None, 5),
                              (5, False, 0)):
        loop = ServingLoop(spec, batch=batch, use_fused=fused, device="cpu")
        cfg = loop.ipm_config
        assert (cfg.iters, cfg.escalate_iters) == (8, 32)
        assert cfg.escalate_capacity == cap
