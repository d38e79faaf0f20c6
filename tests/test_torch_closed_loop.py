"""The closed loops (`runtime.closed_loop`) vs the JAX package's, float64
on the CPU, N=10 stages of 15 ms, IPMConfig(iters=8), a few ticks each:

  * hover_regulation with a 4-tick delay under both predictors;
  * estimator_in_the_loop (the estimator chain as the measurement);
  * cmd_vel_loop with the reference's motvel predictor, a 2-tick round
    trip split 1/1 and the lag gains (rate D term, 15 ms motor lag);
  * flight_configuration on the first rows of the helix.

x, u, u_cmd, kkt_res and policy_mode are held to 1e-8 relative to
max(1, max |JAX|).  Each JAX loop is jitted once and compiled at XLA's
optimization level 0, in this process.  Also: tracking_error, the
hold-last-action guard (the JAX package's own test on the port), the
ValueErrors and the remat option's forward pass.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import firmware as jf
from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.runtime import closed_loop as jcl
from crazyflie_nmpc_tpu.solver import default_ocp
from crazyflie_nmpc_tpu.utils.trajectories import helix_trajectory
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import firmware as tfw
from crazyflie_nmpc_tpu_torch.models import hover_state as hover_state_t
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime import closed_loop as tcl
from _torch_shared import o0, one_torch_thread  # noqa: F401

N, TICKS = 10, 6
TOL = 1e-8
HELIX_ROWS = 40
LAG_GAINS = dict(kd_rate=0.002, tau_m=0.015)


def _close_result(got, want, tag):
    got = convert.loop_result_to_numpy(got)
    want = convert.loop_result_to_numpy(want)
    for f in got._fields:
        g = np.asarray(getattr(got, f), np.float64)
        w = np.asarray(getattr(want, f), np.float64)
        assert g.shape == w.shape, f"{tag} {f}"
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=f"{tag} {f}")


@pytest.fixture(scope="module")
def setup():
    js = default_ocp(N=N, tf=0.015 * N, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                    device="cpu", dtype=torch.float64)
    x0 = np.asarray(hover_state(js.params, pos=(0.0, 0.0, 0.5),
                                dtype=jnp.float64))
    x0 = x0 + 0.02 * np.random.default_rng(1).standard_normal(13)
    jcfg = jcl.LoopConfig(delay_steps=4, ipm=JCfg(iters=8))
    tcfg = convert.loop_config_from_numpy(
        convert.leaves_from_loop_config(jcfg))
    table = np.array(helix_trajectory(js.params))[:HELIX_ROWS]
    return dict(js=js, tspec=tspec, x0=x0, jcfg=jcfg, tcfg=tcfg,
                table=table)


def _loops(s, case):
    """(JAX loop of x0 or the table, port loop of the same) of a case."""
    js, tspec, jcfg, tcfg = s["js"], s["tspec"], s["jcfg"], s["tcfg"]
    if case in ("pending", "last_command"):
        jc = dataclasses.replace(jcfg, predictor=case)
        tc = dataclasses.replace(tcfg, predictor=case)
        return (lambda x: jcl.hover_regulation(js, x, steps=TICKS, config=jc),
                lambda x: tcl.hover_regulation(tspec, x, steps=TICKS,
                                               config=tc))
    if case == "estimator":
        return (lambda x: jcl.estimator_in_the_loop(js, x, steps=TICKS,
                                                    config=jcfg),
                lambda x: tcl.estimator_in_the_loop(tspec, x, steps=TICKS,
                                                    config=tcfg))
    if case == "motvel":
        kw = dict(steps=TICKS, delay_steps=2, meas_delay_steps=1,
                  predictor="motvel")
        return (lambda x: jcl.cmd_vel_loop(
                    js, x, config=jcfg, gains=jf.AttitudeGains(**LAG_GAINS),
                    **kw),
                lambda x: tcl.cmd_vel_loop(
                    tspec, x, config=tcfg,
                    gains=tfw.AttitudeGains(**LAG_GAINS), **kw))
    assert case == "flight"
    return (lambda t: jcl.flight_configuration(js, t, steps=TICKS,
                                               config=jcfg),
            lambda t: tcl.flight_configuration(tspec, t, steps=TICKS,
                                               config=tcfg))


@pytest.fixture(scope="module")
def flights(setup):
    """Both packages' flight_configuration on the helix rows."""
    jloop, tloop = _loops(setup, "flight")
    table = setup["table"]
    return (o0(jloop, jnp.asarray(table)),
            tloop(torch.as_tensor(table)))


@pytest.mark.parametrize("case", ["pending", "last_command", "estimator",
                                  "motvel"])
def test_closed_loop_matches_jax(setup, case):
    jloop, tloop = _loops(setup, case)
    want = o0(jloop, jnp.asarray(setup["x0"]))
    got = tloop(torch.as_tensor(setup["x0"]))
    assert got.x.shape == (TICKS, 13) and got.policy_mode.shape == (TICKS,)
    _close_result(got, want, case)


def test_flight_configuration_matches_jax(flights):
    want, got = flights
    _close_result(got, want, "flight")
    assert bool((got.policy_mode == ts.policies.TRACKING).all())


def test_tracking_error_matches_jax(setup, flights):
    want, got = flights
    e_jax = jcl.tracking_error(want, setup["table"])
    e_port = tcl.tracking_error(got, torch.as_tensor(setup["table"]))
    assert e_port.shape == (TICKS,)
    np.testing.assert_allclose(e_port, e_jax, rtol=TOL, atol=TOL)
    # the same numbers from the JAX result read by the port's function
    np.testing.assert_array_equal(
        tcl.tracking_error(convert.loop_result_to_numpy(want),
                           setup["table"]), e_jax)


def test_hold_last_action_on_failure():
    """The JAX package's test_hold_last_action_on_failure on the port:
    NaNs in the tracked table from row 30 on; the guard keeps every
    command and state finite (float32, N=10, 40 ticks)."""
    spec = ts.default_ocp(N=10, dtype=torch.float32, device="cpu")
    x0 = hover_state_t(spec.params, pos=(0.0, 0.0, 0.5), device="cpu")
    table = np.tile(np.concatenate([x0.numpy(), np.full(4, 15.7777)]),
                    (60, 1))
    table[30:, 2] = np.nan
    res = tcl.simulate(spec, x0, ts.policies.tracking_state(device="cpu"),
                       torch.as_tensor(table, dtype=torch.float32),
                       steps=40,
                       config=tcl.LoopConfig(ipm=IPMConfig(iters=8)))
    assert bool(torch.isfinite(res.u).all()), "guard failed to hold"
    assert bool(torch.isfinite(res.x).all())


@pytest.mark.parametrize("call, match", [
    (lambda s, x: tcl.simulate(
        s, x, ts.policies.regulation_state(device="cpu"),
        ts.policies.regulation_table(s, torch.float64, device="cpu"), 1,
        tcl.LoopConfig(predictor="bogus")), "pending"),
    (lambda s, x: tcl.cmd_vel_loop(s, x, steps=1, predictor="bogus"),
     "motvel"),
    (lambda s, x: tcl.cmd_vel_loop(s, x, steps=1, delay_steps=2,
                                   meas_delay_steps=3), "meas_delay_steps"),
    (lambda s, x: tcl.cmd_vel_loop(s, x, steps=1, meas_delay_steps=-1),
     "meas_delay_steps"),
], ids=["simulate_predictor", "cmd_vel_predictor", "meas_delay_above",
        "meas_delay_negative"])
def test_bad_loop_settings_raise(setup, call, match):
    x0 = torch.as_tensor(setup["x0"])
    with pytest.raises(ValueError, match=match):
        call(setup["tspec"], x0)


def test_remat_is_not_ported(setup):
    """remat was the unported option; it is ported now (ROADMAP Queue 1
    item 11): LoopConfig(remat=True) builds, and its forward pass is the
    stored loop's, value for value (its gradients:
    test_torch_tuning.py)."""
    x0 = torch.as_tensor(setup["x0"])
    cfg = dataclasses.replace(setup["tcfg"], remat=True)
    got = tcl.hover_regulation(setup["tspec"], x0, steps=2, config=cfg)
    want = tcl.hover_regulation(setup["tspec"], x0, steps=2,
                                config=setup["tcfg"])
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_loop_config_carries_across(setup):
    """loop_config_from_numpy maps every LoopConfig field and the
    IPMConfig's (the certified default too)."""
    for jcfg in (setup["jcfg"], jcl.LoopConfig()):
        tcfg = convert.loop_config_from_numpy(
            convert.leaves_from_loop_config(jcfg))
        assert convert.leaves_from_loop_config(tcfg) == \
            convert.leaves_from_loop_config(jcfg)
    assert tcl.LoopConfig().ipm.escalate_iters == 32
