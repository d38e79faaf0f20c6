"""The onboard attitude-loop plant (`models.firmware`) vs the JAX
package's, float64 on the CPU: the cascade mixer, the motor state and
`attitude_plant_step` with and without motor lag, the rate-D term and
the motor state threaded over three calls.  Tolerance 1e-12 relative to
max(1, max |JAX|).

The lag branch is chosen statically from the type of `tau_m`, as in the
JAX package: a Python 0.0 means no lag, a tensor (an array there) selects
the lag branch even when it holds 0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import firmware as jf
from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.solver import default_ocp
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch.models import firmware as tf
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-12
CALLS = 3


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    js = default_ocp(N=10, tf=0.15, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), 10,
                                    device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(3)
    x = np.asarray(hover_state(js.params, pos=(0.1, -0.2, 0.5),
                               dtype=jnp.float64))
    xs = x + 0.05 * rng.standard_normal((4, 13))
    cmds = np.stack([rng.uniform(-8.0, 8.0, 4), rng.uniform(-8.0, 8.0, 4),
                     rng.uniform(-40.0, 40.0, 4),
                     rng.uniform(30000.0, 50000.0, 4)], axis=1)
    return js, tspec, xs, cmds


def _gains(kind):
    """(JAX gains, port gains) of one case."""
    if kind == "default":
        return jf.AttitudeGains(), tf.AttitudeGains()
    if kind == "kd_rate_float_tau_0":
        return (jf.AttitudeGains(kd_rate=0.002, tau_m=0.0),
                tf.AttitudeGains(kd_rate=0.002, tau_m=0.0))
    tau = {"tensor_tau_0": 0.0, "tensor_tau_15ms": 0.015}[kind]
    jg = jf.AttitudeGains(kd_rate=0.002, tau_m=jnp.asarray(tau))
    return jg, convert.gains_from_numpy(convert.leaves_from_gains(jg),
                                        device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("kind", ["default", "kd_rate_float_tau_0"])
@pytest.mark.parametrize("with_omega_dot", [False, True],
                         ids=["no_omega_dot", "omega_dot"])
def test_mix_cmd_vel_matches_jax(setup, kind, with_omega_dot):
    js, tspec, xs, cmds = setup
    jg, tg = _gains(kind)
    od = np.array([3.0, -2.0, 5.0]) if with_omega_dot else None
    for x, cmd in zip(xs, cmds):
        want = jf.mix_cmd_vel(js.params, jg, jnp.asarray(x),
                              jnp.asarray(cmd),
                              omega_dot=None if od is None
                              else jnp.asarray(od))
        got = tf.mix_cmd_vel(tspec.params, tg, torch.as_tensor(x),
                             torch.as_tensor(cmd),
                             omega_dot=None if od is None
                             else torch.as_tensor(od))
        _close(got, want, "mix_cmd_vel")


def test_mix_cmd_vel_is_batched(setup):
    """Leading axes are batch axes: the (4, 13) states in one call equal
    four single calls."""
    _, tspec, xs, cmds = setup
    g = tf.AttitudeGains(kd_rate=0.002)
    od = torch.full((4, 3), 0.5, dtype=torch.float64)
    got = tf.mix_cmd_vel(tspec.params, g, torch.as_tensor(xs),
                         torch.as_tensor(cmds), omega_dot=od)
    for i in range(4):
        one = tf.mix_cmd_vel(tspec.params, g, torch.as_tensor(xs[i]),
                             torch.as_tensor(cmds[i]), omega_dot=od[i])
        torch.testing.assert_close(got[i], one, rtol=0, atol=0)


@pytest.mark.parametrize("u0", [None, np.array([14.0, 15.0, 16.0, 17.0])],
                         ids=["hover", "given"])
def test_init_motor_state_matches_jax(setup, u0):
    js, tspec, xs, _ = setup
    jw, jo = jf.init_motor_state(js.params, jnp.asarray(xs[0]),
                                 None if u0 is None else jnp.asarray(u0))
    tw, to = tf.init_motor_state(tspec.params, torch.as_tensor(xs[0]),
                                 None if u0 is None else torch.as_tensor(u0))
    _close(tw, jw, "w_act")
    _close(to, jo, "omega_prev")
    assert tw.dtype == torch.float64


@pytest.mark.parametrize("kind", ["default", "kd_rate_float_tau_0",
                                  "tensor_tau_0", "tensor_tau_15ms"])
def test_attitude_plant_step_matches_jax(setup, kind):
    """Three chained calls with the motor state threaded through, from the
    default (hover) motor state; x, the last actual rotor speeds and the
    motor state after each call."""
    js, tspec, xs, cmds = setup
    jg, tg = _gains(kind)
    jx, tx = jnp.asarray(xs[1]), torch.as_tensor(xs[1])
    jm = tm = None
    for k in range(CALLS):
        jx, ju, jm = jf.attitude_plant_step(js.params, jx,
                                            jnp.asarray(cmds[k]), js.dt,
                                            gains=jg, motor=jm)
        tx, tu, tm = tf.attitude_plant_step(tspec.params, tx,
                                            torch.as_tensor(cmds[k]),
                                            tspec.dt, gains=tg, motor=tm)
        _close(tx, jx, f"{kind} call {k} x")
        _close(tu, ju, f"{kind} call {k} u")
        _close(tm[0], jm[0], f"{kind} call {k} w_act")
        _close(tm[1], jm[1], f"{kind} call {k} omega_prev")


def test_tensor_zero_lag_is_the_lag_branch(setup):
    """tau_m as a tensor holding 0.0 takes the lag branch (exp(-inf) = 0:
    the physics sees the mean of the old and new speeds), a Python 0.0
    does not; the two give different plants, each as in JAX."""
    _, tspec, xs, cmds = setup
    x, cmd = torch.as_tensor(xs[2]), torch.as_tensor(cmds[2])
    outs = [tf.attitude_plant_step(tspec.params, x, cmd, tspec.dt,
                                   gains=tf.AttitudeGains(tau_m=tau))
            for tau in (0.0, torch.tensor(0.0, dtype=torch.float64))]
    assert not tf._nonzero(0.0) and tf._nonzero(torch.tensor(0.0))
    assert float((outs[0][1] - outs[1][1]).abs().max()) > 1e-6
    # the lag branch's motor state after one call is the mixer's command
    # (lag 0), but the applied speed is the segment's midpoint
    assert not torch.equal(outs[1][1], outs[1][2][0])


def test_python_float_lag_keeps_float64(setup):
    """Python-float `dt` and `tau_m` in a float64 run (as a vehicle
    endpoint passes them): the motor-lag factor is built in x's dtype, so
    state and rotor speeds match JAX's float64 plant to 1e-12.  Built as
    a default-dtype tensor it was float32, 5.5e-8 kRPM and 6.4e-9 in the
    state away."""
    js, tspec, xs, cmds = setup
    jg = jf.AttitudeGains(kd_rate=0.002, tau_m=0.015)
    tg = tf.AttitudeGains(kd_rate=0.002, tau_m=0.015)
    jx, ju, jm = jf.attitude_plant_step(js.params, jnp.asarray(xs[3]),
                                        jnp.asarray(cmds[3]), 0.015,
                                        gains=jg)
    tx, tu, tm = tf.attitude_plant_step(tspec.params,
                                        torch.as_tensor(xs[3]),
                                        torch.as_tensor(cmds[3]), 0.015,
                                        gains=tg)
    assert tx.dtype == tu.dtype == tm[0].dtype == torch.float64
    _close(tx, jx, "x")
    _close(tu, ju, "u")
    _close(tm[0], jm[0], "w_act")
