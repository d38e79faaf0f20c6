"""The port's PID waypoint controller (`crazyflie_nmpc_tpu_torch.pid`)
against the JAX package's, on the CPU.

Both controllers get the same gains and the same scripted states, made
from a seed with numpy, and are chained for 300 ticks at 50 Hz: the
takeoff ramp on the ground, the Automatic transition (its seeded Z
integrator) once the state climbs, the lateral and yaw integrators
clamping against an off-axis goal, `land` and the descent to Idle.  In
float64 every command and state leaf agrees to 1e-12 and the mode
sequence is the same; in float32 to float32 rounding of the gains' scale
(FLOAT32_TOL).  The sign convention and the integrator clamps are held
on their own, and `convert.pid_gains` / `convert.pid_state` carry JAX's
gains and state across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import pid as jpid
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import pid as tpid
from crazyflie_nmpc_tpu_torch.models import rotations
from _torch_shared import one_torch_thread  # noqa: F401

DT = 0.02          # the reference PID's 50 Hz (controller.cpp:254)
TICKS = 300
LAND_AT = 200      # land() is called before this tick
GOAL = (0.3, -0.2, 0.6)
GOAL_YAW = 0.3
FLOAT64_TOL = 1e-12
# float32: the two frameworks' sin/cos/atan2 and sums round differently
# (a few ulp); the z axis multiplies an error by kd/dt = 3e5, so a
# command's ulp-level difference is relative to 6e4 PWM
FLOAT32_TOL = 1e-5


def scripted_states(seed=0):
    """(TICKS, 13) float64 states: on the ground for 30 ticks, a climb to
    0.7 m over 90, a hover with small seeded attitude and rate noise, and
    from LAND_AT a descent to the ground; a random yaw throughout."""
    rng = np.random.default_rng(seed)
    k = np.arange(TICKS)
    z = np.clip((k - 30) / 90.0, 0.0, 1.0) * 0.7
    z = np.where(k >= LAND_AT, np.clip(0.7 - (k - LAND_AT) / 60.0, 0.0,
                                       None), z)
    xs = np.zeros((TICKS, 13))
    xs[:, 0] = 0.05 * np.sin(k / 40.0)
    xs[:, 1] = -0.03 * np.cos(k / 25.0)
    xs[:, 2] = z
    euler = np.stack([0.05 * rng.standard_normal(TICKS),
                      0.05 * rng.standard_normal(TICKS),
                      0.2 + 0.1 * np.sin(k / 30.0)], axis=1)
    xs[:, 3:7] = rotations.euler_to_quat(torch.as_tensor(euler)).numpy()
    xs[:, 7:10] = 0.1 * rng.standard_normal((TICKS, 3))
    xs[:, 10:13] = 0.2 * rng.standard_normal((TICKS, 3))
    return xs


def run_jax(dtype):
    gains = jpid.default_gains(dtype)
    st = jpid.init_pid(dtype)
    xs = jnp.asarray(scripted_states(), dtype)
    goal = jnp.asarray(GOAL, dtype)
    step = jax.jit(lambda s, x: jpid.pid_step(gains, s, x, goal, GOAL_YAW,
                                              DT))
    st = jpid.takeoff(st, xs[0, 2])
    cmds, states = [], []
    for k in range(TICKS):
        if k == LAND_AT:
            st = jpid.land(st)
        st, cmd = step(st, xs[k])
        cmds.append(np.asarray(jnp.stack(list(cmd))))
        states.append(_leaves(st))
    return np.stack(cmds), states


def run_port(dtype):
    gains = tpid.default_gains(dtype, device="cpu")
    st = tpid.init_pid(dtype, device="cpu")
    xs = torch.as_tensor(scripted_states(), dtype=dtype)
    goal = torch.tensor(GOAL, dtype=dtype)
    st = tpid.takeoff(st, xs[0, 2])
    cmds, states = [], []
    for k in range(TICKS):
        if k == LAND_AT:
            st = tpid.land(st)
        st, cmd = tpid.pid_step(gains, st, xs[k], goal, GOAL_YAW, DT)
        cmds.append(torch.stack(list(cmd)).numpy())
        states.append(_leaves(st))
    return np.stack(cmds), states


def _leaves(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


@pytest.fixture(scope="module", params=["float64", "float32"])
def chains(request):
    jdt, tdt = {"float64": (jnp.float64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[request.param]
    return request.param, run_jax(jdt), run_port(tdt)


def test_chain_visits_every_mode(chains):
    """The scripted flight takes the controller through TakingOff,
    Automatic (seeded at the transition), Landing and Idle, and clamps
    the lateral integrators."""
    _, (_, jstates), (_, tstates) = chains
    modes = [int(s["mode"]) for s in jstates]
    assert modes[0] == jpid.TAKING_OFF
    first_auto = modes.index(jpid.AUTOMATIC)
    assert 30 < first_auto < LAND_AT
    assert modes[LAND_AT] == jpid.LANDING and modes[-1] == jpid.IDLE
    integral = np.stack([s["integral"] for s in jstates])
    assert np.isclose(np.abs(integral[first_auto:LAND_AT, 1]).max(), 0.1)
    assert not integral[:, 3].any()          # yaw: min = max = 0
    assert [int(s["mode"]) for s in tstates] == modes


def test_chain_matches_jax(chains):
    name, (jcmd, jstates), (tcmd, tstates) = chains
    tol = FLOAT64_TOL if name == "float64" else FLOAT32_TOL
    assert tcmd.dtype == jcmd.dtype
    scale = np.maximum(1.0, np.abs(jcmd).max(axis=0))
    np.testing.assert_allclose(tcmd / scale, jcmd / scale, rtol=0,
                               atol=tol)
    for k, (js, ts) in enumerate(zip(jstates, tstates)):
        assert int(ts["mode"]) == int(js["mode"]), k
        for leaf in ("integral", "prev_error", "thrust", "start_z"):
            ref = js[leaf]
            np.testing.assert_allclose(
                ts[leaf], ref, rtol=0,
                atol=tol * max(1.0, float(np.abs(ref).max())),
                err_msg=f"tick {k} {leaf}")


def test_modes_are_tensors_on_the_states_device():
    st = tpid.takeoff(tpid.init_pid(torch.float64, device="cpu"), 0.0)
    x = torch.zeros(13, dtype=torch.float64)
    x[3] = 1.0
    st, cmd = tpid.pid_step(tpid.default_gains(torch.float64, device="cpu"),
                            st, x, torch.tensor([0.0, 0.0, 0.5],
                                                dtype=torch.float64), 0.0,
                            DT)
    assert st.mode.dtype == torch.int32 and st.mode.shape == ()
    assert all(v.dtype == torch.float64 for v in cmd)
    assert float(cmd.thrust) == 10000.0 * DT


def test_lateral_error_sign_convention():
    """Goal ahead (+x body) commands positive pitch; goal left (+y)
    negative roll (the reference's Y gains are negative,
    crazyflie2.yaml kp_y=-40), as in JAX."""
    gains = tpid.default_gains(torch.float32, device="cpu")
    st = dataclasses.replace(tpid.init_pid(device="cpu"),
                             mode=torch.tensor(tpid.AUTOMATIC,
                                               dtype=torch.int32))
    x = torch.zeros(13)
    x[2], x[3] = 0.5, 1.0
    jst = dataclasses.replace(jpid.init_pid(), mode=jnp.int32(
        jpid.AUTOMATIC))
    jx = jnp.asarray(x.numpy())
    for goal, field, sign in (((1.0, 0.0, 0.5), "pitch", 1.0),
                              ((0.0, 1.0, 0.5), "roll", -1.0)):
        _, cmd = tpid.pid_step(gains, st, x, torch.tensor(goal), 0.0, DT)
        _, jcmd = jpid.pid_step(jpid.default_gains(jnp.float32), jst, jx,
                                jnp.asarray(goal, jnp.float32), 0.0, DT)
        assert sign * float(getattr(cmd, field)) > 0
        assert float(getattr(cmd, field)) == float(getattr(jcmd, field))


def test_integrator_clamped():
    """100 updates of a large error: the integrators stop at their
    bounds (yaw at 0: both bounds 0) and the outputs at theirs, equal to
    JAX's in float64."""
    gains = tpid.default_gains(torch.float64, device="cpu")
    jgains = jpid.default_gains(jnp.float64)
    integral = prev = torch.zeros(4, dtype=torch.float64)
    jintegral = jprev = jnp.zeros(4)
    err = [100.0, -100.0, 100.0, 100.0]
    for _ in range(100):
        integral, prev, out = tpid.pid_update(
            gains, integral, prev, torch.tensor(err, dtype=torch.float64),
            DT)
        jintegral, jprev, jout = jpid.pid_update(
            jgains, jintegral, jprev, jnp.asarray(err), DT)
    assert integral.tolist() == [0.1, -0.1, 200.0, 0.0]     # z: 100 x 2
    assert bool((out <= gains.max_output).all())
    assert bool((out >= gains.min_output).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=FLOAT64_TOL)
    np.testing.assert_array_equal(integral.numpy(), np.asarray(jintegral))


def test_convert_carries_gains_and_state():
    """JAX's gains and a JAX state in mid-flight, carried across, give the
    port the same gains and the same next tick (1e-12, float64)."""
    jgains = jpid.default_gains(jnp.float64)
    gains = convert.pid_gains(jgains, device="cpu")
    for f in dataclasses.fields(gains):
        np.testing.assert_array_equal(getattr(gains, f.name).numpy(),
                                      np.asarray(getattr(jgains, f.name)))
        assert getattr(gains, f.name).dtype == torch.float64
    ref = tpid.default_gains(torch.float64, device="cpu")
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(gains, f.name), getattr(ref, f.name))

    jst = jpid.PIDState(integral=jnp.asarray([0.02, -0.01, 12.0, 0.0]),
                        prev_error=jnp.asarray([0.1, 0.2, 0.3, 0.05]),
                        mode=jnp.int32(jpid.AUTOMATIC),
                        thrust=jnp.zeros(()), start_z=jnp.asarray(0.01))
    st = convert.pid_state(jst, device="cpu")
    assert st.mode.dtype == torch.int32 and int(st.mode) == jpid.AUTOMATIC
    x = scripted_states()[150]
    goal = (0.1, 0.2, 0.5)
    jst2, jcmd = jpid.pid_step(jgains, jst, jnp.asarray(x),
                               jnp.asarray(goal), 0.1, DT)
    st2, cmd = tpid.pid_step(gains, st, torch.as_tensor(x),
                             torch.tensor(goal, dtype=torch.float64), 0.1,
                             DT)
    np.testing.assert_allclose(torch.stack(list(cmd)).numpy(),
                               np.asarray(jnp.stack(list(jcmd))), rtol=0,
                               atol=FLOAT64_TOL * 6e4)
    np.testing.assert_allclose(st2.integral.numpy(),
                               np.asarray(jst2.integral), rtol=0,
                               atol=FLOAT64_TOL)
    f32 = convert.pid_gains(jgains, device="cpu", dtype=torch.float32)
    assert f32.kp.dtype == torch.float32
