"""The estimator chain (`estimator.lpf`, `estimator.pipeline`,
`estimator.sysid`) vs the JAX package's, float64 on the CPU.  Tolerance
1e-12 relative to max(1, max |JAX|).

The LPF runs 100 samples at 15 ms: its first second (67 samples) is the
finite-difference warm-up, the rest the reference's IIR differentiator,
so both branches are held, with and without the unity-gain correction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import estimator as jest
from crazyflie_nmpc_tpu.estimator import sysid as jsysid
from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.solver import default_ocp
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import estimator as port_est
from crazyflie_nmpc_tpu_torch.estimator import sysid as tsysid
from crazyflie_nmpc_tpu_torch.estimator.lpf import WARMUP_SECONDS
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-12
DT = 0.015
SAMPLES = 100


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def streams():
    """A logged flight: positions on a smooth curve with noise, Euler
    angles and gyro rates, SAMPLES samples at DT."""
    rng = np.random.default_rng(5)
    t = np.arange(SAMPLES) * DT
    pos = np.stack([0.3 * np.cos(2 * t), 0.3 * np.sin(2 * t), 0.5 + 0.1 * t],
                   axis=1) + 1e-3 * rng.standard_normal((SAMPLES, 3))
    eul = 0.1 * rng.standard_normal((SAMPLES, 3))
    gyro = 0.5 * rng.standard_normal((SAMPLES, 3))
    return pos, eul, gyro


@pytest.fixture(scope="module")
def specs():
    js = default_ocp(N=10, tf=0.15, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), 10,
                                    device="cpu", dtype=torch.float64)
    return js, tspec


@pytest.mark.parametrize("unity_gain", [False, True],
                         ids=["reference_gain", "unity_gain"])
def test_lpf_step_matches_jax_in_both_branches(streams, unity_gain):
    pos = streams[0]
    js_state = jest.init_lpf(jnp.asarray(pos[0]))
    ts_state = port_est.init_lpf(_t(pos[0]))
    branches = set()
    for k, p in enumerate(pos):
        branches.add(bool(float(ts_state.elapsed) > WARMUP_SECONDS))
        js_state, jv = jest.lpf_step(js_state, jnp.asarray(p), DT,
                                     unity_gain=unity_gain)
        ts_state, tv = port_est.lpf_step(ts_state, _t(p), DT,
                                         unity_gain=unity_gain)
        _close(tv, jv, f"sample {k} v")
        for f in ("p_prev", "v_prev", "v_prev2", "elapsed"):
            _close(getattr(ts_state, f), getattr(js_state, f),
                   f"sample {k} {f}")
    assert branches == {False, True}


def test_fuse_predict_estimate_notify_match_jax(streams, specs):
    """Six ticks of fuse + predict (estimate) with a command recorded
    every tick (notify_command), the estimator state carried."""
    pos, eul, gyro = streams
    js, tspec = specs
    jst = jest.init_estimator(js.params, jnp.asarray(pos[0]))
    tst = port_est.init_estimator(tspec.params, _t(pos[0]))
    _close(tst.last_u, jst.last_u, "init last_u")
    rng = np.random.default_rng(6)
    for k in range(6):
        args = (pos[k], eul[k], gyro[k])
        _, jx = jest.fuse(jst, *map(jnp.asarray, args), DT)
        _, tx = port_est.fuse(tst, *map(_t, args), DT)
        _close(tx, jx, f"tick {k} fuse")
        jp = jest.predict(js.params, jx, jst.last_u, 4 * DT, sim_steps=2)
        tp = port_est.predict(tspec.params, tx, tst.last_u, 4 * DT,
                              sim_steps=2)
        _close(tp, jp, f"tick {k} predict")
        jst, jh = jest.estimate(js.params, jst, *map(jnp.asarray, args), DT,
                                4 * DT)
        tst, th = port_est.estimate(tspec.params, tst, *map(_t, args), DT,
                                    4 * DT)
        _close(th, jh, f"tick {k} estimate")
        u = 15.0 + rng.standard_normal(4)
        jst = jest.notify_command(jst, jnp.asarray(u))
        tst = port_est.notify_command(tst, _t(u))
        leaves = convert.leaves_from_estimator_state(tst)
        for name, want in convert.leaves_from_estimator_state(jst).items():
            _close(leaves[name], want, f"tick {k} state {name}")


def test_estimator_state_round_trip(streams, specs):
    """estimator_state_from_numpy rebuilds the JAX state's numbers."""
    js, _ = specs
    jst = jest.init_estimator(js.params, jnp.asarray(streams[0][0]))
    jst, _ = jest.fuse(jst, *(jnp.asarray(s[1]) for s in streams), DT)
    leaves = convert.leaves_from_estimator_state(jst)
    tst = convert.estimator_state_from_numpy(leaves, device="cpu",
                                             dtype=torch.float64)
    assert convert.leaves_from_estimator_state(tst).keys() == leaves.keys()
    for name, v in convert.leaves_from_estimator_state(tst).items():
        np.testing.assert_array_equal(v, leaves[name])


def test_assemble_measurements_matches_jax(streams):
    want = jsysid.assemble_measurements(*streams, DT)
    got = tsysid.assemble_measurements(*map(_t, streams), DT)
    _close(got, want, "assemble_measurements")


def test_sysid_fits_match_jax(specs):
    js, tspec = specs
    rng = np.random.default_rng(7)
    pwm = rng.uniform(10000, 60000, 50)
    krpm = (0.2685 * pwm + 4070.3) / 1000.0 + 1e-4 * rng.standard_normal(50)
    hover = 15.0 + 0.01 * rng.standard_normal(40)
    u = 15.0 + rng.standard_normal((60, 4))
    dwz = rng.standard_normal(60)
    cases = [
        (jsysid.fit_thrust_map(krpm, pwm),
         tsysid.fit_thrust_map(_t(krpm), pwm)),
        (jsysid.fit_thrust_coefficient(js.params, hover),
         tsysid.fit_thrust_coefficient(tspec.params, _t(hover))),
        (jsysid.fit_drag_coefficient(js.params, u, dwz),
         tsysid.fit_drag_coefficient(tspec.params, _t(u), dwz)),
    ]
    for want, got in cases:
        _close(np.asarray(got, np.float64), np.asarray(want, np.float64))
    with pytest.raises(ValueError, match="excitation"):
        tsysid.fit_drag_coefficient(tspec.params, np.full((5, 4), 15.0),
                                    np.zeros(5))


def test_estimator_runs_on_the_logged_states(specs):
    """The fused state of a flight at hover reads hover (the LPF's
    reference DC gain aside: zero velocity stays zero)."""
    js, tspec = specs
    x = np.asarray(jax.device_get(hover_state(js.params,
                                              pos=(0.0, 0.0, 0.5))))
    st = port_est.init_estimator(tspec.params, _t(x[:3]))
    zero = torch.zeros(3, dtype=torch.float64)
    for _ in range(80):
        st, xf = port_est.fuse(st, _t(x[:3]), zero, zero, DT)
    _close(xf, x, "hover")
