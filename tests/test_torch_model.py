"""The port's model, OCP data and warm start vs the JAX package (float64).

Inputs come from numpy seeds and go through both packages; the port runs
on the CPU (`device="cpu"`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import quadrotor as jq
from crazyflie_nmpc_tpu.solver import default_ocp as j_default_ocp
from crazyflie_nmpc_tpu.solver import hover_yref as j_hover_yref
from crazyflie_nmpc_tpu.solver import init_rti as j_init_rti
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import quadrotor as tq
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_dynamics_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    u = 15.0 + 3.0 * rng.standard_normal((64, 4))
    want = jq.dynamics(jq.QuadrotorParams(), jnp.asarray(x), jnp.asarray(u))
    got = tq.dynamics(tq.QuadrotorParams(), torch.as_tensor(x),
                      torch.as_tensor(u))
    _close(got, want)


def test_hover_state_and_control_match_jax():
    p = jq.QuadrotorParams()
    _close(tq.hover_state(tq.QuadrotorParams(), (0.1, -0.2, 0.5),
                          torch.float64, device="cpu"),
           jq.hover_state(p, (0.1, -0.2, 0.5), jnp.float64))
    _close(tq.hover_control(tq.QuadrotorParams(), torch.float64,
                            device="cpu"),
           jq.hover_control(p, jnp.float64))
    assert tq.QuadrotorParams().hover_speed() == pytest.approx(
        float(p.hover_speed()), rel=1e-15)


@pytest.fixture(scope="module")
def specs():
    jspec = j_default_ocp(N=10, dtype=jnp.float64)
    return jspec, ts.default_ocp(N=10, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("leaf", convert.PARAM_KEYS + convert.COST_KEYS
                         + ("lbu", "ubu", "tf"))
def test_default_ocp_matches_jax(specs, leaf):
    jspec, tspec = specs
    _close(convert.leaves_from_spec(tspec)[leaf],
           convert.leaves_from_spec(jspec)[leaf], 0.0)
    assert tspec.N == jspec.N and tspec.sim_steps == jspec.sim_steps


def test_spec_from_numpy_carries_the_jax_problem(specs):
    jspec, tspec = specs
    got = convert.spec_from_numpy(convert.leaves_from_spec(jspec), jspec.N,
                                  device="cpu", dtype=torch.float64)
    for k, v in convert.leaves_from_spec(tspec).items():
        _close(convert.leaves_from_spec(got)[k], v, 0.0)
    assert float(got.dt) == pytest.approx(float(jspec.dt), rel=1e-15)


@pytest.mark.parametrize("pos", [(0.0, 0.0, 0.5), (1.0, -0.5, 2.0)])
def test_hover_yref_matches_jax(specs, pos):
    jspec, tspec = specs
    jy, jye = j_hover_yref(jspec, pos)
    ty, tye = ts.hover_yref(tspec, pos, device="cpu")
    _close(ty, jy, 0.0)
    _close(tye, jye, 0.0)


@pytest.mark.parametrize("N", [10, 50])
def test_init_rti_matches_jax(N):
    """Hover-input rollout from perturbed x0s (the warm start)."""
    rng = np.random.default_rng(N)
    jspec = j_default_ocp(N=N, dtype=jnp.float64)
    tspec = ts.default_ocp(N=N, dtype=torch.float64, device="cpu")
    x0s = (np.asarray(jq.hover_state(jspec.params, dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((4, 13)))
    want = jax.vmap(lambda x: j_init_rti(jspec, x))(jnp.asarray(x0s))
    got = ts.init_rti(tspec, torch.as_tensor(x0s), device="cpu")
    _close(got.x_traj, want.x_traj)
    _close(got.u_traj, want.u_traj)


def test_state_from_numpy_roundtrip():
    rng = np.random.default_rng(2)
    x, u = rng.standard_normal((11, 13, 3)), rng.standard_normal((10, 4, 3))
    st = convert.state_from_numpy(x, u, device="cpu", dtype=torch.float64)
    _close(st.x_traj, x, 0.0)
    _close(st.u_traj, u, 0.0)
    assert st.x_traj.is_contiguous() and st.u_traj.dtype == torch.float64
