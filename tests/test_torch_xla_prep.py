"""The batched step's XLA-style preparation vs the JAX package's
(float64, CPU, N=10, B=8): `rti_step_batched` with `fused_prep=False`
(condense 2 and 1) and with a `sim_steps=2` spec, two chained steps
against the JAX package's same options (its Pallas kernels in interpret
mode), and against the port's own kernel preparation on the same states.
Each JAX step is jitted once, compiled at XLA's optimization level 0, in
this process, and called for both steps.  Tolerance 1e-9 relative to
max(1, max |JAX|), as for the port's other paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched as j_step
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from _torch_shared import one_torch_thread  # noqa: F401

N, B = 10, 8
TOL = 1e-9
RTI_FIELDS = ("u0", "u1", "x_plan", "u_plan", "kkt_res", "qp_mu")


def _close(got, want, name=""):
    got = got.detach().double().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _pair(sim_steps=1):
    js = default_ocp(N=N, dtype=jnp.float64, sim_steps=sim_steps)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                    device="cpu", dtype=torch.float64,
                                    sim_steps=sim_steps)
    yref, yref_e = hover_yref(js)
    return js, tspec, yref, yref_e


def _cmp_out(got, want, tag):
    for f in RTI_FIELDS:
        _close(getattr(got, f), getattr(want, f), f"{tag} {f}")


@pytest.mark.parametrize("sim_steps, opts", [
    (1, dict(fused_prep=False)),
    (1, dict(fused_prep=False, condense=1)),
    (2, {}),
], ids=["fused_prep_false", "fused_prep_false_condense1", "sim_steps2"])
def test_batched_xla_preparation(sim_steps, opts):
    """rti_step_batched's XLA-style preparation (jacfwd linearization) and
    the same solver, two chained steps, against the JAX package's same
    options; no kernel is launched on CPU tensors."""
    js, tspec, yref, yref_e = _pair(sim_steps)
    rng = np.random.default_rng(17)
    x0s = (np.asarray(hover_state(js.params, dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    x0s[:2, 0] += 1.0
    jst = jax.vmap(lambda x: init_rti(js, x))(jnp.asarray(x0s))
    cfg = dict(iters=8)

    def j_one(st, x):
        return j_step(js, st, x, yref, yref_e, JCfg(**cfg), block_b=B,
                      stages_per_step=1, interpret=True, **opts)

    jx = jnp.asarray(x0s)
    step = jax.jit(j_one).lower(jst, jx).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    st = ts.init_rti(tspec, _t(x0s), device="cpu")
    kc.reset_launch_counts()
    for k in range(2):
        jst, jout = step(jst, jx)
        st, out = rti_step_batched(tspec, st, _t(x0s), _t(yref),
                                   _t(yref_e), TCfg(**cfg), **opts)
        _cmp_out(out, jout, f"step {k}")
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)


def test_xla_preparation_matches_the_kernel_preparation():
    """The two preparations build the same QP (jacfwd vs the exact ERK4
    VDE), so their steps agree to rounding, in either layout."""
    _, tspec, yref, yref_e = _pair()
    rng = np.random.default_rng(3)
    x0s = _t(np.eye(1, 13, 3) + 0.05 * rng.standard_normal((B, 13)))
    st = ts.init_rti(tspec, x0s, device="cpu")
    y, ye = _t(yref), _t(yref_e)
    for layout in ("batch_first", "batch_last"):
        s0 = (st if layout == "batch_first" else
              dataclasses.replace(st, x_traj=st.x_traj.movedim(0, -1),
                                  u_traj=st.u_traj.movedim(0, -1)))
        _, a = rti_step_batched(tspec, s0, x0s, y, ye, TCfg(iters=8),
                                layout=layout)
        _, b = rti_step_batched(tspec, s0, x0s, y, ye, TCfg(iters=8),
                                fused_prep=False, layout=layout)
        for f in RTI_FIELDS:
            _close(getattr(b, f), getattr(a, f).numpy(), f"{layout} {f}")
