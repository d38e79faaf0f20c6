"""The batched closed loops (`runtime.batch`) vs the JAX package's,
on the CPU: `swarm_hover` at N=10, B=8, float64, over 3 ticks against
JAX's (Pallas kernels in interpret mode, block_b=8, jitted once at XLA's
optimization level 0) to 1e-9 relative to max(1, max |JAX|);
`monte_carlo_hover` reproducible from a seeded generator.  On CPU tensors
the step takes the plain versions and launches no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.runtime import batch as jbatch
from crazyflie_nmpc_tpu.solver import default_ocp
from crazyflie_nmpc_tpu_torch import convert
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime import batch as tbatch
from _torch_shared import one_torch_thread  # noqa: F401

N, B, TICKS = 10, 8, 3
TOL = 1e-9


@pytest.fixture(scope="module")
def swarm():
    js = default_ocp(N=N, tf=0.015 * N, dtype=jnp.float64)
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                    device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(4)
    x = np.asarray(hover_state(js.params, pos=(0.0, 0.0, 0.5),
                               dtype=jnp.float64))
    x_inits = x + 0.02 * rng.standard_normal((B, 13))
    x_inits[:, :3] += 0.2 * rng.standard_normal((B, 3))
    setpoints = np.tile([0.0, 0.0, 0.5], (B, 1)) + 0.1 * rng.standard_normal(
        (B, 3))

    def jloop(xi, sp):
        return jbatch.swarm_hover(js, xi, sp, TICKS, config=JCfg(iters=8),
                                  block_b=B, interpret=True)

    jargs = (jnp.asarray(x_inits), jnp.asarray(setpoints))
    want = jax.jit(jloop).lower(*jargs).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*jargs)
    kc.reset_launch_counts()
    got = tbatch.swarm_hover(tspec, torch.as_tensor(x_inits),
                             torch.as_tensor(setpoints), TICKS,
                             config=IPMConfig(iters=8))
    return want, got, kc.launch_counts()


@pytest.mark.parametrize("field", ["x", "u", "kkt_res"])
def test_swarm_hover_matches_jax(swarm, field):
    want, got, _ = swarm
    w = np.asarray(getattr(want, field), np.float64)
    g = getattr(got, field).numpy()
    assert g.shape == w.shape
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                               err_msg=field)


def test_swarm_hover_on_cpu_launches_no_kernel(swarm):
    assert swarm[2] == dict.fromkeys(kc.KERNELS, 0)


def test_monte_carlo_hover_is_reproducible():
    """The same seed gives the same run; another seed other initial
    states; the offsets are pos_scale * N(0, 1) around the set-point."""
    from crazyflie_nmpc_tpu_torch import solver as ts

    spec = ts.default_ocp(N=N, tf=0.015 * N, dtype=torch.float32,
                          device="cpu")

    def run(seed, scale=0.2):
        gen = torch.Generator().manual_seed(seed)
        return tbatch.monte_carlo_hover(spec, gen, batch=4, steps=2,
                                        pos_scale=scale,
                                        config=IPMConfig(iters=4))

    a, b, c = run(0), run(0), run(1)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.x[0], c.x[0])
    assert a.x.shape == (2, 4, 13) and a.x.dtype == torch.float32
    offs = 0.2 * torch.randn((4, 3), generator=torch.Generator()
                             .manual_seed(0))
    torch.testing.assert_close(a.x[0, :, :3],
                               offs + torch.tensor([0.0, 0.0, 0.5]))
    still = run(0, scale=0.0)
    assert bool((still.x[0, :, :3] == torch.tensor([0.0, 0.0, 0.5])).all())
