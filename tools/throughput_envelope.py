"""The throughput mode's distances on the CPU, from the JAX package.

The throughput mode (bench.py: `IPMConfig(iters=8, compress_gains=True,
compress_ab=True)` with `prep_vde_order=2`) trades accuracy for bytes.
This tool measures how far one step of it lands, with the Pallas kernels
in interpret mode on the CPU, on the lanes a smoke test of another
implementation holds: hover plus 0.05 of seeded noise on every state
(numpy's default_rng(seed), stored in float32), the first `lanes` of a
batch of `batch`, N=50, tf=0.75.  One step from `init_rti`:

  compressed, float64  vs  uncompressed (IPMConfig(iters=8), order-4 VDE),
                           float64: max |du - du_exact| / max |du_exact|,
                           du the step's control plan minus the initial one;
  compressed, float32  vs  the same, and vs compressed float64: max |u0|
                           difference [kRPM] and max |x_plan| difference.

Run:
    python tools/throughput_envelope.py [--batch 2048 --seed 2048 --lanes 64]
It prints one JSON line of these numbers.
"""

import argparse
import json
import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from crazyflie_nmpc_tpu.models import hover_state  # noqa: E402
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig  # noqa: E402
from crazyflie_nmpc_tpu.solver import (default_ocp, hover_yref,  # noqa: E402
                                       init_rti)
from crazyflie_nmpc_tpu.solver.rti_batched import rti_step_batched  # noqa

N, TF = 50, 0.75
THROUGHPUT = dict(iters=8, compress_gains=True, compress_ab=True)


def lanes_x0(batch, seed, lanes):
    """The lanes' initial states, float32 values as float64."""
    x = np.asarray(hover_state(default_ocp(N=N).params, dtype=jnp.float64))
    rng = np.random.default_rng(seed)
    x0s = x[None] + 0.05 * rng.standard_normal((batch, 13))
    return x0s.astype(np.float32).astype(np.float64)[:lanes]


def step(x0s, dtype, config, vde_order):
    """One step from init_rti: (the step's control plan minus the initial
    one, u0, x_plan) as float64 numpy."""
    spec = default_ocp(N=N, tf=TF, dtype=dtype)
    yref, yref_e = hover_yref(spec)
    x = jnp.asarray(x0s, dtype)
    st = jax.vmap(lambda x: init_rti(spec, x))(x)
    _, out = jax.jit(lambda s, x: rti_step_batched(
        spec, s, x, yref, yref_e, config, block_b=x0s.shape[0],
        stages_per_step=1, prep_stages_per_step=1, interpret=True,
        prep_vde_order=vde_order))(st, x)
    f64 = lambda a: np.asarray(a, dtype=np.float64)  # noqa: E731
    return f64(out.u_plan) - f64(st.u_traj), f64(out.u0), f64(out.x_plan)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=2048)
    ap.add_argument("--lanes", type=int, default=64)
    a = ap.parse_args()
    x0s = lanes_x0(a.batch, a.seed, a.lanes)
    exact = step(x0s, jnp.float64, IPMConfig(iters=8), 4)
    comp64 = step(x0s, jnp.float64, IPMConfig(**THROUGHPUT), 2)
    comp32 = step(x0s, jnp.float32, IPMConfig(**THROUGHPUT), 2)
    scale = float(np.abs(exact[0]).max())

    def dev(run):
        return float(np.abs(run[0] - exact[0]).max()) / scale
    print(json.dumps(dict(
        batch=a.batch, seed=a.seed, lanes=a.lanes, du_exact_max=scale,
        dev_f64=dev(comp64), dev_f32=dev(comp32),
        f32_vs_f64_u0=float(np.abs(comp32[1] - comp64[1]).max()),
        f32_vs_f64_x_plan=float(np.abs(comp32[2] - comp64[2]).max()))))


if __name__ == "__main__":
    main()
