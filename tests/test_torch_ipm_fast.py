"""The port's `solve_batched` vs the JAX package's (float64, N=10, B=8).

Both solve the same precondensed QP (JAX `prep_condense2` in Pallas
interpret mode, carried across as numpy arrays): the plain Mehrotra path
with iters=8, and per-lane escalation (iters=2, escalate_iters=8,
capacity=4) including the number of escalated lanes and which.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops import ipm_fast as jfast
from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
from crazyflie_nmpc_tpu.ops.pallas import prep_kernel as jpk
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu_torch.ops import ipm_fast as tfast
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig as TCfg
from _torch_shared import one_torch_thread  # noqa: F401

N, B = 10, 8
FIELDS = ("dx", "du", "lam_l", "lam_u", "mu", "res_stat", "res_eq")
CONFIGS = {
    "iters8": dict(iters=8),
    "escalate": dict(iters=2, escalate_iters=8, escalate_capacity=4),
}


@pytest.fixture(scope="module")
def qp():
    """A batch-last precondensed QP as rti_step_batched builds it, from
    saturating and benign lanes (x offsets up to 1 m)."""
    rng = np.random.default_rng(9)
    spec = default_ocp(N=N, dtype=jnp.float64)
    yref, yref_e = hover_yref(spec)
    x0s = (np.asarray(hover_state(spec.params, dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    x0s[:3, 0] += np.array([1.0, -0.6, 0.4])
    st = jax.vmap(lambda x: init_rti(spec, x))(jnp.asarray(x0s))
    x = jnp.moveaxis(st.x_traj, 0, -1)
    u = jnp.moveaxis(st.u_traj, 0, -1)
    W = jnp.diagonal(spec.cost.W)
    tile = lambda v: jnp.broadcast_to(jnp.asarray(v)[:, None],  # noqa: E731
                                      (len(v), B))
    par = spec.params
    cnd, Ae, Be, c, lb, ub = jpk.prep_condense2(
        x, u, jnp.broadcast_to(yref[:, :, None], (N, 17, B)),
        tile(W[:13]), tile(W[13:]), tile(spec.lbu), tile(spec.ubu),
        tile(jnp.array([par.g0, par.mq, par.Ixx, par.Iyy, par.Izz, par.Cd,
                        par.Ct, par.l, float(spec.dt)])),
        block_b=B, pairs_per_step=1, interpret=True)
    pT = jnp.diagonal(spec.cost.W_e)
    q = dict(c=c, lb=lb, ub=ub, c2Ae=Ae, c2Be=Be,
             ruu=jnp.broadcast_to(W[13:][None, :, None], (N, 4, B)),
             pT=tile(pT), p=pT[:, None] * (x[-1] - yref_e[:, None]),
             dx0=jnp.asarray(x0s).T - x[0],
             **{"c2" + k: v for k, v in cnd.items()})
    return {k: np.array(v) for k, v in q.items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def solved(request, qp):
    kw = CONFIGS[request.param]
    jsol = jax.jit(lambda q: jfast.solve_batched(
        q, JCfg(**kw), block_b=B, stages_per_step=2, interpret=True,
        condense=2))({k: jnp.asarray(v) for k, v in qp.items()})
    tsol = tfast.solve_batched({k: torch.as_tensor(v) for k, v in qp.items()},
                               TCfg(**kw), condense=2)
    return request.param, jsol, tsol


def _field(sol, name):
    return sol.stats[name] if name in ("mu", "res_stat", "res_eq") \
        else getattr(sol, name)


@pytest.mark.parametrize("name", FIELDS)
def test_solve_batched_matches_jax(solved, name):
    _, jsol, tsol = solved
    got, want = np.asarray(_field(tsol, name)), np.asarray(_field(jsol, name))
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * scale)


def test_escalated_count_matches_jax(solved):
    label, jsol, tsol = solved
    if label != "escalate":
        assert "escalated" not in tsol.stats
        return
    n = int(tsol.stats["escalated"])
    assert n == int(jsol.stats["escalated"])
    assert 0 < n <= 4
    assert int(tsol.stats["escalated_lanes"].sum()) == n


def test_escalated_lanes_are_the_worst_unconverged(qp):
    """The reported lanes are the `capacity` unconverged lanes of largest
    mu after the first pass."""
    kw = CONFIGS["escalate"]
    tq = {k: torch.as_tensor(v) for k, v in qp.items()}
    first = tfast.solve_batched(tq, TCfg(iters=kw["iters"]),
                                condense=2).stats["mu"]
    lanes = tfast.solve_batched(tq, TCfg(**kw),
                                condense=2).stats["escalated_lanes"]
    bad = first > TCfg().escalate_mu_tol
    worst = torch.argsort(torch.where(bad, first, -torch.inf),
                          descending=True)[:kw["escalate_capacity"]]
    want = torch.zeros_like(bad)
    want[worst] = bad[worst]
    assert lanes.dtype == torch.bool and lanes.shape == (B,)
    assert torch.equal(lanes, want)


def test_max_step_lane_masks_nonbinding_entries():
    """Entries with dv >= 0 never bind; the step is capped at 1."""
    v = torch.tensor([[[1.0, 2.0], [4.0, 1.0]]])            # (1, 2, 2)
    dv = torch.tensor([[[-2.0, 5.0], [0.0, -0.5]]])
    got = tfast._max_step_lane(v, dv, 0.9)
    np.testing.assert_allclose(got, [0.9 * 0.5, 1.0])


def _qpdata_arrays(n_batch=4, horizon=10, seed=11):
    """One seeded batch-first QP of the reference cost structure (Qxx, Ruu
    and P diagonal, S = 0), as numpy float64 arrays keyed by QPData field:
    A near the identity, bounds finite on most inputs, infinite on some."""
    rng = np.random.default_rng(seed)
    nb, n = n_batch, horizon
    r = lambda *s: rng.standard_normal((nb, *s))  # noqa: E731
    diag = lambda d: d[..., :, None] * np.eye(d.shape[-1])  # noqa: E731
    lb = -rng.uniform(0.05, 0.3, (nb, n, 4))
    ub = rng.uniform(0.05, 0.3, (nb, n, 4))
    lb[:, ::3, 1] = -np.inf
    ub[:, 1::4, 2] = np.inf
    return dict(A=np.eye(13) + 0.05 * r(n, 13, 13), B=0.1 * r(n, 13, 4),
                c=0.01 * r(n, 13),
                Qxx=diag(rng.uniform(0.5, 2.0, (nb, n, 13))), qx=0.1 * r(n, 13),
                Ruu=diag(rng.uniform(0.5, 2.0, (nb, n, 4))), ru=0.1 * r(n, 4),
                S=np.zeros((nb, n, 4, 13)),
                P=diag(rng.uniform(1.0, 5.0, (nb, 13))), p=0.1 * r(13),
                lb=lb, ub=ub, dx0=0.1 * r(13))


def test_from_qpdata_matches_jax():
    """The port's from_qpdata gives JAX's dict: the same keys, shapes and
    values (JAX's plain jnp function, no solver)."""
    from crazyflie_nmpc_tpu.ops.qp import QPData as JQP
    from crazyflie_nmpc_tpu_torch.ops.qp import QPData as TQP

    arrs = _qpdata_arrays()
    want = jfast.from_qpdata(JQP(**{k: jnp.asarray(v)
                                    for k, v in arrs.items()}))
    got = tfast.from_qpdata(TQP(**{k: torch.as_tensor(v)
                                   for k, v in arrs.items()}))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float64 and got[k].is_contiguous(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


def test_solve_batched_from_qpdata_matches_ipm_solve():
    """solve_batched on from_qpdata's dict solves each lane as the port's
    single-instance ops.ipm.solve does on that lane's QPData."""
    from crazyflie_nmpc_tpu_torch.ops import ipm as tipm
    from crazyflie_nmpc_tpu_torch.ops.qp import QPData as TQP

    arrs = {k: torch.as_tensor(v) for k, v in _qpdata_arrays().items()}
    cfg = TCfg(iters=8)
    fast = tfast.solve_batched(tfast.from_qpdata(TQP(**arrs)), cfg)
    for i in range(arrs["A"].shape[0]):
        ref = tipm.solve(TQP(**{k: v[i] for k, v in arrs.items()}), cfg)
        for name in ("dx", "du", "lam_l", "lam_u"):
            got = getattr(fast, name)[..., i]
            want = getattr(ref, name)
            scale = max(1.0, float(want[torch.isfinite(want)].abs().max()))
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-9 * scale,
                                       err_msg=f"{name} lane {i}")
