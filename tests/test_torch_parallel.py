"""The port's `parallel/` on `torch.distributed` against the JAX package's,
on the CPU.

The port's side runs as gloo ranks in child processes (torch on one
intra-op thread each, a `file://` rendezvous under tmp_path): two ranks
for the steps held against JAX, four for the layouts the card's
[pod_ranks] phase runs (four stage ranks; a 2 x 2 mesh whose rows solve
different problems).  The JAX side runs in-process on conftest's 8
virtual CPU devices, each distinct program compiled once at XLA's
optimization level 0.  float64 throughout:

  * `stage_sharded_rti_step`, N=20, stage=2, block 2, against JAX's to
    1e-10;
  * `batch_sharded_rti`, B=4, N=10, batch=2, with escalation on one lane
    (the vmapped solve, then the re-solve), against JAX's to 1e-10;
  * `fleet_metrics` on the same kkt/mu arrays: equal;
  * `pod_rti_step` over 2 ranks, N=10, against the port's own unsharded
    `rti_step_batched` (held against JAX's elsewhere) to 1e-12.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from crazyflie_nmpc_tpu_torch import solver as ts
from crazyflie_nmpc_tpu_torch.models import hover_state
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.parallel import (BATCH_AXIS, STAGE_AXIS,
                                               batch_sharded_rti,
                                               fleet_metrics,
                                               init_distributed, make_mesh,
                                               pod_rti_step,
                                               stage_sharded_rti_step)
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched
from _torch_shared import one_torch_thread  # noqa: F401

TOL_JAX = 1e-10
TOL_POD = 1e-12
STAGE_N, STAGE_BLOCK = 20, 2
STAGE_CFG = dict(iters=10)
BATCH_N, BATCH_B = 10, 4
BATCH_CFG = dict(iters=6, escalate_iters=12)   # lane 2 escalates
POD_N, POD_B = 10, 4
POD_CFG = dict(iters=8)
QUAD_N = 16                                     # four stage ranks, block 2
KKT = np.array([3e-3, 7e-2, 1e-5, 4e-4, 2.5e-2, 9e-3])
MU = np.array([1e-9, 3e-7, 2e-12, 5e-10, 8e-8, 1e-11])


def _spec(n):
    return ts.default_ocp(N=n, dtype=torch.float64, device="cpu")


def _stage_problem(n, pos=(0.1, -0.05, 0.3)):
    spec = _spec(n)
    x0 = hover_state(spec.params, pos=pos, dtype=torch.float64,
                     device="cpu")
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    return spec, ts.init_rti(spec, x0, device="cpu"), x0, yref, yref_e


def _batch_x0s(seed, B, n):
    """Hover plus seeded noise; lanes 0 and 2 start 0.3 m off."""
    rng = np.random.default_rng(seed)
    x = hover_state(_spec(n).params, dtype=torch.float64,
                    device="cpu").numpy()
    x0s = x + 0.05 * rng.standard_normal((B, 13))
    x0s[0, 0] += 0.3
    x0s[2, 2] -= 0.3
    return x0s


def _batch_problem(n, B, seed):
    spec = _spec(n)
    x0s = torch.as_tensor(_batch_x0s(seed, B, n))
    yref, yref_e = ts.hover_yref(spec, device="cpu")
    return spec, ts.init_rti(spec, x0s, device="cpu"), x0s, yref, yref_e


def _save(out, name, rank, **arrays):
    np.savez(os.path.join(out, f"{name}_rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in arrays.items()})


def _two_ranks(rank, out):
    """Rank `rank` of 2: the steps held against JAX and the pod step."""
    spec, st, x0, yref, yref_e = _stage_problem(STAGE_N)
    mesh = make_mesh(batch=1, stage=2)
    new, o = stage_sharded_rti_step(spec, mesh, STAGE_BLOCK, st, x0, yref,
                                    yref_e, IPMConfig(**STAGE_CFG))
    _save(out, "stage", rank, x=new.x_traj, u=new.u_traj, kkt=o.kkt_res,
          mu=o.qp_mu)

    mesh = make_mesh(batch=2, stage=1)
    spec, st, x0s, yref, yref_e = _batch_problem(BATCH_N, BATCH_B, 7)
    rows = [mesh.shard(a) for a in (st.x_traj, st.u_traj, x0s)]
    step = batch_sharded_rti(spec, mesh, IPMConfig(**BATCH_CFG),
                             device="cpu")
    new, o = step(ts.RTIState(x_traj=rows[0], u_traj=rows[1]), rows[2],
                  yref.expand(len(rows[2]), *yref.shape),
                  yref_e.expand(len(rows[2]), 13))
    _save(out, "batch", rank, u=new.u_traj, x=new.x_traj, u0=o.u0,
          kkt=o.kkt_res, mu=o.qp_mu)

    kkt, mu = fleet_metrics(mesh)(mesh.shard(torch.as_tensor(KKT)),
                                  mesh.shard(torch.as_tensor(MU)))
    _save(out, "fleet", rank, kkt=kkt, mu=mu,
          bcast=mesh.broadcast(torch.tensor([10.0 + rank]), BATCH_AXIS,
                               src=1),
          gather=mesh.all_gather(torch.tensor([10.0 + rank]), BATCH_AXIS))

    spec, st, x0s, yref, yref_e = _batch_problem(POD_N, POD_B, 11)
    step = pod_rti_step(spec, mesh, IPMConfig(**POD_CFG), device="cpu")
    new, o = step(ts.RTIState(x_traj=mesh.shard(st.x_traj),
                              u_traj=mesh.shard(st.u_traj)),
                  mesh.shard(x0s), yref, yref_e)
    kkt, mu = fleet_metrics(mesh)(o.kkt_res, o.qp_mu)
    _save(out, "pod", rank, u=new.u_traj, x=new.x_traj, u0=o.u0,
          kkt=o.kkt_res, mu=o.qp_mu, fleet_kkt=kkt, fleet_mu=mu)


def _row_pos(b):
    return (0.2 - 0.3 * b, -0.1, 0.4)


def _four_ranks(rank, out):
    """Rank `rank` of 4: four stage ranks at N=16; then a 2 x 2 mesh whose
    two rows each stage-shard a problem of their own."""
    spec, st, x0, yref, yref_e = _stage_problem(QUAD_N)
    mesh = make_mesh(batch=1, stage=4)
    new, o = stage_sharded_rti_step(spec, mesh, 2, st, x0, yref, yref_e,
                                    IPMConfig(**STAGE_CFG))
    _save(out, "stage4", rank, u=new.u_traj, x=new.x_traj, kkt=o.kkt_res)

    mesh = make_mesh(batch=2, stage=2)
    b = mesh.index(BATCH_AXIS)
    spec, st, x0, yref, yref_e = _stage_problem(QUAD_N, _row_pos(b))
    new, o = stage_sharded_rti_step(spec, mesh, 4, st, x0, yref, yref_e,
                                    IPMConfig(**STAGE_CFG))
    kkt, _ = fleet_metrics(mesh)(o.kkt_res[None], o.qp_mu[None])
    _save(out, "grid", rank, u=new.u_traj, kkt=o.kkt_res, fleet_kkt=kkt,
          row=b, col=mesh.index(STAGE_AXIS))


def _rank_main(rank, world, init, out, job):
    torch.set_num_threads(1)
    assert init_distributed(init, world, rank, backend="gloo") == (world,
                                                                   rank)
    try:
        job(rank, out)
    finally:
        torch.distributed.destroy_process_group()


def _spawn(tmp_path, world, job):
    out = str(tmp_path)
    mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                       args=(world, f"file://{tmp_path}/rendezvous", out,
                             job))

    def load(name, rank):
        return dict(np.load(os.path.join(out, f"{name}_rank{rank}.npz")))
    return load


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("two"), 2, _two_ranks)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("four"), 4, _four_ranks)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX package's program `name` on the 8 virtual devices, at XLA's
    optimization level 0: its outputs as numpy."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from crazyflie_nmpc_tpu import parallel as jp
    from crazyflie_nmpc_tpu.models import hover_state as jhover
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig as JCfg
    from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti

    def compiled(fn, *args):
        return jax.jit(fn).lower(*args).compile(compiler_options={
            "xla_backend_optimization_level": 0})(*args)

    if name == "stage":
        spec = default_ocp(N=STAGE_N, dtype=jnp.float64)
        mesh = jp.make_mesh(batch=1, stage=2)
        x0 = jhover(spec.params, pos=(0.1, -0.05, 0.3))
        yref, yref_e = hover_yref(spec)
        fn = shard_map(
            lambda s, x, yr, ye: jp.stage_sharded_rti_step(
                spec, mesh, STAGE_BLOCK, s, x, yr, ye, JCfg(**STAGE_CFG)),
            mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=(P(), P()),
            check_vma=False)
        new, o = compiled(fn, init_rti(spec, x0), x0, yref, yref_e)
        return dict(x=new.x_traj, u=new.u_traj, kkt=o.kkt_res, mu=o.qp_mu)
    if name == "batch":
        spec = default_ocp(N=BATCH_N, dtype=jnp.float64)
        mesh = jp.make_mesh(batch=2, stage=1)
        x0s = jnp.asarray(_batch_x0s(7, BATCH_B, BATCH_N))
        yref, yref_e = hover_yref(spec)
        st = jax.vmap(lambda x: init_rti(spec, x))(x0s)
        step = jp.batch_sharded_rti(spec, mesh, JCfg(**BATCH_CFG))
        new, o = step(st, x0s, jnp.broadcast_to(yref, (BATCH_B,) + yref.shape),
                      jnp.broadcast_to(yref_e, (BATCH_B, 13)))
        return dict(x=new.x_traj, u=new.u_traj, u0=o.u0, kkt=o.kkt_res,
                    mu=o.qp_mu)
    mesh = jp.make_mesh(batch=2, stage=1)
    kkt, mu = jp.fleet_metrics(mesh)(jnp.asarray(KKT), jnp.asarray(MU))
    return dict(kkt=kkt, mu=mu)


def _held(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol, err


@pytest.mark.parametrize("field", ["u", "x", "kkt", "mu"])
def test_stage_sharded_matches_jax(two, field):
    want = np.asarray(_jax_run("stage")[field])
    for rank in range(2):           # replicated: every rank has the step
        _held(two("stage", rank)[field], want, TOL_JAX)


@pytest.mark.parametrize("field", ["u", "x", "u0", "kkt", "mu"])
def test_batch_sharded_matches_jax(two, field):
    want = np.asarray(_jax_run("batch")[field])
    got = np.concatenate([two("batch", r)[field] for r in range(2)])
    _held(got, want, TOL_JAX)


def test_batch_sharded_escalates_one_lane(two):
    """The re-solve path runs: lane 2 misses the tolerance after 6
    iterations and is solved again at 12 (without the re-solve its mu
    stays ~1e-5)."""
    mu = np.concatenate([two("batch", r)["mu"] for r in range(2)])
    assert mu[2] < 1e-15 and (mu < 1e-9).all(), mu


def test_broadcast_and_gather_follow_the_axis(two):
    for rank in range(2):
        got = two("fleet", rank)
        assert got["bcast"].tolist() == [11.0]
        assert got["gather"].tolist() == [[10.0], [11.0]]


def test_fleet_metrics_match_jax(two):
    want = _jax_run("fleet")
    for rank in range(2):
        got = two("fleet", rank)
        assert float(got["kkt"]) == float(want["kkt"]) == KKT.max()
        assert float(got["mu"]) == pytest.approx(float(want["mu"]),
                                                 rel=1e-15, abs=0.0)


@pytest.fixture(scope="module")
def pod_reference():
    spec, st, x0s, yref, yref_e = _batch_problem(POD_N, POD_B, 11)
    return rti_step_batched(spec, st, x0s, yref, yref_e,
                            IPMConfig(**POD_CFG))


@pytest.mark.parametrize("field", ["u", "x", "u0", "kkt", "mu"])
def test_pod_step_matches_unsharded(two, pod_reference, field):
    new, o = pod_reference
    want = {"u": new.u_traj, "x": new.x_traj, "u0": o.u0, "kkt": o.kkt_res,
            "mu": o.qp_mu}[field].numpy()
    got = np.concatenate([two("pod", r)[field] for r in range(2)])
    _held(got, want, TOL_POD)


def test_pod_fleet_metrics_span_both_ranks(two, pod_reference):
    _, o = pod_reference
    for rank in range(2):
        got = two("pod", rank)
        assert float(got["fleet_kkt"]) == float(o.kkt_res.max())
        assert float(got["fleet_mu"]) == pytest.approx(
            float(o.qp_mu.mean()), rel=1e-14)


def _stage_reference(n, pos=(0.1, -0.05, 0.3)):
    spec, st, x0, yref, yref_e = _stage_problem(n, pos)
    return ts.rti_step(spec, st, x0, yref, yref_e, IPMConfig(**STAGE_CFG))


def test_four_stage_ranks_match_rti_step(four):
    new, o = _stage_reference(QUAD_N)
    for rank in range(4):
        got = four("stage4", rank)
        _held(got["u"], new.u_traj.numpy(), TOL_JAX)
        _held(got["x"], new.x_traj.numpy(), TOL_JAX)
        _held(got["kkt"], o.kkt_res.numpy(), TOL_JAX)


def test_grid_rows_solve_their_own_problems(four):
    """On the 2 x 2 mesh the stage groups are the rows: each row's ranks
    agree with `rti_step` on the row's problem, and the batch-axis metric
    spans the rows."""
    refs = [_stage_reference(QUAD_N, _row_pos(b)) for b in range(2)]
    seen = set()
    for rank in range(4):
        got = four("grid", rank)
        b = int(got["row"])
        seen.add((b, int(got["col"])))
        _held(got["u"], refs[b][0].u_traj.numpy(), TOL_JAX)
        _held(got["fleet_kkt"], max(float(r[1].kkt_res) for r in refs),
               TOL_JAX)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_one_process_mesh_needs_no_distributed():
    """Without torch.distributed the mesh is the one process: the
    stage-sharded step is the plain step, the collectives identities."""
    mesh = make_mesh()
    assert mesh.shape == {BATCH_AXIS: 1, STAGE_AXIS: 1}
    spec, st, x0, yref, yref_e = _stage_problem(STAGE_N)
    new, _ = stage_sharded_rti_step(spec, mesh, 4, st, x0, yref, yref_e,
                                    IPMConfig(**STAGE_CFG))
    ref, _ = _stage_reference(STAGE_N)
    _held(new.u_traj.numpy(), ref.u_traj.numpy(), TOL_JAX)
    t = torch.arange(3.0)
    assert mesh.all_gather(t, STAGE_AXIS).tolist() == [[0.0, 1.0, 2.0]]
    assert mesh.all_reduce(t, BATCH_AXIS, "mean").tolist() == t.tolist()


def test_stage_sharded_refuses_an_uneven_split():
    spec, st, x0, yref, yref_e = _stage_problem(STAGE_N)
    with pytest.raises(ValueError, match="divisible"):
        stage_sharded_rti_step(spec, make_mesh(), 3, st, x0, yref, yref_e)


def test_stage_sharded_runs_a_custom_model():
    """R7 (ROADMAP Queue 3): the JAX package's stage-sharded step
    linearizes the quadrotor's `dynamics` whatever `spec.f` is and
    reshapes by its NX/NU (`parallel/sharded.py:88,139,142`); the port's
    takes the spec's ODE and dims, so a custom model (the cart-pole)
    gives `rti_step`'s step."""
    from crazyflie_nmpc_tpu_torch.models import cartpole_ocp

    spec = cartpole_ocp(N=20, device="cpu")
    x0 = torch.tensor([0.0, 0.3, 0.0, 0.0], dtype=torch.float64)
    yref = torch.zeros((spec.N, 5), dtype=torch.float64)
    yref_e = torch.zeros(4, dtype=torch.float64)
    st = ts.init_rti(spec, x0, device="cpu")
    cfg = IPMConfig(iters=10)
    new, o = stage_sharded_rti_step(spec, make_mesh(), 4, st, x0, yref,
                                    yref_e, cfg)
    ref, ro = ts.rti_step(spec, st, x0, yref, yref_e, cfg)
    _held(new.u_traj.numpy(), ref.u_traj.numpy(), TOL_JAX)
    _held(new.x_traj.numpy(), ref.x_traj.numpy(), TOL_JAX)
    _held(o.kkt_res.numpy(), ro.kkt_res.numpy(), TOL_JAX)
