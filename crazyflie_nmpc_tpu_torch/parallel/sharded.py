"""Sharded NMPC execution over a (batch, stage) rank mesh (counterpart of
`parallel/sharded.py`).

Two composable parallel axes (replacing the reference's one-thread-per-
drone concurrency, crazyflie_server.cpp:155,1108-1131, with SPMD over a
mesh):

  * batch: independent OCP instances sharded across ranks; solves never
    communicate (metrics reduce if asked).
  * stage: the prediction horizon's heavy per-stage work (RK4 + jacfwd
    linearization and partial condensing) computed on the rank owning
    that block of stages.  Only the small condensed problem (N/b reduced
    stages of (nx, b*nu) blocks) is all-gathered; the reduced Riccati/IPM
    runs replicated (it is tiny), and expansion is local again.

State trajectories are KB-sized, so they stay replicated along `stage`;
what is sharded is the compute and its outputs.  Every rank of the mesh
calls these functions (SPMD), where the JAX package wraps them in
`shard_map`.  Plain PyTorch, as the JAX package's are XLA: no
hand-written kernel runs here.
"""

from __future__ import annotations

import dataclasses

import torch

from crazyflie_nmpc_tpu_torch.device import host_sync, resolve_device
from crazyflie_nmpc_tpu_torch.ops import condensing, ipm
from crazyflie_nmpc_tpu_torch.ops.integrators import linearize_trajectory
from crazyflie_nmpc_tpu_torch.ops.qp import (QPData, build_qp,
                                             gauss_newton_cost_blocks)
from crazyflie_nmpc_tpu_torch.parallel.mesh import BATCH_AXIS, STAGE_AXIS
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import RTIOutput, RTIState, rti_step


def batch_sharded_rti(spec: OCPSpec, mesh,
                      config: ipm.IPMConfig = ipm.IPMConfig(), device=None):
    """Batched single-instance RTI step on this rank's shard of the batch.

    Returns fn(states, x0s, yrefs, yref_es) -> (states', outs); every
    leading dim is this rank's rows of the global batch (`Mesh.shard`).
    The lanes run as `torch.func.vmap` of `solver.rti_step`, with no
    communication.

    Escalation (`config.escalate_iters > 0`) cannot read its branch on
    the host inside vmap: the lanes are solved without it, then the lanes
    whose final mu misses the tolerance (one counted host sync) are solved
    again, vmapped, at the escalated budget, which is the JAX package's
    per-lane `lax.cond` result.
    """
    resolve_device(device)
    mesh.index(BATCH_AXIS)
    primary = dataclasses.replace(config, escalate_iters=0)
    escalated = dataclasses.replace(config, iters=config.escalate_iters,
                                    escalate_iters=0, gondzio_correctors=0)

    def lanes(cfg, x_traj, u_traj, x0s, yrefs, yref_es):
        def one(x, u, x0, yr, ye):
            st, out = rti_step(spec, RTIState(x_traj=x, u_traj=u), x0, yr,
                               ye, cfg)
            return st.x_traj, st.u_traj, out
        return torch.func.vmap(one)(x_traj, u_traj, x0s, yrefs, yref_es)

    def step(states, x0s, yrefs, yref_es):
        args = (states.x_traj, states.u_traj, x0s, yrefs, yref_es)
        x, u, out = lanes(primary, *args)
        if config.escalate_iters > 0:
            with host_sync("escalation"):
                idx = torch.nonzero(out.qp_mu > config.escalate_mu_tol)
            idx = idx.flatten()
            if idx.numel():
                xe, ue, oe = lanes(escalated, *(a[idx] for a in args))
                x, u = x.index_copy(0, idx, xe), u.index_copy(0, idx, ue)
                out = type(out)(*(a.index_copy(0, idx, b)
                                  for a, b in zip(out, oe)))
        return RTIState(x_traj=x, u_traj=u), out

    return step


def stage_sharded_rti_step(spec: OCPSpec, mesh, block: int,
                           state: RTIState, x0, yref, yref_e,
                           config: ipm.IPMConfig = ipm.IPMConfig()):
    """One RTI step with linearization + condensing sharded over
    STAGE_AXIS; every rank along the axis calls it with the same
    (replicated) arguments and gets the same result.

    Each of the `d` stage ranks linearizes and condenses its N/d-stage
    chunk, the condensed stage problems are all-gathered (one collective),
    the reduced IPM runs replicated, and each rank expands its local
    chunk; the expanded chunks are all-gathered (one more) and the NLP
    residual maxed over the axis (one more).
    """
    d = mesh.shape[STAGE_AXIS]
    N = spec.N
    if N % (d * block) != 0:
        raise ValueError(
            f"N={N} must be divisible by stage_devices*block={d * block}")
    chunk = N // d
    idx = mesh.index(STAGE_AXIS)
    k0 = idx * chunk
    cost = spec.cost
    x_traj, u_traj = state.x_traj, state.u_traj
    nx, nu = x_traj.shape[-1], u_traj.shape[-1]

    # stage-local linearization (the expensive jacfwd work)
    x_chunk = x_traj[k0:k0 + chunk + 1]
    u_chunk = u_traj[k0:k0 + chunk]
    x_next, A, B = linearize_trajectory(spec.ode(), spec.params, x_chunk,
                                        u_chunk, spec.dt, spec.sim_steps)
    blocks = gauss_newton_cost_blocks(
        cost.W, cost.Vx, cost.Vu, cost.W_e, cost.Vx_e, x_chunk, u_chunk,
        yref[k0:k0 + chunk], yref_e)
    # the terminal gradient comes from the *global* trajectory end, not
    # this chunk's last state: x_traj is replicated, so every rank
    # computes the identical (P, p)
    e_N = cost.Vx_e @ x_traj[-1] - yref_e
    blocks["p"] = cost.Vx_e.T @ (cost.W_e @ e_N)
    qp_local = build_qp(A, B, x_next, x_chunk, u_chunk,
                        x0 if idx == 0 else x_chunk[0], spec.lbu, spec.ubu,
                        blocks)
    reduced, maps = condensing.condense(qp_local, block)

    # gather the reduced stage problems of every stage rank; the
    # terminal entries stay unstacked
    keys = ("A", "B", "c", "Qxx", "qx", "Ruu", "ru", "S", "lb", "ub")
    parts = mesh.all_gather_many([getattr(reduced, k) for k in keys],
                                 STAGE_AXIS)
    full = {k: g.reshape((-1,) + g.shape[2:]) for k, g in zip(keys, parts)}
    sol = ipm.solve(QPData(P=reduced.P, p=reduced.p, dx0=x0 - x_traj[0],
                           **full), config)

    # local expansion of this rank's reduced states/inputs
    m_local = chunk // block
    m0 = idx * m_local
    dx_loc, du_loc = condensing.expand(
        maps, sol.dx[m0:m0 + m_local + 1], sol.du[m0:m0 + m_local])
    # dx_loc has chunk+1 rows: each rank gives its first `chunk`, and the
    # global terminal row comes from the replicated reduced solution
    dx_all, du_all = mesh.all_gather_many([dx_loc[:chunk], du_loc],
                                          STAGE_AXIS)
    dx_full = torch.cat([dx_all.reshape(-1, nx), sol.dx[-1:]], dim=0)
    du_full = du_all.reshape(-1, nu)

    x_new = x_traj + dx_full
    u_new = u_traj + du_full
    res_nl = torch.maximum(qp_local.c.abs().amax(),
                           (x0 - x_traj[0]).abs().amax())
    res_nl = mesh.all_reduce(res_nl, STAGE_AXIS, "max")
    step_norm = torch.maximum(du_full.abs().amax(), dx_full.abs().amax())
    out = RTIOutput(u0=u_new[0], u1=u_new[1], x_plan=x_new, u_plan=u_new,
                    kkt_res=torch.maximum(res_nl, step_norm),
                    qp_mu=sol.stats["mu"])
    return RTIState(x_traj=x_new, u_traj=u_new), out
