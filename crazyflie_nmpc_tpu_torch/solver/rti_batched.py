"""Throughput-oriented batched RTI step (counterpart of
`solver/rti_batched.py`).

Many independent NMPC instances advanced one SQP-RTI iteration per call.
At even N (block-2 condensing, the default) the preparation is ONE
`prep_condense2` launch (ERK4 + exact VDE + QP assembly + condensing), the
feedback is `ops.ipm_fast`'s Mehrotra solve on the condensed sweeps (or,
with `fused_iter=True`, one `iter_sweep_c2` launch per iteration; with
`windowed=True`, the split sweep launches), the expansion recovers the
eliminated states.  With `fused_prep_condense=False` the preparation is a
`prep_sweep` launch and the condensing a `condense2` launch.  At odd N (or
condense=1) `prep_sweep` feeds the uncondensed sweeps `kkt_sweep` /
`corrector_sweep`.  `prep_vde_order=2` selects the order-2 sensitivities in
either preparation; the solver's options (Gondzio correctors, bf16
streams) are `IPMConfig`'s.  With `fused_prep=False` or `sim_steps>1` the
preparation is the XLA-style one (`prepare_qp_xla`: `torch.func.jacfwd`
through the integrator, plain PyTorch) and the same solver follows (at
even N `condense2`, the condensed sweeps and the stride-2 `expand2`).  On
CUDA tensors each kernel is hand-written; on CPU tensors their plain
PyTorch versions run.

Layouts: batch-first by default (x_traj (B, N+1, nx)); a serving loop that
chains steps on the card passes `layout="batch_last"` and carries
batch-last states ((N+1, nx, B)), the kernels' own layout.
"""

from __future__ import annotations

import torch

from crazyflie_nmpc_tpu_torch.models.quadrotor import dynamics
from crazyflie_nmpc_tpu_torch.ops import ipm_fast
from crazyflie_nmpc_tpu_torch.ops.cuda.prep_kernel import (prep_condense2,
                                                           prep_sweep)
from crazyflie_nmpc_tpu_torch.ops.integrators import linearize_trajectory
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import RTIOutput, RTIState


def to_batch_last(states: RTIState) -> RTIState:
    """Batch-first RTIState -> the kernels' (batch-last, contiguous)."""
    return RTIState(x_traj=states.x_traj.movedim(0, -1).contiguous(),
                    u_traj=states.u_traj.movedim(0, -1).contiguous())


def to_batch_first(states: RTIState) -> RTIState:
    return RTIState(x_traj=states.x_traj.movedim(-1, 0).contiguous(),
                    u_traj=states.u_traj.movedim(-1, 0).contiguous())


def prep_tiles(spec: OCPSpec, B: int, dtype, device):
    """The (n, B) tiles `prep_condense2` takes besides x, u and yref:
    q_diag (13,B), r_diag, lbu, ubu (4,B) and params (9,B) with dt last
    (the diagonal LLS cost: selector Vx/Vu, diagonal W,
    generate_c_code.py:86-107).  Materialised contiguous for the kernel.
    The parameter rows are filled on the device from Python floats: a
    host-to-device copy of a fresh tensor would block the host until the
    card's queue drains."""
    cost = spec.cost
    nx = cost.W_e.shape[0]
    nu = spec.lbu.shape[0]

    def tile(v):
        v = v.to(device=device, dtype=dtype).reshape(-1, 1)
        return v.expand(v.shape[0], B).contiguous()

    par = spec.params
    ptile = torch.empty((9, B), dtype=dtype, device=device)
    for row, v in enumerate((par.g0, par.mq, par.Ixx, par.Iyy, par.Izz,
                             par.Cd, par.Ct, par.l)):
        ptile[row].fill_(v)
    ptile[8].copy_(spec.dt.to(device=device, dtype=dtype).expand(B))
    W = torch.diagonal(cost.W)
    return (tile(W[:nx]), tile(W[nx:]), tile(spec.lbu.expand(nu)),
            tile(spec.ubu.expand(nu)), ptile)


def prepare_qp(spec: OCPSpec, states: RTIState, x0s, yref, yref_e,
               batch_last: bool, fused_condense: bool = True,
               vde_order: int = 4):
    """Preparation phase: one launch from the iterate to the QP dict
    `ops.ipm_fast.solve_batched` takes, `prep_condense2`'s precondensed
    one (fused_condense, even N) or `prep_sweep`'s stage-wise one, with
    the sensitivities of `vde_order` (4: exact ERK4 VDE, 2: midpoint).

    Returns (x_bl, u_bl, qp) with the iterate in the kernels' layout.
    """
    B = x0s.shape[0]
    bl = lambda z: z.movedim(0, -1)  # noqa: E731  batch-first -> last
    x_bl = (states.x_traj if batch_last else bl(states.x_traj)).contiguous()
    u_bl = (states.u_traj if batch_last else bl(states.u_traj)).contiguous()
    N, nu = u_bl.shape[0], u_bl.shape[1]
    nx = x_bl.shape[1]
    dtype, dev = x_bl.dtype, x_bl.device

    if yref.ndim == 2:  # shared across the batch
        yref_bl = yref[:, :, None].expand(N, nx + nu, B)
        yref_e_bl = yref_e[:, None].expand(nx, B)
    else:
        yref_bl = bl(yref)
        yref_e_bl = bl(yref_e)
    q_t, r_t, lbu_t, ubu_t, p_t = prep_tiles(spec, B, dtype, dev)
    pT_diag = torch.diagonal(spec.cost.W_e).to(dtype)

    prep_args = (x_bl, u_bl, yref_bl.to(dtype).contiguous(), q_t, r_t, lbu_t,
                 ubu_t, p_t)
    qp = dict(ruu=r_t[None].expand(N, nu, B).contiguous(),
              pT=pT_diag[:, None].expand(nx, B).contiguous(),
              p=(pT_diag[:, None] * (x_bl[-1] - yref_e_bl)).contiguous(),
              dx0=(bl(x0s) - x_bl[0]).contiguous())
    if fused_condense:
        cnd, Ae, Be, c_k, lb_k, ub_k = prep_condense2(*prep_args, vde_order)
        qp.update(c=c_k, lb=lb_k, ub=ub_k, c2Ae=Ae, c2Be=Be,
                  **{"c2" + k: v for k, v in cnd.items()})
    else:
        A_k, B_k, c_k, qx_k, ru_k, lb_k, ub_k = prep_sweep(*prep_args,
                                                           vde_order)
        qp.update(A=A_k, B=B_k, c=c_k, qx=qx_k, ru=ru_k, lb=lb_k, ub=ub_k,
                  qxx=q_t[None].expand(N, nx, B).contiguous())
    return x_bl, u_bl, qp


def prepare_qp_xla(spec: OCPSpec, states: RTIState, x0s, yref, yref_e,
                   batch_last: bool):
    """The XLA-style preparation (the JAX package's `fused_prep=False` or
    `sim_steps>1` branch): `linearize_trajectory` (`torch.func.jacfwd`
    through `spec.sim_steps` RK4 sub-steps of the quadrotor dynamics) on
    the batch-first iterate, then the diagonal-cost QP assembly, in plain
    PyTorch.  Returns (x_bl, u_bl, qp) as `prepare_qp` does, with the
    stage-wise QP dict (A, B, c, qxx, qx, ruu, ru, pT, p, lb, ub, dx0)."""
    bl = lambda z: z.movedim(0, -1).contiguous()  # noqa: E731
    bf = lambda z: z.movedim(-1, 0)  # noqa: E731
    x_bl = (states.x_traj if batch_last else bl(states.x_traj)).contiguous()
    u_bl = (states.u_traj if batch_last else bl(states.u_traj)).contiguous()
    N, nu, B = u_bl.shape
    nx = x_bl.shape[1]
    dtype = x_bl.dtype
    x_bf, u_bf = bf(x_bl), bf(u_bl)

    W = torch.diagonal(spec.cost.W).to(dtype)
    q_diag, r_diag = W[:nx], W[nx:]
    pT_diag = torch.diagonal(spec.cost.W_e).to(dtype)
    if yref.ndim == 2:  # shared across the batch
        yref_bf = yref.to(dtype).expand(B, N, nx + nu)
        yref_e_bf = yref_e.to(dtype).expand(B, nx)
    else:
        yref_bf, yref_e_bf = yref.to(dtype), yref_e.to(dtype)

    x_next, A, Bm = linearize_trajectory(dynamics, spec.params, x_bf, u_bf,
                                         spec.dt, spec.sim_steps)
    qp = dict(
        A=bl(A), B=bl(Bm), c=bl(x_next - x_bf[:, 1:]),
        qxx=q_diag[None, :, None].expand(N, nx, B).contiguous(),
        qx=bl(q_diag * (x_bf[:, :-1] - yref_bf[..., :nx])),
        ruu=r_diag[None, :, None].expand(N, nu, B).contiguous(),
        ru=bl(r_diag * (u_bf - yref_bf[..., nx:])),
        pT=pT_diag[:, None].expand(nx, B).contiguous(),
        p=bl(pT_diag * (x_bf[:, -1] - yref_e_bf)),
        lb=bl(spec.lbu.to(dtype) - u_bf), ub=bl(spec.ubu.to(dtype) - u_bf),
        dx0=bl(x0s.to(dtype) - x_bf[:, 0]))
    return x_bl, u_bl, qp


def rti_step_batched(spec: OCPSpec, states: RTIState, x0s: torch.Tensor,
                     yref: torch.Tensor, yref_e: torch.Tensor,
                     config: IPMConfig = IPMConfig(),
                     fused_prep: bool = True,
                     fused_prep_condense: bool | None = None,
                     prep_batch_rows: int | None = None,
                     condense: int | None = None,
                     layout: str = "batch_first",
                     windowed: bool | None = None,
                     fused_iter: bool = False,
                     prep_vde_order: int = 4,
                     graphs: ipm_fast.LoopGraphs | None = None):
    """One RTI iteration for a batch of problems.

    Args:
      states: RTIState with leading batch axis (x_traj (B,N+1,nx),
        u_traj (B,N,nu)), or trailing with layout="batch_last"
        (x_traj (N+1,nx,B), u_traj (N,nu,B)).
      x0s: (B, nx).  yref: (N, ny) shared or (B, N, ny) per-problem;
        yref_e (nx,) or (B, nx).
      fused_prep_condense: None selects the fused `prep_condense2` launch
        when condense=2 and prep_batch_rows is None or 1; False the
        `prep_sweep` + `condense2` launches (True with condense=1 raises
        ValueError, as in the JAX package).
      prep_batch_rows: the JAX package's batch tiling of its preparation
        kernel; it has no counterpart on the card (the same `prep_sweep`
        kernel runs) and only selects the unfused preparation, as there.
      condense: None selects block-2 condensing at even N and the
        uncondensed sweeps at odd N; 1 or 2 forces one form.
      windowed, fused_iter: the sweep forms of `ops.ipm_fast.solve_batched`
        (split launches; one launch per Mehrotra iteration), condense=2
        only.
      prep_vde_order: 4 (default) the exact ERK4 matrix VDE sensitivities;
        2 the midpoint order-2 ones on the exact ERK4 state propagation
        (an inexact-Jacobian Gauss-Newton step, as in the JAX package).
      fused_prep: False (or spec.sim_steps > 1) selects the XLA-style
        preparation, `prepare_qp_xla`; fused_prep_condense,
        prep_batch_rows and prep_vde_order then have no effect, as in the
        JAX package.
      graphs: an `ops.ipm_fast.LoopGraphs` to replay the IPM iteration's
        barrier algebra from CUDA graphs (a serving loop's, kept across
        its ticks); None issues it operation by operation.
    Returns (RTIState', RTIOutput) in the input's layout (batch_last:
    u0/u1 are (nu,B), plans are stage-major batch-last).
    Raises ValueError for a custom model ODE (spec.f): such specs use
    `solver.rti.rti_step`, as in the JAX package.
    """
    if condense is None:
        condense = 2 if spec.N % 2 == 0 else 1
    if spec.f is not None:
        raise ValueError(
            "rti_step_batched is specialized to the Crazyflie quadrotor "
            "(fused prep kernel with hand-derived sparse Jacobians); "
            "custom-model specs (spec.f set) use solver.rti.rti_step")
    kernel_prep = fused_prep and spec.sim_steps == 1
    if fused_prep_condense is None:
        fused_prep_condense = (condense == 2
                               and prep_batch_rows in (None, 1))
    if kernel_prep and fused_prep_condense and condense != 2:
        raise ValueError("fused_prep_condense requires condense=2")
    ipm_fast.check_supported(config, condense, windowed, fused_iter)
    if layout not in ("batch_first", "batch_last"):
        raise ValueError(f"layout {layout!r}")

    batch_last = layout == "batch_last"
    if kernel_prep:
        x_bl, u_bl, qp = prepare_qp(spec, states, x0s, yref, yref_e,
                                    batch_last, fused_prep_condense,
                                    prep_vde_order)
    else:
        x_bl, u_bl, qp = prepare_qp_xla(spec, states, x0s, yref, yref_e,
                                        batch_last)

    # feedback: batch-last IPM on the sweeps of the problem's form
    sol = ipm_fast.solve_checked(qp, config, condense, windowed, fused_iter,
                                 graphs=graphs)
    return rti_update(qp, sol, x_bl, u_bl, batch_last)


def rti_update(qp: dict, sol, x_bl, u_bl, batch_last: bool):
    """The step's update from the QP and its solution: the new iterate
    and the RTIOutput (its residuals and plans), in the layout
    `batch_last` selects, as `rti_step_batched` returns them."""
    x_traj_bl = x_bl + sol.dx
    u_traj_bl = u_bl + sol.du

    res_nl = torch.maximum(torch.amax(qp["c"].abs(), dim=(0, 1)),
                           torch.amax(qp["dx0"].abs(), dim=0))
    step_norm = torch.maximum(torch.amax(sol.du.abs(), dim=(0, 1)),
                              torch.amax(sol.dx.abs(), dim=(0, 1)))
    kkt_res = torch.maximum(res_nl, step_norm)

    if batch_last:
        out = RTIOutput(u0=u_traj_bl[0], u1=u_traj_bl[1], x_plan=x_traj_bl,
                        u_plan=u_traj_bl, kkt_res=kkt_res,
                        qp_mu=sol.stats["mu"])
        return RTIState(x_traj=x_traj_bl, u_traj=u_traj_bl), out

    x_traj = x_traj_bl.movedim(-1, 0)
    u_traj = u_traj_bl.movedim(-1, 0)
    out = RTIOutput(u0=u_traj[:, 0], u1=u_traj[:, 1], x_plan=x_traj,
                    u_plan=u_traj, kkt_res=kkt_res, qp_mu=sol.stats["mu"])
    return RTIState(x_traj=x_traj, u_traj=u_traj), out
