"""The system under test as a configuration file states it: the port's
OCP and IPM settings built from the file's numbers, and the reference's
twins of the same numbers; and which traced kernels are the port's."""

from __future__ import annotations

import torch

from reference import rti as ref


def dtype_of(config: dict) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[
        config["dtype"]]


def port_spec(config: dict, device):
    """The port's `OCPSpec` of the configuration (its OCP section)."""
    from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams
    from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec, diagonal_lls_cost

    ocp, dt = config["ocp"], dtype_of(config)
    nu = len(ocp["r_diag"])
    return OCPSpec(
        params=QuadrotorParams(**config["params"]),
        cost=diagonal_lls_cost(ocp["q_diag"], ocp["r_diag"],
                               ocp["terminal_factor"], dtype=dt,
                               device=device),
        lbu=torch.full((nu,), ocp["u_min_krpm"], dtype=dt, device=device),
        ubu=torch.full((nu,), ocp["u_max_krpm"], dtype=dt, device=device),
        tf=torch.tensor(ocp["tf"], dtype=dt, device=device),
        N=ocp["N"])


def port_ipm(config: dict):
    """The port's `IPMConfig` of the configuration (its solver section)."""
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig

    s = config["solver"]
    return IPMConfig(iters=s["iters"], tau=s["tau"],
                     s_min_init=s["s_min_init"], mu0_init=s["mu0_init"],
                     escalate_iters=s["escalate_iters"],
                     escalate_mu_tol=s["escalate_mu_tol"],
                     escalate_capacity=s["escalate_capacity"])


def reference_problem(config: dict) -> ref.Problem:
    ocp = config["ocp"]
    return ref.Problem(N=ocp["N"], dt=ocp["tf"] / ocp["N"],
                       q=tuple(ocp["q_diag"]), r=tuple(ocp["r_diag"]),
                       terminal_factor=ocp["terminal_factor"],
                       u_min=ocp["u_min_krpm"], u_max=ocp["u_max_krpm"])


def reference_solver(config: dict) -> ref.Solver:
    s = config["solver"]
    return ref.Solver(iters=s["iters"], tau=s["tau"],
                      s_min_init=s["s_min_init"], mu0_init=s["mu0_init"],
                      escalate_iters=s["escalate_iters"],
                      escalate_mu_tol=s["escalate_mu_tol"],
                      escalate_capacity=s["escalate_capacity"],
                      stated_dtype=dtype_of(config))


def check_params(config: dict) -> None:
    """The reference restates the quadrotor's constants: a configuration
    with others is one the reference does not model."""
    mine = dict(g0=ref.G0, mq=ref.MQ, Ixx=ref.IXX, Iyy=ref.IYY, Izz=ref.IZZ,
                Cd=ref.CD, Ct=ref.CT, l=ref.ARM_L)
    if config["params"] != mine:
        raise ValueError("the configuration's quadrotor constants differ "
                         "from the reference's")


def port_kernel_events(trace) -> list:
    """The traced kernel events of the port's own CUDA kernels (the
    program's launch-counted kernels, `ops.cuda.KERNELS`)."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import KERNELS
    return [e for stem in KERNELS for e in trace.kernels_named(stem)]
