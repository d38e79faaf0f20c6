"""PyTorch/CUDA port of crazyflie_nmpc_tpu for NVIDIA Hopper (H100).

The JAX package `crazyflie_nmpc_tpu` stays the reference; this package
keeps its module layout so each module's counterpart is easy to find.
It imports `torch` only, never JAX nor anything of the JAX package.

Ported so far: the model (`models`), the OCP data and both RTI steps: the
batched `solver.rti_batched.rti_step_batched` with every option of its
`ops.ipm_fast.solve_batched`, and the single-instance `solver.rti.rti_step`
(with `sqp_solve` and AS-RTI) on `ops.{integrators, qp, riccati, ipm,
condensing}`; the closed loops (`runtime`: the single-vehicle loops up to
the paper's flown configuration on `rti_step`, the swarm and Monte-Carlo
loops on `rti_step_batched`) with the onboard cascade
(`models.firmware`), the estimator chain (`estimator`) and the trajectory
tools (`utils.trajectories`); the serving stack (`runtime.serving`,
`runtime.swarm`, `runtime.bag`, `runtime.telemetry`, the native UDP link
and vehicle endpoints in `native`, `bringup.swarm_serving`); the pod path
on `torch.distributed` (`parallel`: the rank mesh, the batch-sharded and
stage-sharded steps, `pod_rti_step`, `fleet_metrics`); the `utils`
planes (`profiling`, `checkpoint`, `config`, `debug`, `coherence`); the
launch layer (`bringup`'s compositions, `session` and `python -m
crazyflie_nmpc_tpu_torch.bringup`, the `tools` CLI) with the PID
controller (`pid`), the link demos (`demo`) and the associative-scan
Riccati (`ops.riccati_pscan`); and the speed-of-light study
(`roofline`).  Every module of the JAX package has its counterpart, and
every Pallas kernel is hand-written CUDA C++ for sm_90a under `csrc/`
(built at first use by `ops.cuda._build`).

Entry points run on the card unless the caller asks for the CPU: every
constructor takes `device=None`, which means `cuda`, and raises when no
GPU is present.  On CPU tensors the kernel wrappers run their plain
PyTorch versions (that is how the CPU tests hold the port against JAX).
"""

from crazyflie_nmpc_tpu_torch.device import resolve_device  # noqa: F401
from crazyflie_nmpc_tpu_torch.models.quadrotor import (  # noqa: F401
    NU,
    NX,
    NY,
    NYN,
    QuadrotorParams,
    dynamics,
    hover_control,
    hover_state,
)

__version__ = "0.1.0"
