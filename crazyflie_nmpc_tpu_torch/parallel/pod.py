"""Pod-scale serving: the kernel RTI path sharded over a rank mesh
(counterpart of `parallel/pod.py`).

BASELINE.json config 5 ("100k+ scenarios sharded across N>=2 hosts"): the
batch axis is embarrassingly parallel, so each rank runs the batched RTI
step (`solver.rti_step_batched`, the hand-written kernels on its card) on
its local shard of the global batch; nothing crosses ranks during a solve,
and only the metric reductions the caller asks for (`fleet_metrics`)
communicate.  Multi-process runs start with `init_distributed`
(`torch.distributed`).  The JAX package's `shard_map` becomes SPMD: every
rank calls the step on its own rows (`Mesh.shard`).

The horizon axis composes on top via `sharded.stage_sharded_rti_step`
(collective-reduced partial condensing over STAGE_AXIS); the two axes are
the same mesh's dimensions (`parallel.mesh.make_mesh`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crazyflie_nmpc_tpu_torch.device import resolve_device
from crazyflie_nmpc_tpu_torch.ops import ipm
from crazyflie_nmpc_tpu_torch.parallel.mesh import BATCH_AXIS
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti_batched import rti_step_batched


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None):
    """Initialize `torch.distributed` if not already done; returns
    (world size, rank).

    coordinator: the rendezvous, "host:port" (TCP), or any
    `init_process_group` URL ("tcp://...", "file://..."); None reads the
    launcher's environment ("env://": MASTER_ADDR, RANK, ...).
    backend: None means "nccl" on the card and "gloo" for device="cpu"
    (`device.resolve_device`: raises without a GPU unless asked for the
    CPU).  With NCCL each rank takes the card `rank % device_count`.
    """
    if not dist.is_initialized():
        if backend is None:
            backend = ("nccl" if resolve_device(device).type == "cuda"
                       else "gloo")
        init = coordinator or "env://"
        if "://" not in init:
            init = f"tcp://{init}"
        kwargs = {}
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
        dist.init_process_group(backend, init_method=init, **kwargs)
        if backend == "nccl":
            torch.cuda.set_device(dist.get_rank()
                                  % torch.cuda.device_count())
    return dist.get_world_size(), dist.get_rank()


def pod_rti_step(spec: OCPSpec, mesh, config: ipm.IPMConfig = ipm.IPMConfig(),
                 condense: int | None = None, device=None,
                 layout: str = "batch_first", **tpu_options):
    """The pod-wide RTI step on the kernel path.

    Returns fn(states, x0s, yref, yref_e) -> (states', outs) on this rank's
    shard of the global batch (batch-first, or the kernels' batch-last
    with layout="batch_last"); yref/yref_e are shared (N, ny) / (nx,) or
    per-problem rows of the shard.  Each rank runs the kernels on its
    shard; no collective in the solve.  With escalation configured each
    solve keeps its one counted host sync.

    condense defaults to block-2 partial condensing at even N.  The JAX
    package's TPU blocking arguments (block_b, stages_per_step, interpret)
    have no counterpart on the card and raise TypeError.
    """
    if tpu_options:
        raise TypeError(
            f"pod_rti_step() got {sorted(tpu_options)}: the port's "
            "rti_step_batched takes no TPU blocking arguments (block_b, "
            "stages_per_step, interpret)")
    dev = resolve_device(device)
    if condense is None:
        condense = 2 if spec.N % 2 == 0 else 1
    mesh.index(BATCH_AXIS)            # this rank holds a shard

    def step(states, x0s, yref, yref_e):
        if x0s.device.type != dev.type:
            raise ValueError(f"pod_rti_step: the shard lies on {x0s.device}, "
                             f"the step runs on {dev}")
        return rti_step_batched(spec, states, x0s, yref, yref_e, config,
                                condense=condense, layout=layout)

    return step


def fleet_metrics(mesh):
    """Pod-wide telemetry reduction: worst KKT residual and mean QP gap
    across all shards (the 'solver-status surfaced per batch element'
    plane of SURVEY.md §5, reduced for dashboards).  Returns
    fn(kkt_res, qp_mu) -> (max, mean) over the batch axis, 0-dim tensors
    on every rank."""
    def metrics(kkt, mu):
        return (mesh.all_reduce(torch.amax(kkt), BATCH_AXIS, "max"),
                mesh.all_reduce(torch.mean(mu), BATCH_AXIS, "mean"))
    return metrics
