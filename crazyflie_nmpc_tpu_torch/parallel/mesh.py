"""Rank-mesh construction and the collectives of the batch/stage sharding
(counterpart of `parallel/mesh.py`).

The JAX package lays devices out as a `jax.sharding.Mesh`; here every
rank of a `torch.distributed` world is one device of a (batch, stage)
grid, row-major as `np.reshape` lays them, and the mesh holds one process
group per axis: the ranks that share this rank's other coordinate.  Every
rank runs the same program (SPMD) and calls the collectives below where
the JAX code calls `all_gather`, `pmax` and `pmean` inside `shard_map`.

Collectives run on the group's own backend: NCCL moves tensors on the
card.  Gloo has no collectives on CUDA tensors, so a CUDA tensor on a
gloo group goes through a pinned host buffer and back; each such round
trip is one counted host sync (`device.host_sync("collective")`).  The
caller chooses the backend (`parallel.pod.init_distributed`): nothing
picks one in its place and nothing falls back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crazyflie_nmpc_tpu_torch.device import from_host, host_sync

BATCH_AXIS = "batch"   # independent OCP instances (drones / scenarios)
STAGE_AXIS = "stage"   # horizon blocks (partial-condensing parallelism)


class Mesh:
    """A (batch, stage) grid of ranks, seen from one rank.

    `shape[axis]` is the grid's extent along `axis` (as `Mesh.shape` of
    JAX); `index(axis)` this rank's coordinate; `ranks` the grid of global
    ranks.  A rank of the world outside the grid has no coordinates and
    takes part in no collective of the mesh.
    """

    def __init__(self, ranks, rank: int, groups: dict):
        self.ranks = ranks                    # [[global rank]] (batch, stage)
        self.shape = {BATCH_AXIS: len(ranks), STAGE_AXIS: len(ranks[0])}
        self.rank = rank
        self._groups = groups                 # axis -> ProcessGroup or None
        self._coords = None
        for b, row in enumerate(ranks):
            if rank in row:
                self._coords = {BATCH_AXIS: b, STAGE_AXIS: row.index(rank)}

    def index(self, axis: str) -> int:
        if self._coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh")
        return self._coords[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks along `axis` through this rank, in order."""
        b, s = self.index(BATCH_AXIS), self.index(STAGE_AXIS)
        if axis == BATCH_AXIS:
            return [row[s] for row in self.ranks]
        return list(self.ranks[b])

    def shard(self, x: torch.Tensor, axis: str = BATCH_AXIS, dim: int = 0):
        """This rank's equal block of `x` along `dim`, split over `axis`
        (the process-local rows of a global array)."""
        d = self.shape[axis]
        if x.shape[dim] % d:
            raise ValueError(f"{x.shape[dim]} rows do not split over {d} "
                             f"ranks of axis {axis!r}")
        n = x.shape[dim] // d
        return x.narrow(dim, self.index(axis) * n, n)

    # ---- collectives -----------------------------------------------------

    def _run(self, axis, t, op):
        """op(group, t_on_the_backend) -> result, with gloo's host round
        trip for CUDA tensors.  Without `torch.distributed` (one process)
        the group is None and op communicates nothing."""
        self.index(axis)
        group = self._groups[axis]
        if (group is None or t.device.type != "cuda"
                or dist.get_backend(group) == "nccl"):
            return op(group, t)
        with host_sync("collective"):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
        return from_host(op(group, host), t.dtype, t.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(d, *t.shape): `t` of every rank along `axis`, in axis order
        (`jax.lax.all_gather(t, axis, axis=0)`)."""
        def op(group, x):
            x = x.contiguous()
            if group is None:
                return x[None]
            d = dist.get_world_size(group)
            if dist.get_backend(group) == "nccl":
                out = torch.empty((d,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device)
                dist.all_gather_into_tensor(out, x, group=group)
                return out
            parts = [torch.empty_like(x) for _ in range(d)]
            dist.all_gather(parts, x, group=group)
            return torch.stack(parts)
        out = self._run(axis, t, op)
        # a group numbers its ranks in ascending order; the axis may not
        ranks = self.axis_ranks(axis)
        if ranks != sorted(ranks):
            out = out[[sorted(ranks).index(r) for r in ranks]]
        return out

    def all_gather_many(self, tensors, axis: str) -> list:
        """`all_gather` of several tensors of one dtype in ONE collective:
        packed into a flat buffer, gathered, unpacked to (d, *shape)
        each."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        g = self.all_gather(flat, axis)
        out, k = [], 0
        for t in tensors:
            out.append(g[:, k:k + t.numel()].reshape((-1,) + t.shape))
            k += t.numel()
        return out

    def all_reduce(self, t: torch.Tensor, axis: str, op: str):
        """The elementwise reduction of `t` over the ranks along `axis`:
        "max" (`pmax`) or "mean" (`pmean`: the sum over the axis'
        size)."""
        reduce = {"max": dist.ReduceOp.MAX, "mean": dist.ReduceOp.SUM}[op]

        def run(group, x):
            x = x.clone()
            if group is not None:
                dist.all_reduce(x, op=reduce, group=group)
            return x
        out = self._run(axis, t, run)
        return out / self.shape[axis] if op == "mean" else out

    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0):
        """`t` of the rank at index `src` along `axis`, on every rank of
        the axis."""
        root = self.axis_ranks(axis)[src]

        def run(group, x):
            x = x.clone()
            if group is not None:
                dist.broadcast(x, src=root, group=group)
            return x
        return self._run(axis, t, run)


def make_mesh(batch: int = 1, stage: int = 1, devices=None) -> Mesh:
    """Build a (batch, stage) mesh over `batch*stage` ranks.

    batch is the embarrassingly-parallel axis (independent solves,
    BASELINE configs 3-5); stage shards the horizon's linearization and
    condensing (SURVEY.md section 2.6).  `devices` is the list of global
    ranks to lay out (default: every rank of the world, or the one
    process when `torch.distributed` is not initialized); the first
    `batch*stage` are used.  Every rank of the world must call this, in
    the same order as its other group constructions: each axis group is
    a `torch.distributed.new_group`.
    """
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    devices = list(devices) if devices is not None else list(range(world))
    n = batch * stage
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    flat = devices[:n]
    ranks = [flat[b * stage:(b + 1) * stage] for b in range(batch)]
    groups = {BATCH_AXIS: None, STAGE_AXIS: None}
    if initialized:
        # every rank creates every group (new_group is collective); each
        # keeps the ones through itself, one-rank axes too (their
        # collectives run on the backend all the same)
        for s in range(stage):
            g = dist.new_group([row[s] for row in ranks])
            if any(row[s] == rank for row in ranks):
                groups[BATCH_AXIS] = g
        for row in ranks:
            g = dist.new_group(row)
            if rank in row:
                groups[STAGE_AXIS] = g
    return Mesh(ranks, rank, groups)
