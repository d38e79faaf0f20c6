"""Batched closed-loop runtimes: swarm and Monte-Carlo configurations
(PyTorch counterpart of `runtime/batch.py`).

BASELINE.json configs 3-4: many independent closed loops advanced in
lockstep, 256-drone swarms and 1k-scenario Monte-Carlo with perturbed
initial states.  The per-tick controller is `rti_step_batched` on the
card's kernels (K1 `prep_condense2`, 8 x K2 `kkt_sweep_c2` and K3
`corrector_sweep_c2`, K4 `expand2` at the default IPMConfig(iters=8)).
The controller states stay in the kernels' batch-last layout across ticks
(one conversion at entry); the plant is one batched RK4
integration per tick.  With escalation off no tick waits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crazyflie_nmpc_tpu_torch.device import device_tensor
from crazyflie_nmpc_tpu_torch.models.quadrotor import NU, NX, dynamics
from crazyflie_nmpc_tpu_torch.ops import ipm
from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import init_rti
from crazyflie_nmpc_tpu_torch.solver.rti_batched import (rti_step_batched,
                                                         to_batch_last)


class SwarmResult(NamedTuple):
    x: torch.Tensor        # (T, B, nx) plant states
    u: torch.Tensor        # (T, B, nu) applied controls
    kkt_res: torch.Tensor  # (T, B)


def swarm_hover(spec: OCPSpec, x_inits: torch.Tensor,
                setpoints: torch.Tensor, steps: int,
                config: ipm.IPMConfig = ipm.IPMConfig(iters=8),
                plant_substeps: int = 1) -> SwarmResult:
    """Closed-loop regulation for B independent vehicles in lockstep, where
    x_inits are.

    Args:
      x_inits: (B, nx) initial states; setpoints: (B, 3) hover targets.
    """
    B = x_inits.shape[0]
    N = spec.N
    dtype, dev = x_inits.dtype, x_inits.device
    uss = spec.params.hover_speed()

    # per-vehicle regulation references (filled on the device: an
    # assignment of a Python number would copy it from the host)
    y = torch.zeros((B, NX + NU), dtype=dtype, device=dev)
    y[:, 0:3] = setpoints.to(dtype)
    y[:, 3].fill_(1.0)
    y[:, NX:].fill_(uss)
    yrefs = y[:, None].expand(B, N, NX + NU)
    yref_es = y[:, :NX]

    states = to_batch_last(init_rti(spec, x_inits, device=dev))
    xs, outs = x_inits, []
    for _ in range(steps):
        states, out = rti_step_batched(spec, states, xs, yrefs, yref_es,
                                       config, layout="batch_last")
        u = out.u0.T                                   # (B, nu)
        xs_next = integrate(dynamics, spec.params, xs, u, spec.dt,
                            plant_substeps)
        outs.append((xs, u, out.kkt_res))
        xs = xs_next
    return SwarmResult(*(torch.stack(col) for col in zip(*outs)))


def monte_carlo_hover(spec: OCPSpec, generator: torch.Generator,
                      batch: int, steps: int, pos_scale: float = 0.2,
                      setpoint=(0.0, 0.0, 0.5), **kw) -> SwarmResult:
    """Monte-Carlo over initial positions perturbed around the set-point
    (config 3), float32 on the spec's device: offsets pos_scale *
    N(0, 1) drawn from `generator` (on its own device, then moved)."""
    from crazyflie_nmpc_tpu_torch.models.quadrotor import hover_state

    dtype, dev = torch.float32, spec.lbu.device
    base = hover_state(spec.params, pos=setpoint, dtype=dtype, device=dev)
    offs = pos_scale * torch.randn((batch, 3), generator=generator,
                                   dtype=dtype, device=generator.device)
    x_inits = base.expand(batch, NX).clone()
    x_inits[:, 0:3] += offs.to(dev)
    setpoints = device_tensor(setpoint, dtype, dev).expand(batch, 3)
    return swarm_hover(spec, x_inits, setpoints, steps, **kw)
