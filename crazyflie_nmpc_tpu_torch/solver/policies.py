"""Reference-generation policies: Regulation / Tracking / Position_Hold
(PyTorch counterpart of `solver/policies.py`).

The reference's policy switch and trajectory playhead
(acados_mpc.cpp:140-144, 427-516) as an explicit `PolicyState` and a pure
per-tick `make_yref`:
  * Regulation: constant setpoint (xq,yq,zq, identity attitude, hover u).
  * Tracking: window [playhead, playhead+N] of the precomputed 17-column
    trajectory; the playhead advances one row per tick; when fewer than N
    rows remain it latches to Position_Hold.
  * Position_Hold: last trajectory row's position, identity attitude,
    hover input (acados_mpc.cpp:490-514).
The state constructors and `regulation_table` make tensors on the card
unless given a device; `make_yref` runs where the table is, and selects
its branch on the card (no host read of the mode).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from crazyflie_nmpc_tpu_torch.device import device_tensor, resolve_device
from crazyflie_nmpc_tpu_torch.models.quadrotor import NX
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec

REGULATION = 0
TRACKING = 1
POSITION_HOLD = 2


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Carried policy state (mode latch + trajectory playhead + setpoint)."""

    mode: Any       # int32 0-dim: REGULATION / TRACKING / POSITION_HOLD
    playhead: Any   # int32 0-dim: row index into the trajectory table
    setpoint: Any   # (3,) regulation position target (reference layout),
    #                 or a full (ny,) reference row for custom-model specs;
    #                 float64 from the constructors, cast to the table's
    #                 dtype by make_yref


def _state(mode, setpoint, device):
    """Filled on the device (`device_tensor`): a closed loop that starts
    under torch.cuda.set_sync_debug_mode("error") makes its policy state
    without waiting for the card."""
    dev = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return PolicyState(mode=torch.full((), mode, **i32),
                       playhead=torch.zeros((), **i32),
                       setpoint=device_tensor(setpoint, torch.float64, dev))


def regulation_state(setpoint=(0.0, 0.0, 0.5), device=None) -> PolicyState:
    return _state(REGULATION, setpoint, device)


def tracking_state(setpoint=(0.0, 0.0, 0.5), device=None) -> PolicyState:
    return _state(TRACKING, setpoint, device)


def regulation_table(spec: OCPSpec, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The (1, ny) dummy trajectory table `make_yref` takes for pure
    regulation."""
    ny = spec.cost.W.shape[0]
    return torch.zeros((1, ny), dtype=dtype, device=resolve_device(device))


def _quad_row(pos, uss, dtype, device):
    """Reference regulation row: position, identity attitude, zero
    velocities/rates, hover input (acados_mpc.cpp:432-456)."""
    one = torch.ones((1,), dtype=dtype, device=device)
    return torch.cat([pos.to(dtype), one,
                      torch.zeros((NX - 4,), dtype=dtype, device=device),
                      uss.to(dtype)])


def make_yref(spec: OCPSpec, state: PolicyState, traj_table: torch.Tensor):
    """The (N+1, ny) reference window and the advanced PolicyState.

    Args:
      traj_table: (T, ny) precomputed trajectory (for the reference layout
        rows = [x(13); u(4)] on the 15 ms grid, the traj/*.txt format); for
        pure regulation a (1, ny) dummy table (`regulation_table`).

    Built-in quadrotor specs (`spec.f is None`) use the reference's row
    construction from a (3,) setpoint; custom-model specs must pass a full
    (ny,) setpoint, used verbatim.

    Returns (yref (N, ny), yref_e (nx,), new_state).
    """
    n_steps = traj_table.shape[0]
    ny = spec.cost.W.shape[0]
    nx = spec.cost.Vx_e.shape[1]
    dtype, dev = traj_table.dtype, traj_table.device
    uss = spec.steady_input(dtype).to(dev)
    quad_layout = spec.f is None

    # tracking window: rows playhead..playhead+N, clamped
    idx = torch.clamp(state.playhead.to(dev)
                      + torch.arange(spec.N + 1, device=dev), 0, n_steps - 1)
    window = traj_table[idx]

    sp = state.setpoint.to(device=dev, dtype=dtype)
    if sp.shape[-1] == ny:
        reg_row = sp
    elif quad_layout:
        reg_row = _quad_row(sp, uss, dtype, dev)
    else:
        raise ValueError(
            f"PolicyState.setpoint must be a full (ny={ny},) reference row "
            f"for non-reference cost layouts (got shape {tuple(sp.shape)})")
    reg = reg_row.expand(spec.N + 1, ny)
    if quad_layout:
        hold_row = _quad_row(traj_table[n_steps - 1, 0:3], uss, dtype, dev)
    else:
        hold_row = torch.cat([traj_table[n_steps - 1, :nx], uss])
    hold = hold_row.expand(spec.N + 1, ny)

    mode = state.mode.to(dev)
    yref_full = torch.where(mode == REGULATION, reg,
                            torch.where(mode == TRACKING, window, hold))

    # playhead advance + latch to Position_Hold once fewer than N rows
    # remain (acados_mpc.cpp:460-488)
    is_tracking = mode == TRACKING
    exhausted = state.playhead.to(dev) >= n_steps - spec.N
    latch = is_tracking & exhausted
    new_mode = torch.where(latch, POSITION_HOLD, mode).to(torch.int32)
    yref_full = torch.where(latch, hold, yref_full)
    new_playhead = torch.where(is_tracking & ~exhausted,
                               state.playhead.to(dev) + 1,
                               state.playhead.to(dev)).to(torch.int32)
    new_state = PolicyState(mode=new_mode, playhead=new_playhead,
                            setpoint=state.setpoint)
    return yref_full[:-1], yref_full[-1, :nx], new_state
