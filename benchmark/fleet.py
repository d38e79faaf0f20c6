"""What the traffic kinds share: the fleet's set-points and references,
and the sample of ticks the comparison takes."""

from __future__ import annotations

import random

import torch


def setpoints(traffic: dict, B: int, dtype, device) -> torch.Tensor:
    """(B, 3) hover set-points: one point for all, or a square grid of
    `side` x `side` points `spacing_m` apart at `height_m`, centred."""
    grid = traffic.get("grid")
    if grid is None:
        return torch.tensor(traffic["setpoint"], dtype=dtype,
                            device=device).expand(B, 3)
    side, gap = grid["side"], grid["spacing_m"]
    if side * side != B:
        raise ValueError(f"a {side}x{side} grid for {B} vehicles")
    c = (torch.arange(side, dtype=dtype, device=device) - (side - 1) / 2) * gap
    xs, ys = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1),
                        torch.full((B,), grid["height_m"], dtype=dtype,
                                   device=device)], dim=-1)


def references(points: torch.Tensor, N: int, u_hover: float):
    """yref (B, N, 17) and yref_e (B, 13): hover at each point, identity
    attitude, hover input (generate_c_code.py:128-129)."""
    B = points.shape[0]
    y = torch.zeros((B, 17), dtype=points.dtype, device=points.device)
    y[:, 0:3] = points
    y[:, 3] = 1.0
    y[:, 13:] = u_hover
    return y[:, None].expand(B, N, 17).contiguous(), y[:, :13].contiguous()


class Reservoir:
    """A uniform sample of `k` records from a stream, drawn from the seed
    (holds references only)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def compared(first, reservoir: Reservoir, last) -> list:
    """(name, record, from_start) of every tick the comparison takes: the
    first tick of all (compared from the reference's own start), the
    sample of the window's ticks, and its last tick."""
    return ([("first", first, True)]
            + [(f"sample{i}", r, False) for i, r in enumerate(reservoir.items)]
            + [("last", last, False)])
