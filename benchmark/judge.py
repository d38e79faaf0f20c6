"""The comparison that decides `correct`: a tick's outputs against the
plain reference's, lane by lane.

Where a cell's limits name a `settled_mu`, a lane is compared where
the reference settles it: where the answer the reference gives for the
lane's QP (its plain solve's, or the escalation re-solve's where the
configuration escalates it) ends with mu at or below that.  A lane that
the configured iterations leave unsettled has no answer that float32
reproduces: its last step lengths hang on slacks near a bound that
float32 holds to about 1e-6 kRPM, and two float32 codes land kRPM apart
(PERF.md).  Such a lane is only held to be finite, and the lanes left
out are printed beside the numbers compared (standard error).  Where
`settled_mu` is null, every lane is compared.
"""

from __future__ import annotations

import sys

import torch

from reference import rti as ref

# where the reference's plain-solve mu lies within this factor of the
# escalation tolerance, a float32 mu may fall on either side of it
BAND = 10.0


def settled(mu, limits: dict):
    """Per lane, whether the reference's final mu lets the lane be
    compared: at or below the cell's `settled_mu`, or always where that
    is null."""
    bound = limits["settled_mu"]
    if bound is None:
        return torch.ones_like(mu, dtype=torch.bool)
    return mu <= bound


def lane_max(a, b):
    """Per lane, the largest |a - b| over every other axis (batch first)."""
    d = (a.double() - b.double()).abs()
    return d.reshape(d.shape[0], -1).amax(dim=1)


def allowed(mu_plain, solver: ref.Solver):
    """Per lane, whether the plain answer and whether the escalated
    answer may stand: the configuration escalates lanes whose mu exceeds
    its tolerance, the worst `escalate_capacity` of them."""
    B = mu_plain.shape[0]
    if solver.escalate_iters <= 0 or solver.escalate_capacity <= 0:
        ones = torch.ones(B, dtype=torch.bool, device=mu_plain.device)
        return ones, ~ones
    tol = solver.escalate_mu_tol
    bad = mu_plain > tol
    near = (mu_plain > tol / BAND) & (mu_plain <= tol * BAND)
    if int(bad.sum()) > solver.escalate_capacity:
        # only the worst lanes escalate, and which of them hangs on mu's
        # last bits: any lane may keep its plain answer
        return torch.ones_like(bad), bad | near
    return ~bad | near, bad | near


class Tally:
    """The running worst gaps over every compared tick."""

    def __init__(self):
        self.u = 0.0
        self.x = 0.0
        self.cmd = 0.0
        self.left_out = 0
        self.lanes = 0
        self.nonfinite = 0

    def add(self, gaps: dict, settled, finite):
        """gaps: name -> (B,) per-lane gap; settled: (B,) bool."""
        for name, g in gaps.items():
            worst = float(torch.nan_to_num(torch.where(settled, g, 0.0),
                                           nan=torch.inf).max())
            setattr(self, name, max(getattr(self, name), worst))
        self.left_out += int((~settled).sum())
        self.lanes += int(settled.numel())
        self.nonfinite += int((~finite).sum())

    def numbers(self, limits: dict, names) -> dict:
        """name -> (number, limit) of every number compared."""
        print(f"lanes left out unsettled: {self.left_out} of {self.lanes}",
              file=sys.stderr)
        out = {f"{n}_gap": (getattr(self, n), limits[f"{n}_gap"])
               for n in names}
        out["nonfinite_lanes"] = (float(self.nonfinite),
                                  limits["nonfinite_lanes"])
        return out


def finite(*outs):
    """Per lane, whether every output is finite (batch first)."""
    ok = None
    for t in outs:
        f = torch.isfinite(t).reshape(t.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok
