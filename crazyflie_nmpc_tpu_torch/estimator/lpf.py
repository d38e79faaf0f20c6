"""Digital low-pass-filtered velocity differentiation (PyTorch counterpart
of `estimator/lpf.py`).

Parity with the reference estimator's 5-sample buffers + second-order IIR
differentiator (acados_estimator.cpp:356-412):

    v_k = 0.3306 v_{k-1} - 0.02732 v_{k-2} + 35.7 (p_k - p_{k-1})

designed for Ts = 15 ms; during the first second of data it falls back to
the raw finite difference (p_k - p_{k-1}) / Ts (:366).  The reference only
ever reads the last two taps of each 5-sample window, so the state is the
minimal (p_prev, v_prev, v_prev2, elapsed).

The reference filter's DC gain is 35.7*0.015/(1-0.3306+0.02732) = 0.7686;
`lpf_step(..., unity_gain=True)` rescales the numerator to (1-a1-a2)/dt
for an unbiased differentiator with the same poles; the default replicates
the reference exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# IIR coefficients from acados_estimator.cpp:364 (designed at Ts = 15 ms).
LPF_A1 = 0.3306
LPF_A2 = -0.02732
LPF_B = 35.7
WARMUP_SECONDS = 1.0


@dataclasses.dataclass(frozen=True)
class VelocityLPFState:
    """Carried filter state; position/velocity entries are (..., 3)."""

    p_prev: Any    # previous position sample
    v_prev: Any    # previous filtered velocity
    v_prev2: Any   # filtered velocity two ticks ago
    elapsed: Any   # seconds of data seen so far (0-dim tensor)


def init_lpf(p0: torch.Tensor) -> VelocityLPFState:
    z = torch.zeros_like(p0)
    return VelocityLPFState(p_prev=p0, v_prev=z, v_prev2=z,
                            elapsed=torch.zeros((), dtype=p0.dtype,
                                                device=p0.device))


def lpf_step(state: VelocityLPFState, p: torch.Tensor, dt,
             unity_gain: bool = False):
    """One filter tick: new position sample -> world-frame velocity
    estimate, over the trailing axis (x, y, z at once).  The branch is
    selected on the device (no host read of `elapsed`)."""
    b = (1.0 - LPF_A1 - LPF_A2) / dt if unity_gain else LPF_B
    diff = p - state.p_prev
    v_iir = LPF_A1 * state.v_prev + LPF_A2 * state.v_prev2 + b * diff
    v_fd = diff / dt
    v = torch.where(state.elapsed > WARMUP_SECONDS, v_iir, v_fd)
    new_state = VelocityLPFState(p_prev=p, v_prev=v, v_prev2=state.v_prev,
                                 elapsed=state.elapsed + dt)
    return new_state, v
