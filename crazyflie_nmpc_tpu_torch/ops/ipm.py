"""Interior-point solver knobs (counterpart of `ops/ipm.py`).

Only `IPMConfig` and `certified_config` are ported: the batched RTI step
runs the solver in `ops.ipm_fast`.  Field names and defaults are the JAX
package's, so a config means the same thing on both sides; see that
module for the math behind each knob.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Mehrotra predictor-corrector settings."""

    iters: int = 12
    tau: float = 0.995
    reg: float = 0.0
    s_min_init: float = 1e-2
    # duals start at lam = mu0_init / s (1.0 is the classic cold start)
    mu0_init: float = 1.0
    # Gondzio centrality correctors per iteration: each one more corrector
    # sweep on the same factorization, kept per lane where it lengthens
    # the step
    gondzio_correctors: int = 0
    # per-lane escalation: lanes whose final mu exceeds escalate_mu_tol are
    # re-solved from scratch with escalate_iters iterations, at most
    # escalate_capacity of them per call (0 disables)
    escalate_iters: int = 0
    escalate_mu_tol: float = 1e-9
    escalate_capacity: int = 0
    # bf16 compressed streams of the condensed sweeps (condense=2, fused
    # sweeps only): K/L/Pc from the factorization to the correctors
    # (compress_gains), the deviation-coded Abar - I, Bbar and the
    # dynamics residual (compress_ab); arithmetic stays in the working dtype
    compress_gains: bool = False
    compress_ab: bool = False


def certified_config(capacity: int = 0) -> IPMConfig:
    """The serving default: 8 Mehrotra iterations + per-lane escalation to
    32, certified against the exact active-set oracle in the JAX package
    (tools/bangbang_cert.py).  `capacity` is the escalation sub-batch size.
    """
    return IPMConfig(iters=8, escalate_iters=32, escalate_capacity=capacity)
