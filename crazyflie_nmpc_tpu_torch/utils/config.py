"""Typed runtime configuration: one coherent config plane (counterpart of
`utils/config.py`).

The reference splits configuration across four mechanisms (SURVEY.md §5):
compile-time #defines (WEIGHT_MATRICES/SET_WEIGHTS/FIXED_U0/CONTROLLER/
PUB_OPENLOOP_TRAJ, acados_mpc.cpp:109-113), rosparams at node start,
a dynamic_reconfigure GUI panel (crazyflie_params.cfg), and launch-file
composition.  Known reference config bugs NOT replicated here (SURVEY.md
§5): weight-panel edits silently dropped (SET_WEIGHTS=0), the shadowed
WN_factor member, and the never-running estimator init loop.

Here everything is one typed, serializable dataclass tree, with the JAX
package's fields, defaults and JSON: a file either package writes loads
in the other.  Fields that change tensor values (weights, set-point,
delay) change no code path; the structural ones (N, iteration counts)
size the problem.
"""

from __future__ import annotations

import dataclasses
import json

from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.solver.ocp import (
    Q_DIAG_REF,
    R_DIAG_REF,
    WN_FACTOR_REF,
)


@dataclasses.dataclass
class ControllerConfig:
    """NMPC node configuration (the crazyflie_params.cfg knobs +
    the #define flags, as data)."""

    # reference-policy selection (enable_traj_tracking in the cfg panel)
    tracking: bool = False
    ref_traj: str | None = None          # 17-col trajectory file path
    # regulation set-point (xq_des/yq_des/zq_des, crazyflie_params.cfg:12-14)
    setpoint: tuple = (0.0, 0.0, 0.5)
    # live weight diagonals (crazyflie_params.cfg:17-36 — actually applied)
    q_diag: tuple = tuple(Q_DIAG_REF)
    r_diag: tuple = tuple(R_DIAG_REF)
    wn_factor: float = WN_FACTOR_REF
    # FIXED_U0 semantics (acados_mpc.cpp:111,605-608): publish u1 and pin
    # stage-0 control
    fixed_u0: bool = False
    # publish the full open-loop plan each tick (PUB_OPENLOOP_TRAJ)
    pub_openloop: bool = False
    # --- structural
    horizon: int = 50
    tf: float = 0.75
    ipm_iters: int = 8

    def ipm(self) -> IPMConfig:
        return IPMConfig(iters=self.ipm_iters)


@dataclasses.dataclass
class EstimatorConfig:
    """Estimator node configuration (crazyflie_estimator.cfg:8 + launch)."""

    delay: float = 0.015        # [s], reconfigurable 0..0.30
    rate_hz: float = 66.6
    predictor_substeps: int = 1


@dataclasses.dataclass
class AppConfig:
    """Top-level config (the launch-file composition plane)."""

    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)
    estimator: EstimatorConfig = dataclasses.field(
        default_factory=EstimatorConfig)

    # ---- (de)serialization — replaces launch/rosparam files
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "AppConfig":
        raw = json.loads(text)
        return cls(
            controller=ControllerConfig(**raw.get("controller", {})),
            estimator=EstimatorConfig(**raw.get("estimator", {})),
        )

    @classmethod
    def load(cls, path: str) -> "AppConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
