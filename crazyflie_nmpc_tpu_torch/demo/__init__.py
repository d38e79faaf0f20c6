"""Demo / user-API layer — the crazyflie_demo package equivalents
(PyTorch counterpart of `demo/`).

The reference's L6 layer (SURVEY.md §2.4) is a set of ROS scripts that
drive the stack through topics and services.  Here each becomes a small,
clock-injectable component that drives the native link server (or any
object with the same send_* surface), so every demo is unit-testable
against the firmware simulator without wall-clock sleeps:

- hover.HoverDemo          — Hover.py: velocity-hover (`cmd_hover`) goTo
  state machine incl. the two-vehicle threaded variant
- position.position_demo   — Position.py: `cmd_position` takeoff/hold/land
- waypoints.WaypointSequencer — demo.py: goal advance within 0.3 m / 10°
- full_state_stream.stream_trajectory — execute_trajectory.py: 100 Hz
  differential-flatness full-state streaming (the flatness map in torch)
- mocap.FakeMocapBridge / MocapBridge — publish_external_position_*.py
- teleop.Teleop            — quadrotor_teleop.cpp axis mapping

All but the streamer are framework-free copies of the JAX package's.
"""

from crazyflie_nmpc_tpu_torch.demo.hover import HoverDemo  # noqa: F401
from crazyflie_nmpc_tpu_torch.demo.position import (  # noqa: F401
    position_demo,
)
from crazyflie_nmpc_tpu_torch.demo.waypoints import (  # noqa: F401
    WaypointSequencer,
)
from crazyflie_nmpc_tpu_torch.demo.full_state_stream import (  # noqa: F401
    stream_trajectory,
)
from crazyflie_nmpc_tpu_torch.demo.mocap import (  # noqa: F401
    FakeMocapBridge,
    MocapBridge,
)
from crazyflie_nmpc_tpu_torch.demo.teleop import (  # noqa: F401
    Teleop,
    TeleopAxisConfig,
)
