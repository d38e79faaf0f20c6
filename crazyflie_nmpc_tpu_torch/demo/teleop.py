"""Joystick teleop — crazyflie_demo/src/quadrotor_teleop.cpp.

The reference maps gamepad axes to a `cmd_vel` twist at 100 Hz with
per-axis scale and optional inversion (quadrotor_teleop.cpp:70-81,
102-108), and the Python supervisors map buttons to emergency/land/takeoff
(controller.py:24-45).  Here the joystick is an `axes_source()` callable
returning (roll_axis, pitch_axis, yawrate_axis, thrust_axis) in [-1, 1]
(a stub: no joystick hardware is assumed), so the mapping
itself is testable.

The PyTorch port's own copy of the JAX package's `demo/teleop.py`: it is
framework-free, so the logic and the link call sequences are the same.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass


@dataclass
class TeleopAxisConfig:
    """Per-axis scales, matching the reference's rosparam defaults:
    roll/pitch ±30 deg, yawrate ±200 deg/s, thrust 0..60000 PWM."""

    roll_scale: float = 30.0
    pitch_scale: float = 30.0
    yawrate_scale: float = 200.0
    thrust_scale: float = 60000.0
    invert_roll: bool = False
    invert_pitch: bool = False


class Teleop:
    RATE_HZ = 100.0

    def __init__(self, link, vid: int, axes_source,
                 config: TeleopAxisConfig = TeleopAxisConfig(),
                 buttons_source=None, sleep=None):
        self.link = link
        self.vid = vid
        self.axes_source = axes_source
        self.buttons_source = buttons_source or (lambda: {})
        self.config = config
        self._sleep = sleep or _time.sleep
        self.emergency_latched = False

    def map_axes(self, axes):
        """(roll, pitch, yawrate, thrust) command from axis values."""
        c = self.config
        roll = axes[0] * c.roll_scale * (-1.0 if c.invert_roll else 1.0)
        pitch = axes[1] * c.pitch_scale * (-1.0 if c.invert_pitch else 1.0)
        yawrate = axes[2] * c.yawrate_scale
        # thrust axis in [-1,1] → [0, thrust_scale]
        thrust = max(0.0, min(1.0, (axes[3] + 1.0) / 2.0)) * c.thrust_scale
        return roll, pitch, yawrate, int(thrust)

    def step(self) -> bool:
        """One teleop tick; returns False once emergency latched."""
        buttons = self.buttons_source()
        if buttons.get("emergency"):
            self.link.emergency(self.vid)
            self.emergency_latched = True
            return False
        if buttons.get("land"):
            self.link.land(self.vid, height=0.04, duration=2.0)
            return True
        if buttons.get("takeoff"):
            self.link.takeoff(self.vid, height=0.5, duration=2.0)
            return True
        roll, pitch, yawrate, thrust = self.map_axes(self.axes_source())
        self.link.send_setpoint(self.vid, roll, pitch, yawrate, thrust)
        return True

    def run(self, ticks: int):
        for _ in range(ticks):
            if not self.step():
                break
            self._sleep(1.0 / self.RATE_HZ)
