"""Waypoint sequencer — crazyflie_demo/scripts/demo.py.

The reference publishes the current goal pose continuously and advances to
the next waypoint once the vehicle is within 0.3 m on every axis and 10°
in yaw, after a per-waypoint dwell (demo.py:27-52).  Here the "goal topic"
is a callback (e.g. feeding the PID controller's goal or the NMPC
set-point) and the pose comes from a pose source callable.

The PyTorch port's own copy of the JAX package's `demo/waypoints.py`: it is
framework-free, so the logic and the link call sequences are the same.
"""

from __future__ import annotations

import math


class WaypointSequencer:
    """goals: list of (x, y, z, yaw_rad, dwell_s).

    `tick(pose, t)` publishes the current goal via `goal_sink(x,y,z,yaw)`
    and advances when `pose = (x,y,z,yaw)` is inside the tolerance box.
    Returns True while waypoints remain.
    """

    POS_TOL = 0.3              # m, demo.py:44-46
    YAW_TOL = math.radians(10)  # demo.py:47

    def __init__(self, goals, goal_sink):
        self.goals = list(goals)
        self.goal_sink = goal_sink
        self.index = 0
        self._reached_at = None

    @property
    def current(self):
        return self.goals[self.index]

    @property
    def done(self) -> bool:
        return self.index >= len(self.goals) - 1 and self._reached_at is None \
            and getattr(self, "_finished", False)

    def tick(self, pose, t: float) -> bool:
        gx, gy, gz, gyaw, dwell = self.current
        self.goal_sink(gx, gy, gz, gyaw)
        x, y, z, yaw = pose
        inside = (abs(x - gx) < self.POS_TOL and abs(y - gy) < self.POS_TOL
                  and abs(z - gz) < self.POS_TOL
                  and abs(yaw - gyaw) < self.YAW_TOL)
        if inside:
            if self._reached_at is None:
                self._reached_at = t
            elif t - self._reached_at >= dwell:
                if self.index < len(self.goals) - 1:
                    self.index += 1
                    self._reached_at = None
                else:
                    self._finished = True
                    return False
        else:
            self._reached_at = None
        return True
