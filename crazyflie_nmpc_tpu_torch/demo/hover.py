"""Velocity-hover demo — crazyflie_demo/scripts/Hover.py re-expressed.

The reference flies relative moves by streaming `cmd_hover` setpoints
(body-frame vx/vy [m/s], yaw rate, absolute z distance) at 10 Hz, picking
a constant ±0.1 m/s speed on the longest axis and scaling the others so
all three arrive together (Hover.py:34-117).  `takeOff`/`land` ramp the
z-distance in 0.1 m increments (Hover.py:119-157).  The two-vehicle demo
runs two of these state machines on parallel threads (Hover.py:161-175).

The PyTorch port's own copy of the JAX package's `demo/hover.py`: it is
framework-free, so the logic and the link call sequences are the same.
"""

from __future__ import annotations

import time as _time
from threading import Thread


class HoverDemo:
    """Drives one vehicle on `link` (LinkServer-compatible) with hover
    setpoints.  `sleep`/`now` are injectable for fast deterministic tests.
    """

    RATE_HZ = 10.0
    SPEED = 0.1  # m/s, the reference's fixed axis speed

    def __init__(self, link, vid: int, sleep=None, now=None):
        self.link = link
        self.vid = vid
        self.z_distance = 0.0
        self._sleep = sleep or _time.sleep
        self._now = now or _time.monotonic

    def _signed_speed(self, distance: float) -> float:
        if distance > 0:
            return self.SPEED
        if distance < 0:
            return -self.SPEED
        return 0.0

    def go_to(self, x: float, y: float, z_distance: float, yaw: float = 0.0):
        """Relative x/y move + absolute target z, all axes arriving
        together (the Hover.py:49-117 duration/scale math)."""
        z = self.z_distance
        dz = z - z_distance
        vx = self._signed_speed(x)
        vy = self._signed_speed(y)
        z_scale = self._signed_speed(z)

        duration_x = abs(x / self.SPEED) if x != 0 else 0.0
        duration_y = abs(y / self.SPEED) if y != 0 else 0.0
        duration_z = abs(dz) / self.SPEED
        duration = max(duration_x, duration_y, duration_z)
        if duration == 0:
            return
        if duration == duration_x:
            vy *= abs(y / x)
            z_scale *= abs(dz / x)
        elif duration == duration_y:
            vx *= abs(x / y)
            z_scale *= abs(dz / y)
        else:
            vx *= abs(x / dz) if dz != 0 else 0.0
            vy *= abs(y / dz) if dz != 0 else 0.0

        start = self._now()
        while self._now() - start <= duration:
            self.link.send_hover(self.vid, vx, vy, 0.0, z)
            if z < z_distance:
                z += z_scale
            else:
                z = z_distance
            self._sleep(1.0 / self.RATE_HZ)
        self.z_distance = z_distance

    def take_off(self, z_distance: float):
        """Ramp z in 0.1 m increments from ground (Hover.py:119-138)."""
        time_range = 1 + int(10 * z_distance / 0.4)
        while time_range > 0:
            self.link.send_hover(self.vid, 0.0, 0.0, 0.0, self.z_distance)
            time_range -= 1
            if self.z_distance < z_distance:
                self.z_distance += 0.1
            self._sleep(1.0 / self.RATE_HZ)
        self.z_distance = z_distance

    def land(self):
        """Descend in 0.1 m steps, then stop (Hover.py:140-157)."""
        z = self.z_distance
        while z > 0.0:
            self.link.send_hover(self.vid, 0.0, 0.0, 0.0, z)
            z -= 0.1
            self._sleep(1.0 / self.RATE_HZ)
        self.link.send_stop(self.vid)
        self.z_distance = 0.0


def handler(demo: HoverDemo):
    """The reference's per-vehicle flight plan (Hover.py:161-168)."""
    demo.take_off(0.4)
    demo.go_to(0.3, 0.0, 0.4)
    demo.go_to(-0.3, 0.0, 0.4)
    demo.land()


def run_two_vehicle_demo(link, vids=(1, 2), sleep=None, now=None):
    """Two hover state machines on parallel threads (Hover.py:170-175)."""
    demos = [HoverDemo(link, vid, sleep=sleep, now=now) for vid in vids]
    threads = [Thread(target=handler, args=(d,)) for d in demos]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return demos
