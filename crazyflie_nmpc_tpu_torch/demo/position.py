"""Absolute-position demo — crazyflie_demo/scripts/Position.py.

The reference resets the onboard EKF via param writes, then streams
`cmd_position` setpoints at 10 Hz: take off by ramping z = k/25 for 10
ticks, hold the target, land by ramping down, stop (Position.py:34-116).

The PyTorch port's own copy of the JAX package's `demo/position.py`: it is
framework-free, so the logic and the link call sequences are the same.
"""

from __future__ import annotations

import time as _time


def position_demo(link, vid: int, target=(0.0, 0.0, 0.4), yaw: float = 0.0,
                  hold_ticks: int = 20, kalman_reset_param: int | None = None,
                  sleep=None):
    """Run the Position.py flight plan; returns the list of (x,y,z,yaw)
    setpoints sent (for assertions)."""
    sleep = sleep or _time.sleep
    dt = 0.1  # 10 Hz
    sent = []

    def send(x, y, z, yw):
        link.send_position(vid, x, y, z, yw)
        sent.append((x, y, z, yw))
        sleep(dt)

    # EKF reset pulse (Position.py:34-39): param 1 then 0
    if kalman_reset_param is not None:
        link.set_param(vid, kalman_reset_param, 1, "uint8")
        sleep(dt)
        link.set_param(vid, kalman_reset_param, 0, "uint8")
        sleep(dt)

    # take off: z ramps k/25 for 10 ticks (Position.py:43-59)
    for k in range(10):
        send(0.0, 0.0, k / 25.0, 0.0)
    # move to target and hold (Position.py:60-77)
    for _ in range(hold_ticks):
        send(target[0], target[1], target[2], yaw)
    # land: ramp down from the target height (Position.py:78-105)
    z = target[2]
    while z > 0.0:
        send(target[0], target[1], max(z, 0.0), yaw)
        z -= target[2] / 10.0
    link.send_stop(vid)
    return sent
