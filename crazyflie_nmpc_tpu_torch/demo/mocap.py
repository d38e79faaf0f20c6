"""Mocap bridges — crazyflie_demo/scripts/publish_external_position_*.py.

The reference republishes motion-capture samples onto the vehicle's
`external_position`/`external_pose` topic; variants differ only in the
tracker client (vicon/vrpn/eraptor) and whether they one-time-initialize
the onboard EKF from the first marker (publish_external_position_eraptor
.py:38-50).  Here the tracker is a `pose_source()` callable returning
(x, y, z) or (x, y, z, qw, qx, qy, qz); the fake bridge publishes a
constant origin at 10 Hz, which is what the reference's bench test uses
(publish_external_position_fake.py:14-24, crazy_AFL.launch).

The PyTorch port's own copy of the JAX package's `demo/mocap.py`: it is
framework-free, so the logic and the link call sequences are the same.
"""

from __future__ import annotations

import time as _time


class MocapBridge:
    """Forward pose_source() samples to the link at `rate_hz`.

    If `ekf_init_params` is given as (initialX_id, initialY_id,
    initialZ_id, reset_id), the first sample writes the EKF initial
    position params and pulses the reset flag — the eraptor bridge's
    one-time initialization (publish_external_position_eraptor.py:38-50).
    """

    def __init__(self, link, vid: int, pose_source, rate_hz: float = 10.0,
                 ekf_init_params=None, sleep=None):
        self.link = link
        self.vid = vid
        self.pose_source = pose_source
        self.rate_hz = rate_hz
        self.ekf_init_params = ekf_init_params
        self._sleep = sleep or _time.sleep
        self._initialized = False
        self.published = 0

    def _maybe_init_ekf(self, sample):
        if self._initialized or self.ekf_init_params is None:
            return
        x_id, y_id, z_id, reset_id = self.ekf_init_params
        self.link.set_param(self.vid, x_id, float(sample[0]), "float")
        self.link.set_param(self.vid, y_id, float(sample[1]), "float")
        self.link.set_param(self.vid, z_id, float(sample[2]), "float")
        self.link.set_param(self.vid, reset_id, 1, "uint8")
        self.link.set_param(self.vid, reset_id, 0, "uint8")
        self._initialized = True

    def step(self):
        """Publish one sample; returns it."""
        sample = self.pose_source()
        if sample is None:
            return None
        self._maybe_init_ekf(sample)
        if len(sample) >= 7:
            # full pose: position + quaternion (external_pose topic path)
            self.link.send_external_pose(self.vid, float(sample[0]),
                                         float(sample[1]), float(sample[2]),
                                         list(sample[3:7]))
        else:
            self.link.send_external_position(self.vid, float(sample[0]),
                                             float(sample[1]),
                                             float(sample[2]))
        self.published += 1
        return sample

    def run(self, n_samples: int):
        for _ in range(n_samples):
            self.step()
            self._sleep(1.0 / self.rate_hz)
        return self.published


class FakeMocapBridge(MocapBridge):
    """Constant-origin publisher at 10 Hz — the reference's fake bridge
    used by the full-pipeline bench launch (publish_external_position_fake
    .py:14-24, crazy_AFL.launch:33-35)."""

    def __init__(self, link, vid: int, origin=(0.0, 0.0, 0.0), sleep=None):
        super().__init__(link, vid, pose_source=lambda: origin,
                         rate_hz=10.0, sleep=sleep)
