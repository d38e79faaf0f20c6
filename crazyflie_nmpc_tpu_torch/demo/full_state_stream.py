"""Full-state trajectory streamer — crazyflie_demo/scripts/execute_trajectory.py
(PyTorch counterpart of `demo/full_state_stream.py`).

Evaluates a piecewise-polynomial trajectory through the differential
flatness map (pos/vel/acc/quat/omega) at 100 Hz and streams
`cmd_full_state` setpoints until the trajectory duration elapses
(execute_trajectory.py:20-56; the omega/attitude construction is
uav_trajectory.py:70-84 via utils.trajectories.flat_to_state).

The flatness map runs on the coefficients' device (numpy coefficients:
the CPU).  Each setpoint is read back for the link in one copy, an
intended wait on the card counted as `device.host_sync("emit")`.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import host_sync
from crazyflie_nmpc_tpu_torch.utils.trajectories import (
    eval_flat_outputs,
    flat_to_state,
)


def stream_trajectory(link, vid: int, durations, coeffs, params,
                      rate_hz: float = 100.0, sleep=None, now=None):
    """Stream the trajectory; returns the number of setpoints sent."""
    sleep = sleep or _time.sleep
    now = now or _time.monotonic
    coeffs = torch.as_tensor(coeffs)
    dev = coeffs.device
    durations_t = torch.as_tensor(durations, device=dev)
    total = float(np.sum(np.asarray(durations)))
    dt = 1.0 / rate_hz
    start = now()
    count = 0
    while True:
        t = now() - start
        if t > total:
            break
        flat = eval_flat_outputs(
            durations_t, coeffs,
            torch.full((), t, dtype=durations_t.dtype, device=dev))
        x, _ = flat_to_state(flat, params)
        # x = [pos(3), quat(4), v_body(3), omega(3)]; full-state setpoints
        # carry world-frame velocity (FullState msg twist.linear)
        with host_sync("emit"):
            host = torch.cat([x, flat["vel"], flat["acc"]]).cpu().numpy()
        x = np.asarray(host[:13], dtype=np.float32)
        vel = np.asarray(host[13:16], dtype=np.float32)
        acc = np.asarray(host[16:19], dtype=np.float32)
        link.send_full_state(vid, x[0:3], vel, acc, x[3:7], x[10:13])
        count += 1
        sleep(dt)
    return count
