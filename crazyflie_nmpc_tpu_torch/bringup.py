"""Named bringup compositions: the launch-file layer as code (PyTorch
counterpart of `bringup.py`; so far `swarm_serving`, the rest of the JAX
module is ROADMAP Queue 1, item 14).

Each bringup wires the same components together as the reference's
roslaunch files (SURVEY.md §2.1/§2.4) and returns a plain dict of results.
Bringups that exercise the radio path run the native link server against
the firmware simulators on localhost UDP: the seam a real Crazyradio
bridge would occupy.
"""

from __future__ import annotations

import contextlib


def swarm_serving(n: int = 8, ticks: int = 260, base_port: int = 47090,
                  rate_hz: float = 66.6, spacing: float = 0.6,
                  z: float = 0.4, lockstep: bool = True,
                  use_fused: bool | None = None, device=None, spec=None):
    """The multi-drone server as ONE batched solve: N cascade-plant
    vehicles behind the link, a single `rti_step_batched` call per tick
    with per-vehicle formation references, cmd_vel fanned out per
    vehicle, telemetry returning into a batched estimator, per-vehicle
    deadline accounting (crazyflie_server.cpp:155,1108-1131: the
    reference runs one NMPC node per drone; here the vehicle axis is the
    batch axis).  See runtime/swarm.py.

    The solve runs on `device` (None: the card), whatever `use_fused`
    says (None or True: `rti_step_batched`; False: `rti_step` per lane).
    `spec` defaults to the reference OCP in float32 there.  Vehicle i
    listens on base_port + 2i and its link on base_port + 2i + 1;
    base_port=0 lets the OS pick every port.  Beside the JAX package's
    keys the result holds the plant's host ms a period, and each
    vehicle's arming and last setpoint.
    """
    import torch

    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.device import resolve_device
    from crazyflie_nmpc_tpu_torch.runtime.swarm import (SwarmNMPC,
                                                        grid_targets,
                                                        serve_swarm)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp

    dev = resolve_device(device)
    if spec is None:
        spec = default_ocp(dtype=torch.float32, device=dev)
    targets = grid_targets(n, spacing=spacing, z=z)
    swarm = SwarmNMPC(spec, targets, use_fused=use_fused,
                      tick_dt=1.0 / rate_hz, device=dev)

    def port(i, side):
        return 0 if base_port == 0 else base_port + 2 * i + side

    with contextlib.ExitStack() as stack:
        fws = []
        for i in range(n):
            fw = native.CascadeFirmwareSim(
                port(i, 0), x0=(targets[i, 0], targets[i, 1], 0.03),
                plant_dt_ms=max(1, int(round(1000.0 / rate_hz))))
            stack.enter_context(fw)
            if not lockstep:
                fw.serve()
            fws.append(fw)
        server = stack.enter_context(native.LinkServer())
        vids = list(range(1, n + 1))
        for i, (vid, fw) in enumerate(zip(vids, fws)):
            server.add_vehicle(vid, "127.0.0.1", fw.port, port(i, 1))
        report = serve_swarm(spec, server, vids, fws, swarm, ticks,
                             rate_hz=rate_hz, lockstep=lockstep)
        stats = [server.stats(vid) for vid in vids]
        plant_s = sum(fw.plant_s for fw in fws)
        periods = sum(fw.plant_periods for fw in fws)
        armed = [fw.flying for fw in fws]
        setpoints = [fw.last_setpoint for fw in fws]
    return {"report": report, "summary": report.summary(),
            "targets": targets, "link_stats": stats,
            "plant_ms_per_period": 1e3 * plant_s / max(periods, 1),
            "armed": armed, "last_setpoints": setpoints}
