"""Named bringup compositions: the launch-file layer as code (PyTorch
counterpart of `bringup.py`).

The reference composes its stack with ~40 roslaunch files (SURVEY.md
§2.1/§2.4).  Here each headline bringup is a named function that wires the
same components together and runs them; `python -m
crazyflie_nmpc_tpu_torch.bringup <name>` is the `roslaunch` equivalent.
Mapping:

| reference launch                  | bringup here            |
|-----------------------------------|-------------------------|
| acados_predictor.launch           | nmpc_predictor          |
| crazy_AFL.launch (fake mocap)     | nmpc_attitude_bench     |
| crazyflie2.launch + demo.py       | pid_waypoints           |
| system_identification.launch      | system_identification   |
| hover.launch / Hover.py           | hover_demo              |
| position.launch / Position.py     | position_demo           |
| multi_hover_*.launch              | multi_hover             |
| teleop_*.launch                   | teleop                  |

Each returns a plain dict of results so callers/tests can assert on them.
Bringups that exercise the radio path run the native link server against
the firmware simulators on localhost UDP: the seam a real Crazyradio
bridge would occupy.

The compositions that hold tensors (`nmpc_predictor`,
`nmpc_attitude_bench`, `pid_waypoints`, `system_identification`,
`swarm_serving`) take `device=None`, which means the card (and raises
without one); they run where they are told and touch no global device
setting.  The rest are host-side wire compositions.  Every UDP port
argument also takes 0: the OS picks the port, and the link binds its own
side with 0 too.  A wait on the card that a composition makes on purpose
(a command read back for the wire, a pose for the waypoint sequencer, the
plant for the log provider) goes through `device.host_sync`.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import (from_host, host_array,
                                             host_sync, resolve_device)


def _link_port(port: int) -> int:
    """The link's local port beside a vehicle on `port` (0: the OS picks
    both)."""
    return 0 if port == 0 else port + 1


def nmpc_predictor(steps: int = 660, delay: float = 0.06,
                   traj: str = "helix", f64: bool = True,
                   actuation: str = "cmd_vel", device=None):
    """acados_predictor.launch: the full NMPC pipeline, tracking the helix
    reference with the delay-compensating estimator at delay=0.06 s
    (acados_predictor.launch:56-65).

    actuation selects the command path out of the controller:
      "cmd_vel" (default): the configuration the reference actually
        flew, composed end-to-end: u1/x4 -> cmd_vel -> radio pipe ->
        onboard attitude cascade, with the model-consistent single-
        last-command predictor (runtime.flight_configuration).
      "rotor": rotor-level actuation with the pipe-accurate
        pending-commands predictor (runtime.estimator_in_the_loop).

    Runs on `device` (None: the card), the reference OCP in float64 if
    `f64`.
    """
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime import (LoopConfig,
                                                  estimator_in_the_loop,
                                                  flight_configuration,
                                                  tracking_error)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp, policies
    from crazyflie_nmpc_tpu_torch.utils import (helix_trajectory,
                                                smooth_step_trajectory)

    dev = resolve_device(device)
    dtype = torch.float64 if f64 else torch.float32
    spec = default_ocp(dtype=dtype, device=dev)
    make = helix_trajectory if traj == "helix" else smooth_step_trajectory
    table = make(spec.params, dtype=dtype, device=dev)
    delay_steps = int(round(delay / float(spec.dt)))
    cfg = LoopConfig(ipm=IPMConfig(iters=8))
    steps = min(int(steps), table.shape[0] - 1)
    if actuation == "cmd_vel":
        # the paper's flight configuration in ONE loop: estimator chain +
        # cmd_vel extraction + radio delay + onboard cascade
        res = flight_configuration(spec, table, steps=steps,
                                   delay_steps=delay_steps, config=cfg)
    elif actuation == "rotor":
        # full-fidelity rotor-level variant: the estimator node's
        # reconstruction feeds the NMPC, rotor commands ride the pipe
        res = estimator_in_the_loop(
            spec, table[0, :13], steps=steps, delay_steps=delay_steps,
            config=cfg, policy_state=policies.tracking_state(device=dev),
            traj_table=table)
    else:
        raise ValueError(f"actuation must be 'cmd_vel' or 'rotor', "
                         f"got {actuation!r}")
    err = tracking_error(res, table)
    return {"result": res, "tracking_err_max": float(err.max()),
            "kkt_max": float(np.max(host_array(res.kkt_res))),
            "delay_steps": delay_steps, "actuation": actuation}


def nmpc_attitude_bench(steps: int = 300, port: int = 47051,
                        bag_path: str | None = None, device=None):
    """crazy_AFL.launch: the NMPC bench against the *fake* mocap bridge
    (constant origin at 10 Hz) with cmd_vel recorded at the device side,
    the reference's full-pipeline smoke test (crazy_AFL.launch:33-89,
    publish_external_position_fake.py:14-24).  Like the reference launch,
    the run can record a bag of the streamed topics (rosbag record of
    cmd_vel/euler/openloop, crazy_AFL.launch:64-72) via `bag_path`.

    The solve runs on `device` (None: the card), the reference OCP in
    float32; each tick's command is read back for the wire in one copy
    (`host_sync("emit")`)."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.demo import FakeMocapBridge
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.solver import (default_ocp, hover_yref,
                                                 init_rti, rti_step,
                                                 to_cmd_vel)

    dev = resolve_device(device)
    spec = default_ocp(dtype=torch.float32, device=dev)
    # regulation set-point at the fake mocap's origin: bench expects a
    # level-attitude, hover-thrust response
    yref, yref_e = hover_yref(spec, pos=(0.0, 0.0, 0.0), device=dev)
    cfg = IPMConfig(iters=8)
    cmd_vel_log = []
    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        bridge = FakeMocapBridge(server, 1, sleep=lambda _dt: None)

        # "motors disarmed": the state fed to the NMPC is the fake-mocap
        # origin-at-rest state; the controller's attitude/thrust response
        # is what the bench records.
        x_hat = hover_state(spec.params, dtype=spec.lbu.dtype, device=dev)
        rti = init_rti(spec, x_hat, device=dev)
        for _ in range(steps):
            bridge.step()
            rti, out = rti_step(spec, rti, x_hat, yref, yref_e, cfg)
            cmd = to_cmd_vel(out.u1, out.x_at(4))
            with host_sync("emit"):
                roll, pitch, yawrate, thrust = torch.stack(
                    [cmd.roll_deg, cmd.pitch_deg, cmd.yawrate_deg,
                     cmd.thrust_pwm]).tolist()
            server.send_setpoint(1, roll, pitch, yawrate, int(thrust))
            cmd_vel_log.append((roll, pitch, yawrate, int(thrust)))

        deadline = time.time() + 2.0
        while fw.last_setpoint is None and time.time() < deadline:
            time.sleep(0.01)
        stats = server.stats(1)
        device_setpoint = fw.last_setpoint
        mocap_published = bridge.published
    if bag_path:
        from crazyflie_nmpc_tpu_torch.runtime.bag import BagWriter

        cmd_arr = np.asarray(cmd_vel_log, np.float64)
        ts = float(spec.dt) * np.arange(len(cmd_arr))
        with BagWriter(bag_path) as w:
            w.write_series("cmd_vel", ts, cmd_arr)
    return {"cmd_vel": np.asarray(cmd_vel_log), "link_stats": stats,
            "device_setpoint": device_setpoint,
            "mocap_published": mocap_published}


def bag_play(bag_path: str, channel: str | None = None):
    """bag_play.launch + test_rosbag.launch: replay a recorded flight bag
    in time order and summarize each channel (the rqt_plot inspection
    step, bag_play.launch:1-31, test_rosbag.launch:1-18)."""
    from crazyflie_nmpc_tpu_torch.runtime.bag import Bag

    bag = Bag(bag_path)
    names = [channel] if channel else bag.names()
    n_events = sum(1 for _ in bag.play(names))
    return {"summary": bag.summary(), "events_replayed": n_events,
            "channels": names}


def pid_waypoints(goals=None, max_steps: int = 4000, device=None):
    """crazyflie2.launch + demo.py: PID waypoint navigation with the
    0.3 m / 10 deg advance rule, on the grounded plant, in float32 on
    `device` (None: the card).  The sequencer reads the pose back every
    tick (`host_sync("pose")`).  With max_steps=0 no tick runs: steps 0,
    not completed."""
    from crazyflie_nmpc_tpu_torch import pid as pidm
    from crazyflie_nmpc_tpu_torch.demo import WaypointSequencer
    from crazyflie_nmpc_tpu_torch.device import device_tensor
    from crazyflie_nmpc_tpu_torch.models import (QuadrotorParams, dynamics,
                                                 hover_state, rotations)
    from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step
    from crazyflie_nmpc_tpu_torch.solver.outputs import pwm2krpm

    dev = resolve_device(device)
    goals = goals or [(0.0, 0.0, 0.6, 0.0, 0.2), (0.0, 0.0, 0.9, 0.0, 0.2)]
    dt = 0.02  # 50 Hz (controller.cpp:254)
    params = QuadrotorParams()
    gains = pidm.default_gains(torch.float32, device=dev)
    st = pidm.init_pid(device=dev)
    x = hover_state(params, pos=(0.0, 0.0, 0.0), dtype=torch.float32,
                    device=dev)
    st = pidm.takeoff(st, x[2])
    # the floor clamps z and the body z velocity (entries 2 and 9)
    idx = torch.arange(x.shape[0], device=dev)
    floor = (idx == 2) | (idx == 9)

    goal_box = {"g": goals[0][:4]}
    seq = WaypointSequencer(goals,
                            lambda *g: goal_box.__setitem__("g", g))
    goal_tensors = {}
    visited, alive, steps = [], True, 0
    t = 0.0
    for k in range(max_steps):
        steps = k + 1
        rpy = rotations.quat_to_euler(x[3:7])
        with host_sync("pose"):
            pose = tuple(torch.stack([x[0], x[1], x[2], rpy[2]]).tolist())
        alive = seq.tick(pose, t)
        visited.append(seq.index)
        if not alive:
            break
        gx, gy, gz, gyaw = goal_box["g"]
        if (gx, gy, gz) not in goal_tensors:
            goal_tensors[gx, gy, gz] = device_tensor((gx, gy, gz),
                                                     torch.float32, dev)
        st, cmd = pidm.pid_step(gains, st, x, goal_tensors[gx, gy, gz],
                                gyaw, dt)
        krpm = torch.clamp(pwm2krpm(cmd.thrust), 0.0, 22.0)
        x_next = rk4_step(dynamics, params, x, krpm.expand(4), dt)
        on_ground = (x_next[2] <= 0.0) & (x_next[9] <= 0.0)
        # a new tensor each tick: the next tick reads x_next's storage
        x = torch.where(on_ground & floor, torch.zeros_like(x_next),
                        x_next)
        t += dt
    with host_sync("pose"):
        final_z = float(x[2])
    return {"waypoints_reached": max(visited, default=0)
            + (0 if alive else 1),
            "n_goals": len(goals), "completed": not alive,
            "final_z": final_z, "steps": steps}


# the log variables the identification stream reads from the plant, in
# the order of their host copy (position, Euler angles, gyro)
_SYSID_VARS = ("stateEstimate.x", "stateEstimate.y", "stateEstimate.z",
               "stabilizer.roll", "stabilizer.pitch", "stabilizer.yaw",
               "gyro.x", "gyro.y", "gyro.z")


def system_identification(steps: int = 400, port: int = 47053,
                          device=None):
    """system_identification.launch: stream motor + state logs at 100 Hz
    through the link and assemble the sysid measurement table
    (measurements_vector.cpp pipeline + log blocks at 10 ms).

    The plant steps on `device` (None: the card); after each step one
    host copy of the logged values (`host_sync("plant")`) is what the
    firmware simulator's thread reads."""
    import struct

    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.estimator.sysid import (
        assemble_measurements)
    from crazyflie_nmpc_tpu_torch.models import (QuadrotorParams, dynamics,
                                                 hover_state, rotations)
    from crazyflie_nmpc_tpu_torch.ops.integrators import rk4_step

    dev = resolve_device(device)
    params = QuadrotorParams()
    dt = 0.01  # 100 Hz stream (system_identification.launch:33-40)
    # plant: gentle torque-balanced climb from hover (open-loop stable
    # enough over 4 s)
    x = hover_state(params, dtype=torch.float32, device=dev)
    uss = float(params.hover_speed())
    u = torch.full((4,), uss, dtype=torch.float32, device=dev)

    def readout(xs):
        logged = torch.cat([
            xs[0:3], rotations.rad2deg(rotations.quat_to_euler(xs[3:7])),
            rotations.rad2deg(xs[10:13])])
        with host_sync("plant"):
            values = dict(zip(_SYSID_VARS, logged.tolist()))
        values.update({f"motor.m{i}": uss for i in range(1, 5)})
        return values

    plant = {"x": x, "host": readout(x)}

    def provider(name):
        return plant["host"].get(name, 0.0)

    with native.FirmwareSim(port, state_provider=provider).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        pos_ids = [fw.log_vars[n][0] for n in _SYSID_VARS[0:3]]
        att_ids = [fw.log_vars[n][0] for n in _SYSID_VARS[3:6]]
        gyr_ids = [fw.log_vars[n][0] for n in _SYSID_VARS[6:9]]
        server.log_create_block(1, 1, [(7, i) for i in pos_ids])
        server.log_create_block(1, 2, [(7, i) for i in att_ids])
        server.log_create_block(1, 3, [(7, i) for i in gyr_ids])
        for bid in (1, 2, 3):
            server.log_start_block(1, bid, 1)  # 10 ms period

        rows = {1: [], 2: [], 3: []}
        deadline = time.time() + 20.0
        while (min(len(v) for v in rows.values()) < steps
               and time.time() < deadline):
            rec = server.poll_log(1)
            if rec is None:
                # advance the plant at the stream rate
                plant["x"] = rk4_step(dynamics, params, plant["x"], u, dt)
                plant["host"] = readout(plant["x"])
                time.sleep(0.001)
                continue
            if rec["block_id"] in rows and len(rec["payload"]) >= 12:
                rows[rec["block_id"]].append(
                    struct.unpack("<fff", rec["payload"][:12]))
        n = min(len(v) for v in rows.values())
        positions = np.asarray(rows[1][:n])
        eulers = np.deg2rad(np.asarray(rows[2][:n]))
        gyros = np.deg2rad(np.asarray(rows[3][:n]))
    meas = assemble_measurements(
        *(from_host(a, torch.float32, dev)
          for a in (positions, eulers, gyros)), dt=0.01)
    return {"measurements": host_array(meas), "rows": n}


def thrust_identification(steps: int = 100, port: int = 47054,
                          thrust_pwm: int = 12000):
    """thrust_identification.launch + const_thrust.py: stream a constant
    cmd_vel thrust (const_thrust.py:16-18, 50 Hz) while logging the motor
    PWM echo at 10 ms (thrust_identification.launch:26-35), the capture
    used offline to fit the krpm2pwm map (acados_mpc.cpp:421-425)."""
    import struct

    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.solver.outputs import pwm2krpm

    sim = {}

    def provider(name):
        # a real CF at level attitude echoes the commanded thrust on all
        # four motors: that echo is exactly what the launch file records
        fw = sim.get("fw")
        sp = fw.last_setpoint if fw else None
        if name.startswith("motor.m") and sp is not None:
            return float(sp[3])
        return 0.0

    with native.FirmwareSim(port, state_provider=provider).serve() as fw, \
            native.LinkServer() as server:
        sim["fw"] = fw
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        motor_ids = [fw.log_vars[f"motor.m{i}"][0] for i in range(1, 5)]
        server.log_create_block(1, 1, [(7, i) for i in motor_ids])
        server.log_start_block(1, 1, 1)  # 10 ms

        rows = []
        next_sp = 0.0
        deadline = time.time() + 20.0
        while len(rows) < steps and time.time() < deadline:
            now = time.time()
            if now >= next_sp:  # 50 Hz constant-thrust stream
                server.send_setpoint(1, 0.0, 0.0, 0.0, thrust_pwm)
                next_sp = now + 0.02
            rec = server.poll_log(1)
            if rec is None:
                time.sleep(0.001)
                continue
            if rec["block_id"] == 1 and len(rec["payload"]) >= 16:
                rows.append(struct.unpack("<ffff", rec["payload"][:16]))
        pwm = np.asarray(rows).reshape(-1, 4)
        # drop rows streamed before the first setpoint landed
        pwm = pwm[np.any(pwm > 0, axis=1)]
    return {"rows": len(pwm), "motor_pwm": pwm,
            "commanded_pwm": thrust_pwm,
            "implied_krpm": float(pwm2krpm(float(pwm.mean())))
            if len(pwm) else float("nan")}


def high_level_mission(port: int = 47056):
    """test_high_level.py FLOWN over the wire: enable the high-level
    commander + Mellinger controller + EKF via params, then takeoff ->
    upload a polynomial trajectory -> startTrajectory -> land -> stop,
    with the vehicle side EXECUTING every command through the onboard
    cascade (native.FlyingFirmwareSim), so the mission produces motion,
    not just acks (test_high_level.py:13-23,50;
    crazyflie_server.cpp:920-992; uav_trajectory.py:54-84).

    Wire phases run under the firmware's real-time serve loop; flight
    phases fast-forward simulated time, so the whole mission returns in
    seconds.  Returns the command log, the params, and flight evidence:
    flown tick count, max tracking error vs the Polynomial4D evaluation,
    and the final (landed) position."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.utils import trajectories as traj

    def minjerk_piece(p0, p1, T):
        """Quintic min-jerk segment as one poly4d piece (4, 8)."""
        c = np.zeros((4, 8))
        for a in range(3):
            d = p1[a] - p0[a]
            c[a, 0] = p0[a]
            c[a, 3] = 10 * d / T**3
            c[a, 4] = -15 * d / T**4
            c[a, 5] = 6 * d / T**5
        return c

    durations = np.array([2.0, 2.0])
    coeffs = np.stack([
        minjerk_piece((0.0, 0.0, 0.0), (0.4, 0.2, 0.1), 2.0),
        minjerk_piece((0.4, 0.2, 0.1), (0.0, 0.0, 0.0), 2.0)])

    with native.FlyingFirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        toc = server.download_param_toc(1)
        for name, v in [("commander/enHighLevel", 1),
                        ("stabilizer/estimator", 2),
                        ("stabilizer/controller", 2),
                        ("kalman/resetEstimation", 1)]:
            server.set_param(1, toc[name][0], v, ptype="uint8")
        server.upload_trajectory(
            1, traj_id=1, data=traj.encode_poly4d(durations, coeffs),
            n_pieces=2)

        def wire(send, pred, timeout=5.0):
            ok = send()
            deadline = time.time() + timeout
            while time.time() < deadline and not pred():
                time.sleep(0.005)
            return ok and pred()

        def fly(ms):
            fw.stop_serving()
            for _ in range(ms // 15):
                fw.poll(15)
            fw.serve()

        cmds = fw.hl_commands
        has = lambda c: any(k["cmd"] == c for k in cmds)  # noqa: E731
        ok = wire(lambda: server.takeoff(1, height=0.5, duration=2.0),
                  lambda: has("takeoff") and 1 in fw.trajectories)
        fly(2600)
        start_pos = fw.x[:3].copy()
        ok &= wire(lambda: server.start_trajectory(1, 1, relative=True),
                   lambda: has("start_trajectory"))
        t0_ms = fw.seg_t0_ms
        fly(4400)
        # flown path vs the Polynomial4D evaluation (shifted to the
        # relative start), the uav_trajectory.py math in float64
        errs = []
        for t, x in fw.flown:
            tau = t - t0_ms / 1000.0
            if 0.0 <= tau <= 4.0:
                f = traj.eval_flat_outputs(
                    durations, coeffs, torch.tensor(tau, dtype=torch.float64))
                exp = f["pos"].numpy() + (start_pos - coeffs[0, :3, 0])
                errs.append(float(np.abs(x[:3] - exp).max()))
        ok &= wire(lambda: server.land(1, height=0.0, duration=2.0),
                   lambda: has("land"))
        fly(2600)
        ok &= wire(lambda: server.hl_stop(1), lambda: has("stop"))
        return {"hl_commands": list(cmds),
                "wire_ok": bool(ok),
                "params": {n: fw.get_param(n) for n in
                           ("commander/enHighLevel", "stabilizer/estimator",
                            "stabilizer/controller",
                            "kalman/resetEstimation")},
                "flown_ticks": len(fw.flown),
                "max_tracking_err_m": max(errs) if errs else None,
                "final_pos": [round(float(v), 4) for v in fw.x[:3]],
                "landed": not fw.flying}


def _wait_for_stop(fw, seconds=2.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        sp = fw.last_generic_setpoint
        if sp and sp["type"] == "stop":
            return
        time.sleep(0.01)


def hover_demo(port: int = 47055):
    """hover.launch + Hover.py through the real link + firmware sim."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.demo import HoverDemo

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        demo = HoverDemo(server, 1,
                         sleep=lambda dt: time.sleep(min(dt, 0.002)))
        demo.take_off(0.4)
        demo.go_to(0.2, 0.0, 0.4)
        demo.land()
        _wait_for_stop(fw)
        return {"final_setpoint": fw.last_generic_setpoint,
                "stats": server.stats(1)}


def position_demo(port: int = 47057):
    """position.launch + Position.py through the link + firmware sim."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.demo import position_demo as run_position

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        sent = run_position(server, 1, target=(0.0, 0.0, 0.4),
                            sleep=lambda dt: time.sleep(min(dt, 0.002)),
                            kalman_reset_param=fw.param_ids[
                                "kalman/resetEstimation"])
        _wait_for_stop(fw)
        return {"setpoints_sent": len(sent),
                "final_setpoint": fw.last_generic_setpoint}


def multi_hover(n: int = 2, base_port: int = 47060):
    """multi_hover_*.launch: N vehicles, one hover plan per thread.
    Vehicle i listens on base_port + 2i and its link on base_port + 2i +
    1; base_port=0 lets the OS pick every port."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.demo.hover import run_two_vehicle_demo

    def port(i, side):
        return 0 if base_port == 0 else base_port + 2 * i + side

    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(native.FirmwareSim(port(i, 0)).serve())
               for i in range(n)]
        server = stack.enter_context(native.LinkServer())
        for i, fw in enumerate(fws):
            server.add_vehicle(i + 1, "127.0.0.1", fw.port, port(i, 1))
        demos = run_two_vehicle_demo(
            server, vids=tuple(range(1, n + 1)),
            sleep=lambda dt: time.sleep(min(dt, 0.001)))
        return {"vehicles": n,
                "landed": all(d.z_distance == 0.0 for d in demos),
                "stats": [server.stats(i + 1) for i in range(n)]}


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
    from crazyflie_nmpc_tpu_torch import native
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


def teleop(ticks: int = 50, port: int = 47070):
    """teleop_*.launch: joystick axis mapping streaming cmd_vel at 100 Hz
    (axes scripted: no joystick hardware is assumed)."""
    from crazyflie_nmpc_tpu_torch import native
    from crazyflie_nmpc_tpu_torch.demo import Teleop

    with native.FirmwareSim(port).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        tele = Teleop(server, 1, axes_source=lambda: (0.1, -0.1, 0.0, 0.2),
                      sleep=lambda dt: time.sleep(min(dt, 0.001)))
        tele.run(ticks)
        deadline = time.time() + 2.0
        while fw.last_setpoint is None and time.time() < deadline:
            time.sleep(0.01)
        return {"device_setpoint": fw.last_setpoint,
                "stats": server.stats(1)}


def telemetry(seconds: float = 1.2, port: int = 47080):
    """The reference server's typed telemetry plane on connect
    (crazyflie_server.cpp:519-651): instance the imu (10 ms) and
    mag/baro/battery + rssi (100 ms) blocks against a simulated vehicle
    and return the latest unit-converted channels."""
    from crazyflie_nmpc_tpu_torch import native

    state = {"gyro.x": 5.0, "gyro.y": -2.0, "gyro.z": 0.5,
             "acc.x": 0.01, "acc.y": -0.02, "acc.z": 1.0,
             "mag.x": 2.2e-5, "mag.y": 0.4e-5, "mag.z": 4.3e-5,
             "baro.temp": 25.0, "baro.pressure": 1013.25,
             "pm.vbat": 3.95, "radio.rssi": -52.0}
    with native.FirmwareSim(port, state_provider=lambda n:
                            state.get(n, 0.0)).serve() as fw, \
            native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, _link_port(port))
        toc = server.download_log_toc(1)
        layout = native.start_typed_channels(server, 1, toc)
        latest, counts = {}, {}
        deadline = time.time() + seconds
        while time.time() < deadline:
            rec = server.poll_log(1)
            if rec is None:
                time.sleep(0.002)
                continue
            ch = native.decode_channels(rec, layout)
            if ch is not None:
                latest[rec["block_id"]] = ch
                counts[rec["block_id"]] = counts.get(rec["block_id"],
                                                     0) + 1
        native.stop_typed_channels(server, 1, layout)
        return {"channels": {f"0x{bid:X}": ch
                             for bid, ch in latest.items()},
                "records": {f"0x{bid:X}": n for bid, n in counts.items()}}


def session(panes):
    """The reference's tmux workbench, re-expressed
    (crazyflie_demo/scripts/tmux_create_panes + tmux_openinpane +
    tmux_clear_panes): several nodes running side by side in one
    session.  Here a "pane" is a named bringup composition run on its
    own thread; the session starts them together, joins them all, and
    returns per-pane results (the C-c-everything teardown of
    tmux_clear_panes is the join: bringups are finite compositions,
    not daemons).

    panes: {pane_name: (bringup_name, *args)}.  Bringups that open UDP
    endpoints must be given distinct ports (as distinct tmux panes
    would), or port 0.  Returns {pane_name: result-or-exception}.
    Panes on the card share the process's CUDA context, launch counters
    and host-sync counts.
    """
    import threading

    results = {}

    def run_pane(pane, name, args):
        try:
            results[pane] = BRINGUPS[name](*args)
        except Exception as e:          # a crashed pane must not take
            results[pane] = e           # down the session (tmux semantics)

    threads = [
        threading.Thread(target=run_pane, args=(pane, spec[0], spec[1:]),
                         name=f"pane-{pane}", daemon=True)
        for pane, spec in panes.items()
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


BRINGUPS = {
    "nmpc_predictor": nmpc_predictor,
    "telemetry": telemetry,
    "nmpc_attitude_bench": nmpc_attitude_bench,
    "pid_waypoints": pid_waypoints,
    "system_identification": system_identification,
    "thrust_identification": thrust_identification,
    "high_level_mission": high_level_mission,
    "hover_demo": hover_demo,
    "position_demo": position_demo,
    "multi_hover": multi_hover,
    "swarm_serving": swarm_serving,
    "teleop": teleop,
    "bag_play": bag_play,
}

# the compositions that hold tensors: they take `device`
DEVICE_BRINGUPS = ("nmpc_predictor", "nmpc_attitude_bench", "pid_waypoints",
                   "system_identification", "swarm_serving")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="crazyflie_nmpc_tpu_torch.bringup")
    ap.add_argument("name", choices=sorted(BRINGUPS))
    ap.add_argument("extra", nargs="*",
                    help="positional args for the composition "
                         "(e.g. the bag path for bag_play)")
    ap.add_argument("--device", default=None,
                    help="where a composition that holds tensors runs "
                         "(default: the card; 'cpu' on a host without "
                         "one)")
    args = ap.parse_args(argv)
    kw = {}
    if args.name in DEVICE_BRINGUPS:
        kw["device"] = resolve_device(args.device)
    out = BRINGUPS[args.name](*args.extra, **kw)
    for k, v in out.items():
        if isinstance(v, np.ndarray):
            v = f"array{v.shape}"
        elif hasattr(v, "_fields") or str(type(v)).startswith(
                "<class 'crazyflie"):
            v = type(v).__name__
        print(f"{k}: {v}")
    print(f"device: {kw.get('device', 'host (a wire composition)')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
