"""The port's demo layer (`crazyflie_nmpc_tpu_torch.demo`) against the JAX
package's, on the CPU.

Each demo drives a recording link under a deterministic clock (the
`RecordingLink` and `FakeClock` of `tests/test_demo.py`, copied here), once
from each package: the two call logs are equal call for call, arguments
and all (the full-state streamer's arrays element for element: both
evaluate the flatness map in float64 and send float32).  The two-vehicle
hover demo runs its vehicles on threads, so its log is compared vehicle
by vehicle.  Then the port's demos fly through the port's native link
into its firmware simulator on ports the OS picks.
"""

import math
import time

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import demo as jdemo
from crazyflie_nmpc_tpu.demo import hover as jhover
from crazyflie_nmpc_tpu.models import QuadrotorParams as JParams
from crazyflie_nmpc_tpu_torch import demo as tdemo
from crazyflie_nmpc_tpu_torch.demo import hover as thover
from crazyflie_nmpc_tpu_torch.models import QuadrotorParams
from _torch_shared import one_torch_thread  # noqa: F401


class FakeClock:
    """Deterministic time: sleep() advances now() instantly."""

    def __init__(self):
        self.t = 0.0

    def sleep(self, dt):
        self.t += dt

    def now(self):
        return self.t


class RecordingLink:
    """LinkServer-compatible recorder (thread-safe enough for the demos)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def record(*args, **kw):
            self.calls.append((name, args, kw))
            return True

        return record

    def of(self, kind):
        return [c for c in self.calls if c[0] == kind]


def assert_same_calls(got, want):
    assert len(got) == len(want)
    for i, ((gn, ga, gk), (wn, wa, wk)) in enumerate(zip(got, want)):
        assert gn == wn and gk == wk and len(ga) == len(wa), i
        for g, w in zip(ga, wa):
            if isinstance(w, np.ndarray):
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype, i
                np.testing.assert_array_equal(g, w, err_msg=f"call {i}")
            else:
                assert type(g) is type(w) and g == w, (i, g, w)


def hover_plan(demo):
    clock, link = FakeClock(), RecordingLink()
    d = demo.HoverDemo(link, 1, sleep=clock.sleep, now=clock.now)
    d.take_off(0.4)
    d.go_to(0.3, 0.0, 0.4)
    d.go_to(-0.1, 0.2, 0.6)
    d.go_to(0.0, 0.0, 0.3)
    d.land()
    return link.calls, d.z_distance, clock.t


def position(demo):
    clock, link = FakeClock(), RecordingLink()
    sent = demo.position_demo(link, 1, target=(0.1, -0.2, 0.4), yaw=0.3,
                              kalman_reset_param=7, sleep=clock.sleep)
    return link.calls, sent, clock.t


def waypoints(demo):
    goals = [(0, 0, 0.5, 0.0, 0.0), (1.0, 0.0, 0.5, 0.0, 0.5),
             (1.0, 1.0, 0.5, math.pi / 2, 0.0)]
    published = []
    seq = demo.WaypointSequencer(goals, lambda *g: published.append(g))
    rng = np.random.default_rng(5)
    trace = []
    for k in range(120):
        gx, gy, gz, gyaw, _ = seq.current
        pose = (gx + 0.4 * rng.standard_normal(),
                gy + 0.4 * rng.standard_normal(),
                gz + 0.4 * rng.standard_normal(),
                gyaw + 0.2 * rng.standard_normal())
        trace.append((seq.tick(pose, 0.1 * k), seq.index))
    return published, trace


def stream(demo, params):
    clock, link = FakeClock(), RecordingLink()
    coeffs = np.zeros((2, 4, 8))
    coeffs[0, 0, 1] = 0.5            # x = 0.5 t on the first piece
    coeffs[0, 2, 0] = 0.5
    coeffs[0, 2, 3] = 0.05           # z: a cubic
    coeffs[1, 0, 0], coeffs[1, 2, 0] = 0.75, 0.6
    coeffs[1, 1, 2] = 0.2            # y: a parabola
    coeffs[1, 3, 1] = 0.1            # yaw rate
    n = demo.stream_trajectory(link, 1, np.array([1.5, 1.0]), coeffs,
                               params, rate_hz=100.0, sleep=clock.sleep,
                               now=clock.now)
    return link.calls, n


def mocap(demo):
    clock, link = FakeClock(), RecordingLink()
    fake = demo.FakeMocapBridge(link, 1, origin=(0.1, -0.2, 0.0),
                                sleep=clock.sleep)
    fake.run(10)
    poses = iter([(1.0, 2.0, 0.3), (1.0, 2.0, 0.3, 1.0, 0.0, 0.0, 0.0),
                  None, (0.5, 0.5, 0.5)])
    bridge = demo.MocapBridge(link, 2, pose_source=lambda: next(poses),
                              ekf_init_params=(10, 11, 12, 13),
                              sleep=clock.sleep)
    bridge.run(4)
    return link.calls, fake.published, bridge.published, clock.t


def teleop(demo):
    clock, link = FakeClock(), RecordingLink()
    axes = {"v": (0.5, -1.0, 0.25, 0.0)}
    buttons = {"v": {}}
    tele = demo.Teleop(link, 1, axes_source=lambda: axes["v"],
                       buttons_source=lambda: buttons["v"],
                       config=demo.TeleopAxisConfig(invert_pitch=True),
                       sleep=clock.sleep)
    tele.run(5)
    out = [tele.map_axes((1.5, -0.2, -1.0, 2.0))]
    for b in ({"takeoff": True}, {"land": True}, {}, {"emergency": True}):
        buttons["v"] = b
        out.append(tele.step())
    tele.run(3)                       # latched: stops at once
    return link.calls, out, tele.emergency_latched, clock.t


@pytest.mark.parametrize("scenario", [hover_plan, position, waypoints,
                                      mocap, teleop])
def test_demo_matches_jax_call_for_call(scenario):
    """The link calls (the sequencer: its published goals and each tick's
    result) and what the demo returns, equal."""
    got, want = scenario(tdemo), scenario(jdemo)
    if scenario is waypoints:
        assert got == want
        return
    assert_same_calls(got[0], want[0])
    assert got[1:] == want[1:]


def test_hover_demo_flight_plan_keeps_its_contract():
    """tests/test_demo.py's hover assertions on the port's log."""
    calls, z, _ = hover_plan(tdemo)
    hovers = [c for c in calls if c[0] == "send_hover"]
    assert hovers[0][1][4] == 0.0 and z == 0.0
    assert calls[-1][0] == "send_stop"


def test_full_state_stream_matches_jax():
    got, n = stream(tdemo, QuadrotorParams())
    want, jn = stream(jdemo, JParams())
    assert n == jn == pytest.approx(250, abs=2)
    assert_same_calls(got, want)
    mid = got[len(got) // 4][1]       # on the first piece: x = 0.5 t
    np.testing.assert_allclose(mid[2], [0.5, 0.0, 0.0], atol=0.2)


def test_two_vehicle_hover_matches_jax_per_vehicle():
    logs = []
    for demo, hover in ((tdemo, thover), (jdemo, jhover)):
        clock, link = FakeClock(), RecordingLink()
        demos = hover.run_two_vehicle_demo(link, vids=(1, 2),
                                           sleep=clock.sleep, now=clock.now)
        assert all(d.z_distance == 0.0 for d in demos)
        logs.append({v: [c for c in link.calls if c[1][0] == v]
                     for v in (1, 2)})
    for v in (1, 2):
        assert_same_calls(logs[0][v], logs[1][v])
        assert logs[0][v][-1][0] == "send_stop"


def test_exports_match_jax():
    names = [n for n in dir(jdemo) if not n.startswith("_")
             and not isinstance(getattr(jdemo, n), type(math))]
    assert names and all(hasattr(tdemo, n) for n in names)


def test_demos_against_real_link_and_firmware():
    """End to end: hover + position demos through the port's native link
    server into its firmware simulator, on ports the OS picks."""
    from crazyflie_nmpc_tpu_torch import native

    with native.FirmwareSim(0).serve() as fw, native.LinkServer() as server:
        server.add_vehicle(1, "127.0.0.1", fw.port, 0)
        fast = lambda dt: time.sleep(min(dt, 0.002))  # noqa: E731
        demo = tdemo.HoverDemo(server, 1, sleep=fast)
        demo.take_off(0.2)
        deadline = time.time() + 3.0
        while time.time() < deadline:
            sp = fw.last_generic_setpoint
            if sp and sp["type"] == "hover":
                break
            time.sleep(0.01)
        assert fw.last_generic_setpoint["type"] == "hover"

        tdemo.position_demo(server, 1, target=(0.0, 0.0, 0.4), sleep=fast,
                            kalman_reset_param=fw.param_ids[
                                "kalman/resetEstimation"])
        deadline = time.time() + 3.0
        while time.time() < deadline:
            sp = fw.last_generic_setpoint
            if sp and sp["type"] == "stop":
                break
            time.sleep(0.01)
        assert fw.last_generic_setpoint["type"] == "stop"
        assert fw.get_param("kalman/resetEstimation") == 0
