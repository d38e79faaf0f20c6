"""The port's bringup compositions (`crazyflie_nmpc_tpu_torch.bringup`) on
the CPU: `tests/test_bringup.py`'s cases and bars on `device="cpu"` and
ports the OS picks (port 0), plus parity with the JAX package.

- `nmpc_attitude_bench`'s cmd_vel log (40 ticks, N=50, float32) against
  the JAX package's `rti_step` + `to_cmd_vel` on the same constant state
  (the bench's own loop without the socket): within 1e-3 deg and 1 PWM.
- `nmpc_predictor(steps=3)` under both actuations equals the port's
  direct `flight_configuration` / `estimator_in_the_loop` call bitwise.
- `pid_waypoints(max_steps=0)` runs no tick and reports steps 0, not
  completed (the JAX package's raises there: `max()` of no visited
  waypoint, and `alive` and `k` are unbound).
- The compositions that hold tensors raise without a GPU when given no
  device, and `main` runs a composition and prints the device it used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import bringup as jbringup
from crazyflie_nmpc_tpu_torch import bringup
from _torch_shared import one_torch_thread  # noqa: F401

BENCH_TICKS = 40
ANGLE_TOL_DEG = 1e-3
PWM_TOL = 1


def test_registry_matches_jax():
    assert set(bringup.BRINGUPS) == set(jbringup.BRINGUPS)
    assert set(bringup.DEVICE_BRINGUPS) <= set(bringup.BRINGUPS)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """One bench run of BENCH_TICKS ticks recording its bag."""
    bag_path = str(tmp_path_factory.mktemp("afl") / "afl.bag")
    return bringup.nmpc_attitude_bench(steps=BENCH_TICKS, port=0,
                                       bag_path=bag_path,
                                       device="cpu"), bag_path


def test_nmpc_attitude_bench(bench):
    out, _ = bench
    # fake mocap kept publishing, the device saw cmd_vel setpoints, and the
    # hover-at-origin solution commands ~level attitude + hover thrust
    assert out["mocap_published"] == BENCH_TICKS
    assert out["device_setpoint"] is not None
    cmd = out["cmd_vel"]
    assert cmd.shape == (BENCH_TICKS, 4)
    assert np.abs(cmd[-1, 0]) < 1.0 and np.abs(cmd[-1, 1]) < 1.0  # deg
    assert 30000 < cmd[-1, 3] < 60000  # hover-ish PWM


def test_bag_record_and_play(bench):
    """crazy_AFL's rosbag-record side channel + bag_play replay."""
    _, bag_path = bench
    played = bringup.bag_play(bag_path)
    assert played["events_replayed"] == BENCH_TICKS
    assert played["summary"]["cmd_vel"]["count"] == BENCH_TICKS
    assert abs(played["summary"]["cmd_vel"]["rate_hz"] - 1 / 0.015) < 1.0


def test_attitude_bench_cmd_vel_matches_jax(bench):
    from crazyflie_nmpc_tpu.models import hover_state
    from crazyflie_nmpc_tpu.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu.solver import (default_ocp, hover_yref,
                                           init_rti, rti_step, to_cmd_vel)

    spec = default_ocp(dtype=jnp.float32)
    yref, yref_e = hover_yref(spec, pos=(0.0, 0.0, 0.0))

    @jax.jit
    def step(s, x):
        s, out = rti_step(spec, s, x, yref, yref_e, IPMConfig(iters=8))
        cmd = to_cmd_vel(out.u1, out.x_at(4))
        return s, jnp.stack([cmd.roll_deg, cmd.pitch_deg, cmd.yawrate_deg,
                             cmd.thrust_pwm])

    x_hat = hover_state(spec.params, dtype=jnp.float32)
    rti = init_rti(spec, x_hat)
    want = []
    for _ in range(BENCH_TICKS):
        rti, c = step(rti, x_hat)
        c = np.asarray(c)
        want.append((*c[:3], int(c[3])))
    want = np.asarray(want)
    got = bench[0]["cmd_vel"]
    assert np.abs(got[:, :3] - want[:, :3]).max() <= ANGLE_TOL_DEG
    assert np.abs(got[:, 3] - want[:, 3]).max() <= PWM_TOL


@pytest.mark.parametrize("actuation", ["cmd_vel", "rotor"])
def test_nmpc_predictor_is_the_direct_loop(actuation):
    from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
    from crazyflie_nmpc_tpu_torch.runtime import (LoopConfig,
                                                  estimator_in_the_loop,
                                                  flight_configuration)
    from crazyflie_nmpc_tpu_torch.solver import default_ocp, policies
    from crazyflie_nmpc_tpu_torch.utils import helix_trajectory

    out = bringup.nmpc_predictor(steps=3, actuation=actuation,
                                 device="cpu")
    spec = default_ocp(dtype=torch.float64, device="cpu")
    table = helix_trajectory(spec.params, dtype=torch.float64, device="cpu")
    cfg = LoopConfig(ipm=IPMConfig(iters=8))
    if actuation == "cmd_vel":
        res = flight_configuration(spec, table, steps=3, delay_steps=4,
                                   config=cfg)
    else:
        res = estimator_in_the_loop(
            spec, table[0, :13], steps=3, delay_steps=4, config=cfg,
            policy_state=policies.tracking_state(device="cpu"),
            traj_table=table)
    assert out["delay_steps"] == 4 and out["actuation"] == actuation
    for f in res._fields:
        assert torch.equal(getattr(out["result"], f), getattr(res, f)), f
    assert np.isfinite(out["tracking_err_max"]) and np.isfinite(
        out["kkt_max"])


def test_nmpc_predictor_refuses_an_unknown_actuation():
    with pytest.raises(ValueError, match="actuation"):
        bringup.nmpc_predictor(steps=1, actuation="thrust", device="cpu")


def test_pid_waypoints_completes():
    out = bringup.pid_waypoints(max_steps=4000, device="cpu")
    assert out["completed"], out
    assert out["waypoints_reached"] == out["n_goals"]
    assert out["final_z"] > 0.4
    assert 0 < out["steps"] < 4000


def test_pid_waypoints_with_no_tick():
    """R9: the JAX package's composition raises here."""
    with pytest.raises((ValueError, UnboundLocalError)):
        jbringup.pid_waypoints(max_steps=0)
    out = bringup.pid_waypoints(max_steps=0, device="cpu")
    assert out["steps"] == 0 and not out["completed"]
    assert out["waypoints_reached"] == 0 and out["final_z"] == 0.0


def test_system_identification_capture():
    out = bringup.system_identification(steps=60, port=0, device="cpu")
    assert out["rows"] >= 60
    meas = out["measurements"]
    assert meas.shape[1] == 13
    # hovering plant: z stays near start, quaternion ~ identity
    assert abs(meas[-1, 3] - 1.0) < 0.05   # qw
    assert np.all(np.isfinite(meas))


def test_hover_and_position_and_teleop_bringups():
    out = bringup.hover_demo(port=0)
    assert out["final_setpoint"]["type"] == "stop"
    out = bringup.position_demo(port=0)
    assert out["final_setpoint"]["type"] == "stop"
    assert out["setpoints_sent"] > 30
    out = bringup.teleop(ticks=30, port=0)
    sp = out["device_setpoint"]
    assert sp is not None
    roll, pitch, yawrate, thrust = sp
    assert roll == pytest.approx(3.0) and pitch == pytest.approx(-3.0)
    assert thrust == 36000


def test_multi_hover_two_vehicles():
    out = bringup.multi_hover(n=2, base_port=0)
    assert out["vehicles"] == 2 and out["landed"]
    assert all(s["sent"] > 0 for s in out["stats"])


def test_thrust_identification_capture():
    """thrust_identification.launch + const_thrust.py: constant cmd_vel
    thrust streamed at 50 Hz, motor PWM echo logged at 10 ms."""
    out = bringup.thrust_identification(steps=30, port=0, thrust_pwm=12000)
    assert out["rows"] >= 10
    assert np.allclose(out["motor_pwm"], 12000.0)
    # pwm2krpm inverts the krpm2pwm map (acados_mpc.cpp:421-425)
    assert out["implied_krpm"] == pytest.approx(
        (12000 * 0.2685 + 4070.3) / 1000.0, rel=1e-6)


def test_high_level_mission_script():
    """test_high_level.py flown: param setup + takeoff / uploaded-poly
    startTrajectory / land / stop over the wire, the vehicle side
    executing each command through the cascade."""
    out = bringup.high_level_mission(port=0)
    cmds = [c["cmd"] for c in out["hl_commands"]]
    assert cmds[0] == "define_trajectory"
    assert [c for c in cmds if c != "define_trajectory"][:4] == [
        "takeoff", "start_trajectory", "land", "stop"]
    assert out["wire_ok"]
    tk = next(c for c in out["hl_commands"] if c["cmd"] == "takeoff")
    assert tk["height"] == pytest.approx(0.5)
    assert out["params"] == {"commander/enHighLevel": 1,
                             "stabilizer/estimator": 2,
                             "stabilizer/controller": 2,
                             "kalman/resetEstimation": 1}
    assert out["flown_ticks"] > 400
    assert out["max_tracking_err_m"] is not None
    assert out["max_tracking_err_m"] < 0.15
    assert out["landed"]
    assert abs(out["final_pos"][2]) < 0.08
    assert abs(out["final_pos"][0]) < 0.1 and abs(out["final_pos"][1]) < 0.1


def test_session_runs_panes_concurrently():
    """The tmux-workbench equivalent: two compositions side by side, each
    on its own pane thread, both results collected; then a crashing pane
    is isolated (tmux semantics)."""
    out = bringup.session({
        "telemetry": ("telemetry", 0.6, 0),
        "teleop": ("teleop", 20, 0),
    })
    assert set(out) == {"telemetry", "teleop"}
    for pane, res in out.items():
        assert not isinstance(res, Exception), (pane, res)
    assert out["telemetry"]["records"]
    assert out["teleop"]["device_setpoint"] is not None

    out = bringup.session({
        "bad": ("bag_play", "/nonexistent/no.bag"),
        "ok": ("teleop", 10, 0),
    })
    assert isinstance(out["bad"], Exception)
    assert out["ok"]["device_setpoint"] is not None


@pytest.mark.parametrize("name", bringup.DEVICE_BRINGUPS)
def test_device_none_needs_a_gpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bringup.BRINGUPS[name]()


def test_main_runs_a_composition_and_names_its_device(capsys):
    assert bringup.main(["pid_waypoints", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "completed: True" in lines and lines[-1] == "device: cpu"
