"""The port's copy of `native` vs the JAX package's, on the CPU.

The C++ sources are the same bytes and build into build/torch_native/;
every codec gives JAX's bytes; the link loops back through the port's
firmware simulator (setpoints, the param and log protocols) on ports the
OS picks; the vehicle plant (`hl_executor._CascadePlant`, one cascade
period on Python floats) equals the port's float64 `attitude_plant_step`
to 1e-12 and JAX's float32 `_cached_plant_step` to float32 rounding
(2e-6 relative); one period of `CascadeFirmwareSim` and a takeoff of
`FlyingFirmwareSim` against JAX's endpoints; and the plant costs at most
2 ms of host time a period.
"""

import filecmp
import struct
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import native as jnative
from crazyflie_nmpc_tpu.models import firmware as jfirmware
from crazyflie_nmpc_tpu.models.quadrotor import QuadrotorParams as JParams
from crazyflie_nmpc_tpu.native import hl_executor as jhl
from crazyflie_nmpc_tpu_torch import native
from crazyflie_nmpc_tpu_torch.models import QuadrotorParams, firmware
from crazyflie_nmpc_tpu_torch.native import bindings
from crazyflie_nmpc_tpu_torch.native.hl_executor import _CascadePlant
from _torch_shared import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PLANT_BAR_MS = 2.0


def test_sources_are_the_jax_packages_and_build_apart():
    for name in ("crtp.cc", "crtp.h", "link_server.cc", "ring.h"):
        assert filecmp.cmp(
            ROOT / "crazyflie_nmpc_tpu/native/src" / name,
            ROOT / "crazyflie_nmpc_tpu_torch/native/src" / name,
            shallow=False), name
    path = Path(native.build_library())
    assert path.parent == ROOT / "build" / "torch_native"
    assert path.name.startswith("libcfl-") and path.exists()
    assert native.build_library() == str(path)          # built once


def test_setpoint_codec_matches_jax():
    for args in ((2.5, -1.25, 30.0, 45000), (0.0, 0.0, 0.0, 0),
                 (-7.125, 3.5, -120.0, 60000)):
        buf = native.encode_setpoint(*args)
        assert buf == jnative.encode_setpoint(*args)
        assert native.decode_setpoint(buf) == jnative.decode_setpoint(buf)
    with pytest.raises(ValueError):
        native.decode_setpoint(b"\x00\x01")


def test_full_state_codec_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        args = (rng.uniform(-2, 2, 3), rng.uniform(-1, 1, 3),
                rng.uniform(-9, 9, 3), q, rng.uniform(-3, 3, 3))
        buf = native.encode_full_state(*args)
        assert buf == jnative.encode_full_state(*args)
        got, want = (native.decode_full_state(buf),
                     jnative.decode_full_state(buf))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_quaternion_and_log_codecs_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        q = rng.standard_normal(4).astype(np.float32)
        q /= np.linalg.norm(q)
        comp = native.quat_compress(q)
        assert comp == jnative.quat_compress(q)
        np.testing.assert_array_equal(native.quat_decompress(comp),
                                      jnative.quat_decompress(comp))
    for bid, ts, payload in ((7, 123456, struct.pack("<fff", 1, 2, 3)),
                             (0xE1, 0, b""), (3, 2**24 - 1, bytes(24))):
        assert (native.encode_log_data(bid, ts, payload)
                == jnative.encode_log_data(bid, ts, payload))


def _wait(pred, timeout=5.0, dt=0.005):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(dt)
    return pred()


@pytest.fixture
def link():
    """The port's firmware simulator serving on an OS-picked port behind
    the port's link server (its local port the OS's too)."""
    with native.FirmwareSim(0).serve() as fw, native.LinkServer() as srv:
        srv.add_vehicle(1, "127.0.0.1", fw.port, 0)
        yield fw, srv


def test_link_loopback(link):
    fw, srv = link
    assert fw.port > 0
    assert srv.send_setpoint(1, 1.0, -2.0, 3.0, 42000)
    assert _wait(lambda: fw.last_setpoint == (1.0, -2.0, 3.0, 42000))
    assert srv.send_position(1, 0.5, -0.5, 1.0, 0.0)
    assert _wait(lambda: (fw.last_generic_setpoint or {}).get("type")
                 == "position")
    st = srv.stats(1)
    assert st["sent"] >= 2 and st["dropped"] == 0


def test_param_and_log_protocols(link):
    fw, srv = link
    toc = srv.download_param_toc(1)
    assert set(toc) == set(fw.param_ids)
    pid = fw.param_ids["commander/enHighLevel"]
    assert srv.set_param(1, pid, 1, "uint8")
    assert _wait(lambda: fw.get_param("commander/enHighLevel") == 1)

    log_toc = srv.download_log_toc(1)
    assert set(log_toc) == set(fw.log_vars)
    fw.state_provider = {"gyro.x": 1.5, "gyro.y": -2.0,
                         "gyro.z": 0.25}.get
    ids = [log_toc[n][0] for n in ("gyro.x", "gyro.y", "gyro.z")]
    assert srv.log_create_block(1, 5, [(7, i) for i in ids])
    assert srv.log_start_block(1, 5, 1)

    def record():
        rec = srv.poll_log(1)
        return rec if rec is not None and rec["block_id"] == 5 else None

    rec = _wait(record)
    assert rec is not None
    assert struct.unpack("<fff", rec["payload"]) == (1.5, -2.0, 0.25)
    assert srv.log_stop_block(1, 5)


CASES = {"default": dict(), "lag": dict(kd_rate=0.002, tau_m=0.015)}


def _state(seed):
    rng = np.random.default_rng(seed)
    x = np.zeros(13)
    x[:3] = (0.1, -0.2, 0.5)
    x[3] = 1.0
    x += 0.05 * rng.standard_normal(13)
    x[3:7] /= np.linalg.norm(x[3:7])
    cmd = np.array([rng.uniform(-8, 8), rng.uniform(-8, 8),
                    rng.uniform(-40, 40), rng.uniform(30000, 50000)])
    return x, cmd


@pytest.mark.parametrize("case", sorted(CASES))
def test_plant_twin_matches_port_plant(case):
    """Three periods with the motor state threaded: x, the applied rotor
    speeds and the motor state equal the port's float64 plant to 1e-12."""
    gains = firmware.AttitudeGains(**CASES[case])
    params = QuadrotorParams()
    plant = _CascadePlant(params, gains, 0.015, 10)
    x, cmd = _state(3)
    motor = plant.init_motor(x)
    tx, tm = torch.as_tensor(x), None
    for _ in range(3):
        x, u, motor = plant.step(x, cmd, motor)
        tx, tu, tm = firmware.attitude_plant_step(
            params, tx, torch.as_tensor(cmd), 0.015, gains=gains, motor=tm)
        for got, want in ((x, tx), (u, tu), (motor[0], tm[0]),
                          (motor[1], tm[1])):
            np.testing.assert_allclose(np.asarray(got), want.numpy(),
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plant_twin_matches_jax_plant(case):
    """The same three periods against JAX's jitted float32 plant (the
    one its endpoints step): float32 rounding, 2e-6 relative."""
    jgains = jfirmware.AttitudeGains(**CASES[case])
    step = jhl._cached_plant_step(JParams(), jgains, 15, 10)
    plant = _CascadePlant(QuadrotorParams(),
                          firmware.AttitudeGains(**CASES[case]), 0.015, 10)
    x, cmd = _state(4)
    motor = plant.init_motor(x)
    jx = jnp.asarray(x, jnp.float32)
    jm = jfirmware.init_motor_state(JParams(), jx)
    for _ in range(3):
        x, u, motor = plant.step(x, cmd, motor)
        jx, ju, jm = step(jx, jnp.asarray(cmd, jnp.float32), jm)
        for got, want in ((x, jx), (u, ju), (motor[0], jm[0])):
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                np.asarray(got), want, rtol=0,
                atol=2e-6 * max(1.0, float(np.abs(want).max())))


def test_cascade_endpoint_matches_jax():
    """One armed period of each package's CascadeFirmwareSim under the
    same held setpoint, and the vehicle-side thrust-lock gate."""
    sp = (2.0, -1.5, 10.0, 45000.0)
    with native.CascadeFirmwareSim(0) as fw, \
            jnative.CascadeFirmwareSim(0) as jfw:
        fw.last_setpoint = jfw.last_setpoint = (0.0, 0.0, 0.0, 0.0)
        fw.poll(15)
        jfw.poll(15)
        assert not fw.flying and np.array_equal(fw.x, jfw.x)
        fw.last_setpoint = jfw.last_setpoint = sp
        for _ in range(2):
            fw.poll(15)
            jfw.poll(15)
        assert fw.flying and jfw.flying
        assert fw.plant_periods == 2 and fw.plant_s > 0.0
        np.testing.assert_allclose(fw.x, jfw.x, rtol=0, atol=2e-6)
        np.testing.assert_allclose(fw._log_value("motor.m2"),
                                   jfw._log_value("motor.m2"), rtol=2e-6)
        for name in ("stateEstimate.z", "stabilizer.roll", "gyro.y"):
            np.testing.assert_allclose(fw._log_value(name),
                                       jfw._log_value(name), rtol=1e-5,
                                       atol=1e-5)


def test_flying_endpoint_takeoff_matches_jax():
    """A takeoff command flown by each package's FlyingFirmwareSim (the
    planner, the position controller and the plant): the same flight to
    float32 rounding over 1 s."""
    cmd = {"cmd": "takeoff", "group": 0, "height": 0.5, "yaw": 0.0,
           "use_current_yaw": True, "duration": 1.0}
    with native.FlyingFirmwareSim(0) as fw, \
            jnative.FlyingFirmwareSim(0) as jfw:
        for sim in (fw, jfw):
            sim.hl_commands.append(dict(cmd))
            for _ in range(67):
                sim.poll(15)
        assert len(fw.flown) == len(jfw.flown) > 60
        np.testing.assert_allclose(fw.x, jfw.x, rtol=0, atol=1e-4)
        assert abs(fw.x[2] - 0.5) < 0.05


def test_plant_costs_at_most_2_ms_a_period():
    """Host time of the endpoint's plant over 20 periods (best of three
    runs, so a loaded host does not decide it): at most 2 ms a period,
    against 25 ms for the tensor plant stepped per call."""
    plant = _CascadePlant(QuadrotorParams(), firmware.AttitudeGains(),
                          0.015, 10)
    x, cmd = _state(5)
    motor = plant.init_motor(x)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(20):
            x, _, motor = plant.step(x, cmd, motor)
        best = min(best, (time.perf_counter() - t0) / 20 * 1e3)
    assert best <= PLANT_BAR_MS, best


def test_library_builds_under_a_lock_to_a_temporary_name(monkeypatch,
                                                         tmp_path):
    """A forced build writes a temporary file and renames it into place
    under the lock; a second call reuses the library."""
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path)
    path = Path(bindings.build_library())
    assert path.parent == tmp_path and path.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [".lock",
                                                         path.name]
    assert bindings.build_library() == str(path)
