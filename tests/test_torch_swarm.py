"""Swarm serving (`runtime.swarm`, `bringup.swarm_serving`) on the CPU.

`SwarmNMPC.step` on seeded telemetry at B=5, float32, N=16 (15 ms
stages), the default certified configuration, held against the JAX
package's `SwarmNMPC(use_fused=False)` (jitted once) on both port paths,
to JAX's own cross-path bar (tests/test_swarm_serving.py:150-157: cmd
angles 0.02 deg, thrust 1e-3 relative, u_apply 1e-3 relative + 5e-3);
measured: per-lane 1e-5 deg / 4e-7 relative / 1e-5 kRPM, batched 2e-4
deg / 2e-6 relative / 2e-4 kRPM, float32 rounding.  `grid_targets`
against JAX's.  The telemetry plane's two repairs on a fake link (no
solver): a row never updated counts as stale (R2) and a lockstep tick
waits for all three blocks (R3); each test fails on the JAX package's
logic.  A 2-vehicle lockstep run over the real wire, and the realtime
discipline at 2 Hz (a rate a loaded CPU holds at N=8 without the delay
predictor: a tick took 130-200 ms alone and 440-580 ms at 4 Hz beside
the two endpoints' serve threads, which poll every millisecond);
convergence is the card's phase (chip_smoke.py [swarm_wire]).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.runtime import swarm as jswarm
from crazyflie_nmpc_tpu.solver import default_ocp as jdefault_ocp
from crazyflie_nmpc_tpu_torch import bringup, convert, native
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime import swarm as tswarm
from crazyflie_nmpc_tpu_torch.solver import default_ocp
from _torch_shared import one_torch_thread  # noqa: F401

N, B = 16, 5
JAX_BAR = dict(angle_atol=0.02, thrust_rtol=1e-3, u_rtol=1e-3, u_atol=5e-3)


@pytest.fixture(scope="module")
def telemetry():
    """Seeded telemetry of 5 vehicles near their formation slots."""
    targets = tswarm.grid_targets(B, spacing=0.5, z=0.4)
    rng = np.random.default_rng(7)
    x0s = 0.05 * rng.standard_normal((B, 13))
    x0s[:, :3] += targets * np.array([1.0, 1.0, 0.2])
    x0s[:, 3] = 1.0
    euler = 5.0 * rng.standard_normal((B, 3))
    gyro = 10.0 * rng.standard_normal((B, 3))
    return targets, x0s, x0s[:, :3].copy(), euler, gyro


@pytest.fixture(scope="module")
def jax_step(telemetry):
    targets, x0s, mocap, euler, gyro = telemetry
    js = jdefault_ocp(N=N, tf=0.015 * N, dtype=jnp.float32)
    sw = jswarm.SwarmNMPC(js, targets, use_fused=False)
    sw.reset(x0s)
    return js, sw.step(mocap, euler, gyro)


@pytest.mark.parametrize("use_fused", [False, None],
                         ids=["per_lane", "batched"])
def test_swarm_step_matches_jax(telemetry, jax_step, use_fused):
    targets, x0s, mocap, euler, gyro = telemetry
    js, (jcmd, ju) = jax_step
    spec = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                   device="cpu", dtype=torch.float32)
    sw = tswarm.SwarmNMPC(spec, targets, use_fused=use_fused, device="cpu")
    assert sw.ipm_config.escalate_iters == 32
    sw.reset(x0s)
    kc.reset_launch_counts()
    cmd, u = sw.step(mocap, euler, gyro)
    assert kc.launch_counts() == dict.fromkeys(kc.KERNELS, 0)
    assert cmd.shape == (B, 4) and u.shape == (B, 4)
    np.testing.assert_allclose(cmd[:, :3], jcmd[:, :3], rtol=0,
                               atol=JAX_BAR["angle_atol"])
    np.testing.assert_allclose(cmd[:, 3], jcmd[:, 3],
                               rtol=JAX_BAR["thrust_rtol"])
    np.testing.assert_allclose(u, ju, rtol=JAX_BAR["u_rtol"],
                               atol=JAX_BAR["u_atol"])


def test_grid_targets_match_jax():
    for n, spacing, z in ((8, 0.5, 0.4), (16, 0.6, 0.4), (3, 1.0, 1.2)):
        np.testing.assert_array_equal(tswarm.grid_targets(n, spacing, z),
                                      jswarm.grid_targets(n, spacing, z))
    t = tswarm.grid_targets(8, spacing=0.5, z=0.4)
    assert np.allclose(t[:, :2].mean(axis=0), 0.0, atol=1e-12)
    assert len({tuple(r) for r in np.round(t, 9).tolist()}) == 8


# ---- the telemetry plane on a fake link ---------------------------------

class FakeServer:
    """The LinkServer calls serve_swarm makes.  A vehicle's record of
    block `bid` becomes visible `delay[bid]` poll_log sweeps after it was
    sent (0: at once)."""

    def __init__(self, delay):
        self.delay = delay
        self.queues = {}
        self.sent = {}

    def log_create_block(self, vid, bid, variables):
        return True

    def log_start_block(self, vid, bid, period):
        return True

    def push(self, vid, bid, values):
        import struct

        self.queues.setdefault(vid, []).append(
            [self.delay.get(bid, 0), dict(block_id=bid, timestamp_ms=0,
                                          payload=struct.pack("<fff",
                                                              *values))])

    def poll_log(self, vid):
        q = self.queues.get(vid, [])
        for item in q:
            if item[0] <= 0:
                q.remove(item)
                return item[1]
        for item in q:          # one sweep done: the late ones age
            item[0] -= 1
        return None

    def send_setpoint(self, vid, *cmd):
        self.sent[vid] = cmd


class FakeVehicle:
    """Streams its three blocks each poll that advances time: position
    (0, 0, tick), Euler angles (tick, 0, 0), gyro (0, tick, 0), unless
    `silent`."""

    log_vars = {n: (i, 7) for i, n in enumerate(
        [n for names in tswarm._TelemetryPlane.BLOCKS.values()
         for n in names])}

    def __init__(self, server, vid, silent=False):
        self.server, self.vid, self.silent = server, vid, silent
        self.x = np.zeros(13)
        self.x[3] = 1.0
        self.tick = 0

    def poll(self, dt_ms):
        if not dt_ms:
            return
        if not self.silent:
            t = float(self.tick)
            self.server.push(self.vid, 1, (0.0, 0.0, t))
            self.server.push(self.vid, 2, (t, 0.0, 0.0))
            self.server.push(self.vid, 3, (0.0, t, 0.0))
        self.tick += 1


class FakeSwarm:
    """Records the telemetry each tick's step consumed."""

    def __init__(self, n):
        self.targets = np.zeros((n, 3))
        self.seen = []

    def reset(self, x0s):
        pass

    def step(self, mocap, euler, gyro):
        self.seen.append((mocap.copy(), euler.copy(), gyro.copy()))
        n = len(mocap)
        return np.zeros((n, 4)), np.zeros((n, 4))


def _fake_run(delay, silent=(), ticks=6, settle=0.05):
    server = FakeServer(delay)
    fws = [FakeVehicle(server, vid, vid in silent) for vid in (1, 2)]
    swarm = FakeSwarm(2)
    rep = tswarm.serve_swarm(None, server, [1, 2], fws, swarm, ticks,
                             wire_settle_s=settle)
    return rep, swarm.seen[1:]          # the first step is the warm-up


def test_lockstep_tick_waits_for_every_block():
    """R3: the attitude and rate blocks cross two sweeps after the
    position block.  Every tick fuses that tick's three blocks, never the
    previous tick's attitude (the JAX package settles on the position
    block alone)."""
    rep, seen = _fake_run({2: 2, 3: 2})
    for k, (mocap, euler, gyro) in enumerate(seen):
        assert (mocap[:, 2] == k).all()
        assert (euler[:, 0] == k).all(), (k, euler[:, 0])
        assert (gyro[:, 1] == k).all()
    assert (rep.staleness == 0).all()


def test_row_never_updated_is_stale():
    """R2: a vehicle whose telemetry never arrives is stale from tick 0
    on (the JAX package reads its zero rows as fresh)."""
    rep, _ = _fake_run({}, silent=(2,), ticks=4, settle=0.01)
    assert (rep.staleness[:, 0] == 0).all()
    assert rep.staleness[:, 1].tolist() == [1, 2, 3, 4]
    assert rep.summary()["stale_ticks"] == 4


def test_a_late_block_counts_as_stale():
    """One block that stops arriving makes its vehicle stale, whichever
    block it is."""
    rep, _ = _fake_run({3: 10 ** 6}, ticks=3, settle=0.01)
    assert rep.staleness.tolist() == [[1, 1], [2, 2], [3, 3]]


# ---- over the wire --------------------------------------------------------

def test_lockstep_wire_run():
    """2 vehicles from the ground toward their slots for 10 lockstep
    ticks over the real link (UDP/CRTP both ways, ports the OS picks):
    every row fresh from tick 1, both vehicles armed by the streamed
    commands, commands and positions finite, per-vehicle accounting."""
    spec = default_ocp(N=N, tf=0.015 * N, dtype=torch.float32,
                       device="cpu")
    out = bringup.swarm_serving(n=2, ticks=10, base_port=0, device="cpu",
                                spec=spec)
    rep = out["report"]
    assert rep.latency_s.shape == (10, 2)
    assert np.isfinite(rep.latency_s).all()
    assert (rep.staleness[1:] == 0).all()
    assert np.isfinite(rep.positions).all()
    assert all(out["armed"])
    assert all(np.isfinite(sp).all() and sp[3] > 1000.0
               for sp in out["last_setpoints"])
    assert [s["received"] > 0 for s in out["link_stats"]] == [True, True]
    assert rep.deadline_misses(rep.period_s).shape == (2,)
    assert 0.0 < out["plant_ms_per_period"] < 2.0


def test_realtime_discipline():
    """lockstep=False at 2 Hz, N=8, IPMConfig(iters=4), no delay
    prediction: the endpoints serve real time in their threads, the host
    loop keeps the TickScheduler.  Bars of the JAX package's realtime
    test, scaled to 12 ticks: accounting populated, telemetry live (stale
    <= 3 on 80% of the last 5 ticks), fewer slips than half the ticks;
    here also both vehicles armed."""
    n, rate_hz, ticks = 2, 2.0, 12
    spec = default_ocp(N=8, tf=0.12, dtype=torch.float32, device="cpu")
    targets = np.array([[0.0, 0.0, 0.4], [0.6, 0.0, 0.4]])
    swarm = tswarm.SwarmNMPC(spec, targets, tick_dt=1.0 / rate_hz,
                             ipm_config=IPMConfig(iters=4), delay_steps=0,
                             device="cpu")
    with contextlib.ExitStack() as stack:
        fws = []
        for i in range(n):
            fw = stack.enter_context(native.CascadeFirmwareSim(
                0, x0=(targets[i, 0], targets[i, 1], 0.03)))
            fw.serve()
            fws.append(fw)
        server = stack.enter_context(native.LinkServer())
        for i, fw in enumerate(fws):
            server.add_vehicle(i + 1, "127.0.0.1", fw.port, 0)
        rep = tswarm.serve_swarm(spec, server, [1, 2], fws, swarm, ticks,
                                 rate_hz=rate_hz, lockstep=False)
        armed = [fw.flying for fw in fws]
    assert rep.latency_s.shape == (ticks, n)
    assert np.isfinite(rep.latency_s).all()
    assert (rep.staleness[-5:] <= 3).mean() > 0.8
    assert rep.schedule_slips < ticks // 2
    assert all(armed)


class SlowSwarm(FakeSwarm):
    """A host whose solve takes `delay` s and commands hover thrust."""

    def __init__(self, n, delay):
        super().__init__(n)
        self.delay = delay

    def step(self, mocap, euler, gyro):
        import time

        time.sleep(self.delay)
        cmd = np.zeros((len(mocap), 4))
        cmd[:, 3] = 40000.0
        return cmd, np.zeros((len(mocap), 4))


def test_setpoints_land_behind_a_slow_solve():
    """Lockstep with a 0.6 s solve over the real link: the link's 1 ms
    keep-alive pings fill each vehicle's receive buffer meanwhile, and
    the setpoints sent after the solve still arrive (the vehicles arm),
    because the tick drains the buffer first."""
    with contextlib.ExitStack() as stack:
        fws = [stack.enter_context(native.CascadeFirmwareSim(0))
               for _ in range(2)]
        server = stack.enter_context(native.LinkServer())
        for i, fw in enumerate(fws):
            server.add_vehicle(i + 1, "127.0.0.1", fw.port, 0)
        tswarm.serve_swarm(None, server, [1, 2], fws, SlowSwarm(2, 0.6), 3)
        assert [fw.flying for fw in fws] == [True, True]
        assert [fw.last_setpoint[3] for fw in fws] == [40000, 40000]
