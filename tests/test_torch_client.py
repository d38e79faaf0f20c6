"""The port's `MissionClient` against the JAX package's, float64 on the
CPU, N=10 stages of 15 ms: the same sequence of services on both clients
(takeoff, a few ticks, go_to from a given and from the held set-point,
hover_at, land,
two uploaded polynomial trajectories started with a timescale and
reversed, a 17-column file, stop), every tick's (yref, yref_e) to 1e-12
and the mode after it exactly; `done` once a trajectory is consumed.
The polynomial pieces are made in the test from a seed; the file is
written by `save_traj_txt`.  The host reads (`mode`, `done`, `go_to`
without `from_pos`) are counted by reason."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.runtime.client import MissionClient as JClient
from crazyflie_nmpc_tpu.solver import default_ocp as jdefault_ocp
from crazyflie_nmpc_tpu.solver import policies as jpol
from crazyflie_nmpc_tpu_torch import convert, device
from crazyflie_nmpc_tpu_torch.runtime.client import MissionClient
from crazyflie_nmpc_tpu_torch.utils import save_traj_txt
from _torch_shared import one_torch_thread  # noqa: F401

N = 10
TOL = 1e-12


@pytest.fixture(scope="module")
def clients():
    js = jdefault_ocp(N=N, tf=0.015 * N, dtype=jnp.float64)
    ts = convert.spec_from_numpy(convert.leaves_from_spec(js), N,
                                 device="cpu", dtype=torch.float64)
    return js, ts


def _poly_pieces(seed, n_pieces=2):
    """Piecewise degree-7 polynomials (x, y, z, yaw): a slow climb plus
    small seeded wiggles, so thrust stays positive."""
    rng = np.random.default_rng(seed)
    durations = np.array([0.4, 0.35][:n_pieces])
    coeffs = 0.02 * rng.standard_normal((n_pieces, 4, 8))
    coeffs[:, 2, 0] += 0.5
    coeffs[:, :, 4:] *= 0.1
    return durations, coeffs


def _same(tc, jc, tag, ticks=3):
    for k in range(ticks):
        y, ye = tc.tick()
        jy, jye = jc.tick()
        for got, want, part in ((y, jy, "yref"), (ye, jye, "yref_e")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{tag} tick {k} {part}")
        assert tc.mode == jc.mode, f"{tag} tick {k}"


def test_services_match_jax(clients, tmp_path):
    js, ts = clients
    tc, jc = MissionClient(ts), JClient(js)
    assert tc.mode == jc.mode == jpol.REGULATION
    _same(tc, jc, "initial regulation", 2)

    tc.takeoff(0.5, 0.3, at=(0.1, -0.2, 0.0))
    jc.takeoff(0.5, 0.3, at=(0.1, -0.2, 0.0))
    assert tc.mode == jpol.TRACKING
    _same(tc, jc, "takeoff", 12)          # past the end: Position_Hold
    assert tc.done and jc.done

    tc.go_to((0.3, 0.1, 0.6), from_pos=(0.1, -0.2, 0.5), duration=0.4)
    jc.go_to((0.3, 0.1, 0.6), from_pos=(0.1, -0.2, 0.5), duration=0.4)
    _same(tc, jc, "go_to from_pos", 2)
    assert not tc.done

    tc.hover_at((0.2, 0.2, 0.7))
    jc.hover_at((0.2, 0.2, 0.7))
    _same(tc, jc, "hover_at", 2)
    tc.go_to((0.0, 0.0, 0.4), duration=0.3)   # from the held set-point
    jc.go_to((0.0, 0.0, 0.4), duration=0.3)
    _same(tc, jc, "go_to from the set-point")

    tc.land((0.0, 0.0, 0.4), duration=0.3)
    jc.land((0.0, 0.0, 0.4), duration=0.3)
    _same(tc, jc, "land")

    for tid, seed in ((3, 1), (7, 2)):
        durations, coeffs = _poly_pieces(seed)
        tc.upload_trajectory(tid, durations, coeffs)
        jc.upload_trajectory(tid, durations, coeffs)
    for tid, kw in ((3, {}), (7, dict(timescale=1.5, reversed=True))):
        tc.start_trajectory(tid, **kw)
        jc.start_trajectory(tid, **kw)
        _same(tc, jc, f"start_trajectory {tid} {kw}")

    path = tmp_path / "traj.txt"
    table = np.array(ts.params.hover_speed()) * np.ones((14, 17))
    table[:, :13] = 0.0
    table[:, 3] = 1.0
    table[:, 0] = np.linspace(0.0, 0.3, 14)
    table[:, 2] = 0.5 + 0.1234567891 * np.linspace(0.0, 1.0, 14)
    save_traj_txt(str(path), table)
    tc.track_file(str(path))
    jc.track_file(str(path))
    _same(tc, jc, "track_file", 6)

    tc.stop()
    jc.stop()
    assert tc.mode == jpol.REGULATION
    _same(tc, jc, "stop", 2)


def test_host_reads_are_counted(clients):
    _, ts = clients
    device.reset_host_syncs()
    tc = MissionClient(ts)
    tc.takeoff(0.5, 0.3)
    for _ in range(3):
        tc.tick()
    assert tc.mode == jpol.TRACKING and not tc.done
    tc.hover_at((0.0, 0.0, 0.5))
    tc.go_to((0.1, 0.0, 0.5), duration=0.3)
    tc.stop()
    assert device.host_syncs() == {"client tick length": 1,
                                   "client mode": 1, "client done": 1,
                                   "client set-point": 1}
