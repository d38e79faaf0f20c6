"""Trajectory tooling (`utils.trajectories`) vs the JAX package's, float64
on the CPU: the helix and smooth-step generators, the flatness map, the
piecewise-polynomial evaluation and sampling, the poly4d wire codec, and
the text/CSV loaders on files these tests write.  Tolerance 1e-12
relative to max(1, max |JAX|).  No reference trajectory file is read.
"""

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import QuadrotorParams as JParams
from crazyflie_nmpc_tpu.utils import trajectories as jtr
from crazyflie_nmpc_tpu_torch.models import QuadrotorParams
from crazyflie_nmpc_tpu_torch.utils import trajectories as ttr
from _torch_shared import one_torch_thread  # noqa: F401

TOL = 1e-12
JP, TP = JParams(), QuadrotorParams()


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def poly():
    """Three pieces of random 7th-order polynomials (x, y, z, yaw)."""
    rng = np.random.default_rng(9)
    durations = np.array([0.8, 1.1, 0.6])
    coeffs = 0.3 * rng.standard_normal((3, 4, 8)) / np.arange(1, 9) ** 2
    coeffs[:, 2, 0] += 0.5          # altitude
    return durations, coeffs


@pytest.mark.parametrize("kw", [
    {}, dict(radius=0.5, z0=0.2, z1=0.6, turns=1.0, duration=4.5,
             center=(0.1, -0.2))], ids=["default", "custom"])
def test_helix_trajectory_matches_jax(kw):
    want = jtr.helix_trajectory(JP, **kw)
    got = ttr.helix_trajectory(TP, device="cpu", **kw)
    _close(got, want, "helix")
    assert got.dtype == torch.float64


@pytest.mark.parametrize("kw", [
    {}, dict(start=(0.0, 0.0, 0.2), end=(0.4, -0.3, 1.0), duration=3.0)],
    ids=["default", "custom"])
def test_smooth_step_trajectory_matches_jax(kw):
    _close(ttr.smooth_step_trajectory(TP, device="cpu", **kw),
           jtr.smooth_step_trajectory(JP, **kw), "smooth_step")


def test_eval_flat_outputs_and_flat_to_state_match_jax(poly):
    """Single times across the pieces, past both ends (clamped), and the
    vectorized evaluation of all of them at once."""
    durations, coeffs = poly
    times = [-0.1, 0.3, 0.8, 1.2, 1.9, 2.5]
    many = ttr.eval_flat_outputs(durations, coeffs,
                                 torch.tensor(times, dtype=torch.float64))
    for i, t in enumerate(times):
        jf = jtr.eval_flat_outputs(durations, coeffs, t)
        tf = ttr.eval_flat_outputs(durations, coeffs,
                                   torch.tensor(t, dtype=torch.float64))
        for k in jf:
            _close(tf[k], jf[k], f"t={t} {k}")
            _close(many[k][i], jf[k], f"t={t} {k} vectorized")
        jx, ju = jtr.flat_to_state(jf, JP)
        tx, tu = ttr.flat_to_state(tf, TP)
        _close(tx, jx, f"t={t} x")
        _close(tu, ju, f"t={t} u")


def test_sample_poly_trajectory_matches_jax(poly):
    durations, coeffs = poly
    _close(ttr.sample_poly_trajectory(durations, coeffs, TP, device="cpu"),
           jtr.sample_poly_trajectory(durations, coeffs, JP), "sampled")


def test_poly4d_round_trip_matches_jax(poly):
    durations, coeffs = poly
    blob = ttr.encode_poly4d(durations, coeffs)
    assert blob == jtr.encode_poly4d(durations, coeffs)
    assert len(blob) == 132 * len(durations)
    d2, c2 = ttr.decode_poly4d(blob, len(durations))
    jd, jc = jtr.decode_poly4d(blob, len(durations))
    np.testing.assert_array_equal(d2, jd)
    np.testing.assert_array_equal(c2, jc)
    np.testing.assert_allclose(c2, coeffs, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="too short"):
        ttr.decode_poly4d(blob[:-1], len(durations))


def test_traj_txt_save_and_load(tmp_path):
    """A table saved by the port loads the same through both packages;
    a file with the wrong column count is refused, as in JAX."""
    table = ttr.helix_trajectory(TP, duration=0.3, device="cpu")
    path = tmp_path / "helix.txt"
    ttr.save_traj_txt(str(path), table)
    got = ttr.load_traj_txt(str(path))
    np.testing.assert_array_equal(got, jtr.load_traj_txt(str(path)))
    np.testing.assert_allclose(got, table.numpy(), atol=5e-7)
    one = tmp_path / "one.txt"
    jtr.save_traj_txt(str(one), np.asarray(table[:1]))
    assert ttr.load_traj_txt(str(one)).shape == (1, 17)
    bad = tmp_path / "bad.txt"
    np.savetxt(bad, np.zeros((3, 16)))
    with pytest.raises(ValueError, match="expected 17 columns"):
        ttr.load_traj_txt(str(bad))


def test_poly_csv_load(tmp_path, poly):
    """A figure8.csv-style file (header, duration + 32 coefficients per
    row) loads the same through both packages."""
    durations, coeffs = poly
    rows = np.concatenate([durations[:, None], coeffs.reshape(3, 32)], 1)
    path = tmp_path / "poly.csv"
    header = "duration," + ",".join(f"{a}^{i}" for a in "xyzw"
                                    for i in range(8))
    np.savetxt(path, rows, delimiter=",", header=header, comments="")
    d, c = ttr.load_poly_csv(str(path))
    jd, jc = jtr.load_poly_csv(str(path))
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(c, coeffs, rtol=1e-15)
