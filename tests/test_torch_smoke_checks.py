"""The checks of `chip_smoke.py`'s closed-loop phases ([swarm],
[closed_loop], [flight]) on CPU tensors at N=10: each passes on a real
run of the port's loops and fails on a planted fault (a kernel launched
once too few times, a u_cmd shifted by 1e-3, one non-finite or one
stray lane, a tracking error over its bar)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from crazyflie_nmpc_tpu_torch.ops import cuda as kc
from crazyflie_nmpc_tpu_torch.ops.ipm import IPMConfig
from crazyflie_nmpc_tpu_torch.runtime.batch import monte_carlo_hover
from crazyflie_nmpc_tpu_torch.solver import default_ocp

N = 10


@pytest.fixture(scope="module")
def spec64():
    return default_ocp(N=N, tf=0.015 * N, dtype=torch.float64, device="cpu")


def test_new_phases_are_in_the_run():
    for phase in ("swarm", "closed_loop", "flight"):
        assert phase in cs.PHASES


def _tick_counts(ticks, per_tick, **changes):
    counts = dict.fromkeys(kc.KERNELS, 0)
    counts.update({k: v * ticks for k, v in per_tick.items()})
    counts.update(changes)
    return counts


def test_launch_count_check():
    ticks = 150
    got = cs.check_tick_launches("[swarm]", _tick_counts(
        ticks, cs.STEP_KERNELS), ticks, cs.STEP_KERNELS)
    assert got == {"prep_condense2": 1, "kkt_sweep_c2": 8,
                   "corrector_sweep_c2": 8, "expand2": 1}
    assert cs.check_tick_launches("[flight]", _tick_counts(3, {}), 3,
                                  {}) == {}


@pytest.mark.parametrize("change", [
    dict(kkt_sweep_c2=8 * 150 - 1), dict(expand2=0),
    dict(condense2=1)], ids=["one_K2_short", "no_K4", "stray_kernel"])
def test_launch_count_check_sees_a_planted_fault(change):
    counts = _tick_counts(150, cs.STEP_KERNELS, **change)
    with pytest.raises(SystemExit, match="launched"):
        cs.check_tick_launches("[swarm]", counts, 150, cs.STEP_KERNELS)


@pytest.fixture(scope="module")
def loop_run(spec64):
    x0 = cs.hover_batch(spec64, 1, seed=11)[0]
    case = dict(cs.closed_loop_cases())["cmd_vel_loop motvel"]
    return case(spec64, x0, 3), case(spec64, x0, 3)


def test_tolerance_check_passes_on_a_rerun(loop_run):
    a, b = loop_run
    for f in ("x", "u", "u_cmd"):
        assert cs.hold_close(f, getattr(a, f), getattr(b, f),
                             cs.LOOP_TOL) == 0.0


@pytest.mark.parametrize("plant", ["shift_1e-3", "nan", "shape"])
def test_tolerance_check_sees_a_planted_fault(loop_run, plant):
    a, b = loop_run
    got = a.u_cmd.clone()
    if plant == "shift_1e-3":
        got[1, 2] += 1e-3
    elif plant == "nan":
        got[0, 0] = float("nan")
    else:
        got = got[:2]
    with pytest.raises(SystemExit, match="u_cmd"):
        cs.hold_close("u_cmd", got, b.u_cmd, cs.LOOP_TOL)


@pytest.fixture(scope="module")
def swarm_x():
    spec = default_ocp(N=N, tf=0.015 * N, dtype=torch.float32, device="cpu")
    res = monte_carlo_hover(spec, torch.Generator().manual_seed(0), 4, 30,
                            pos_scale=0.05, setpoint=cs.SWARM_SETPOINT,
                            config=IPMConfig(iters=8))
    return res.x


def test_swarm_bar_passes_on_a_cpu_swarm(swarm_x):
    worst = cs.check_swarm_bar("[swarm]", swarm_x, cs.SWARM_SETPOINT)
    assert worst < cs.SWARM_BAR
    assert cs.swarm_lanes_off(swarm_x, cs.SWARM_SETPOINT) == ([], worst)


@pytest.mark.parametrize("plant", ["non_finite_lane", "stray_lane"])
def test_swarm_bar_sees_a_planted_fault(swarm_x, plant):
    x = swarm_x.clone()
    if plant == "non_finite_lane":
        x[10, 2, 7] = float("nan")
    else:
        x[-1, 2, 1] += 1.5 * cs.SWARM_BAR
    assert cs.swarm_lanes_off(x, cs.SWARM_SETPOINT)[0] == [2]
    with pytest.raises(SystemExit, match=r"lanes \[2\]"):
        cs.check_swarm_bar("[swarm]", x, cs.SWARM_SETPOINT)


def _flight(ticks=cs.FLIGHT_TICKS):
    """A flight's error, rotor speeds and states that meet the bars: 2.3
    cm at most, about 1 cm from tick 100 on."""
    rng = np.random.default_rng(0)
    e = np.concatenate([np.linspace(0.0, 0.023, 100),
                        0.01 + 0.002 * rng.standard_normal(ticks - 100)])
    u = torch.full((ticks, 4), 15.7, dtype=torch.float64)
    x = torch.zeros((ticks, 13), dtype=torch.float64)
    return e, u, x


def test_flight_bars_pass():
    e_max, e_mean = cs.check_flight_bars("[flight]", *_flight())
    assert e_max == pytest.approx(0.023) and e_mean < cs.FLIGHT_MEAN_ERR


@pytest.mark.parametrize("plant, match", [
    ("max", "largest"), ("mean", "mean"), ("rotor", "rotor"),
    ("state", "non-finite")])
def test_flight_bars_see_a_planted_fault(plant, match):
    e, u, x = _flight()
    if plant == "max":
        e[50] = cs.FLIGHT_MAX_ERR + 1e-4
    elif plant == "mean":
        e[100:] += cs.FLIGHT_MEAN_ERR
        e[100:] = np.minimum(e[100:], 0.029)
    elif plant == "rotor":
        u[7, 1] = 22.01
    else:
        x[-1, 4] = float("inf")
    with pytest.raises(SystemExit, match=match):
        cs.check_flight_bars("[flight]", e, u, x)
