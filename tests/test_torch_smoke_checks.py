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
from _torch_shared import one_torch_thread  # noqa: F401

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


# ---- [serving] and [swarm_wire] -------------------------------------------

def test_serving_phases_are_in_the_run():
    for phase in ("serving", "swarm_wire"):
        assert phase in cs.PHASES


def _step_counts(steps, resolves, **changes):
    sweeps = cs.ITERS * steps + cs.ESCALATE_ITERS * resolves
    counts = dict.fromkeys(kc.KERNELS, 0)
    counts.update(prep_condense2=steps, kkt_sweep_c2=sweeps,
                  corrector_sweep_c2=sweeps, expand2=steps + resolves)
    counts.update(changes)
    return counts


def test_step_launch_check_counts_escalation_resolves():
    got = cs.check_step_launches("[serving]", _step_counts(200, 3), 200, 3)
    assert got == {"prep_condense2": 1, "kkt_sweep_c2": 8.48,
                   "corrector_sweep_c2": 8.48, "expand2": 1.015}


@pytest.mark.parametrize("change", [
    dict(kkt_sweep_c2=0), dict(corrector_sweep_c2=8 * 200 + 32 * 3 - 1),
    dict(expand2=200), dict(iter_sweep_c2=1),
    dict(kkt_sweep_c2=8 * 200 + 32 * 4, corrector_sweep_c2=8 * 200 + 32 * 4)],
    ids=["no_K2", "one_K3_short", "one_K4_short", "stray_kernel",
         "uncounted_resolve"])
def test_step_launch_check_sees_a_planted_fault(change):
    with pytest.raises(SystemExit, match="launched"):
        cs.check_step_launches("[serving]", _step_counts(200, 3, **change),
                               200, 3)


def test_host_sync_check():
    want = {"emit": 200, "escalation": 200}
    cs.check_host_syncs("[serving]", dict(want), want)
    for got in ({"emit": 200, "escalation": 200, "other": 1},
                {"emit": 199, "escalation": 200}, {"escalation": 200}):
        with pytest.raises(SystemExit, match="host syncs"):
            cs.check_host_syncs("[serving]", got, want)


def _serve_report(depth, ticks=200, latency=0.02):
    from crazyflie_nmpc_tpu_torch.runtime.serving import (ServeConfig,
                                                          ServeReport)

    cfg = ServeConfig(rate_hz=cs.SERVE_RATE, pipeline_depth=depth)
    lat = np.full(ticks, latency + depth * cfg.period_s)
    return ServeReport(config=cfg, latency_s=lat, service_s=lat,
                       schedule_slips=0, ticks=ticks,
                       issue_s=np.full(ticks, 0.01))


def _served_lanes(B=8):
    x = torch.zeros((B, 13))
    x[:, :3] = torch.tensor(cs.SERVE_SETPOINT)
    x[:, :3] += 0.005 * torch.randn((B, 3),
                                    generator=torch.Generator().manual_seed(0))
    x[:, 3] = 1.0
    return x


def test_serving_bars_pass():
    for depth in (0, 2):
        worst = cs.serving_bars("[serving]", _serve_report(depth),
                                _served_lanes())
        assert worst < cs.SERVE_BAR


@pytest.mark.parametrize("plant, match", [
    ("lane_off", r"lanes off"), ("nan_lane", r"lanes off"),
    ("depth_latency", "below 2 periods")])
def test_serving_bars_see_a_planted_fault(plant, match):
    x, rep = _served_lanes(), _serve_report(2)
    if plant == "lane_off":
        x[5, 1] += 1.2 * cs.SERVE_BAR
    elif plant == "nan_lane":
        x[3, 9] = float("nan")
    else:
        rep.latency_s[7] = 1.5 * rep.config.period_s
    with pytest.raises(SystemExit, match=match):
        cs.serving_bars("[serving]", rep, x)


def test_serving_plant_loop_runs_on_cpu():
    """[serving]'s loop and plant wiring (`serve_plant`, uncounted) on
    CPU tensors at N=10: every tick emitted, the first command kept."""
    spec = default_ocp(N=N, tf=0.015 * N, dtype=torch.float32, device="cpu")
    x0 = cs.serving_lanes(spec, 3)
    assert float((x0[:, :3] - torch.tensor(cs.SERVE_SETPOINT)).abs().max()
                 ) <= cs.SERVE_OFFSET
    rep, x, first, none = cs.serve_plant(spec, 3, 2, 3, x0, "cpu",
                                         count=False)
    assert none is None and rep.latency_s.shape == (3,)
    assert first.shape == (3, 4) and np.isfinite(first).all()
    assert x.shape == (3, 13) and bool(torch.isfinite(x).all())


def _wire_report(n=4, ticks=30):
    from crazyflie_nmpc_tpu_torch.runtime.swarm import (SwarmReport,
                                                        grid_targets)

    pos = np.broadcast_to(grid_targets(n, spacing=0.6), (ticks, n, 3)).copy()
    return SwarmReport(n_vehicles=n, ticks=ticks, period_s=1 / 66.6,
                       latency_s=np.full((ticks, n), 0.03),
                       staleness=np.zeros((ticks, n), np.int64),
                       final_err_m=np.full(n, 0.01), positions=pos)


def test_wire_bars_pass():
    gap, fresh = cs.wire_bars("[swarm_wire]", _wire_report(), 4)
    assert gap == pytest.approx(0.6) and fresh == 1.0


@pytest.mark.parametrize("plant, match", [
    ("stale_row", "fresh rows"), ("never_updated", "fresh rows"),
    ("off_slot", "final errors"), ("collided", "apart"),
    ("nan_latency", "latency")])
def test_wire_bars_see_a_planted_fault(plant, match):
    rep = _wire_report()
    if plant == "stale_row":
        rep.staleness[10, 2] = 2
    elif plant == "never_updated":
        rep.staleness[:, 3] = np.arange(1, rep.ticks + 1)
    elif plant == "off_slot":
        rep.final_err_m[1] = cs.WIRE_FINAL_ERR + 1e-3
    elif plant == "collided":
        rep.positions[-1, 1] = rep.positions[-1, 0] + 0.1
    else:
        rep.latency_s[4, 0] = float("nan")
    with pytest.raises(SystemExit, match=match):
        cs.wire_bars("[swarm_wire]", rep, 4)


def test_realtime_bars():
    rep = _wire_report(n=2, ticks=80)
    cs.realtime_bars("[swarm_wire]", rep, 2)
    grounded = _wire_report(n=2, ticks=80)
    grounded.positions[:, 1, 2] = 0.03
    slipped = _wire_report(n=2, ticks=80)
    slipped.schedule_slips = 40
    dead = _wire_report(n=2, ticks=80)
    dead.staleness[-20:] = 4
    for bad, match in ((grounded, "did not fly"), (slipped, "slips"),
                       (dead, "live")):
        with pytest.raises(SystemExit, match=match):
            cs.realtime_bars("[swarm_wire]", bad, 2)


def test_tail_phases_run_at_once():
    """The host-bound loops ([tuning], [tuning_adam], [tuning_wide],
    [cartpole], [client], [closed_loop], [flight]), the multi-rank pod
    runs ([pod_ranks]), the certified loops ([certified_loops]) and the
    launch layer ([bringup]) are in the run, each in exactly one
    concurrent group, the last three alone."""
    tail = [p for g in cs.CONCURRENT for p in g]
    assert sorted(tail) == sorted(("tuning", "tuning_adam", "tuning_wide",
                                   "cartpole", "client", "closed_loop",
                                   "flight", "pod_ranks", "certified_loops",
                                   "bringup"))
    assert set(tail) <= set(cs.PHASES)
    assert ("pod_ranks",) in cs.CONCURRENT
    assert ("certified_loops",) in cs.CONCURRENT
    assert ("bringup",) in cs.CONCURRENT


def test_a_failed_child_fails_the_run():
    """run_concurrent ends every child and fails when one of them failed
    (here: no CUDA device, the children exit 1 at once)."""
    with pytest.raises(SystemExit, match=r"client \(exit 1\); cartpole"):
        cs.run_concurrent([("client",), ("cartpole",)])


# ---- [pod], [pod_ranks], [certified_loops] (the pod path and the
# certified loops)


def test_pod_runs_alone_before_the_tail():
    """[pod] runs in a child process of its own in sequence (its one-rank
    NCCL group ends with the process), after [swarm_wire], not in the
    concurrent tail."""
    assert "pod" in cs.PHASES
    assert all("pod" not in g for g in cs.CONCURRENT)
    assert cs.PHASES.index("pod") > cs.PHASES.index("swarm_wire")


def test_child_counts_sum_every_counts_line():
    text = ("[pod] something\n" + cs.COUNTS + '{"expand2": 20, "kkt_sweep_c2": 160}\n'
            "[phase] pod: 1.0 s\n" + cs.COUNTS + '{"expand2": 5}\n')
    assert cs.child_counts(text) == {"expand2": 25, "kkt_sweep_c2": 160}
    assert cs.child_counts("no counts here") == {}


@pytest.fixture(scope="module")
def pod_outputs(spec64):
    """A batch-last step's u-plan on 4 lanes (the unsharded one) and its
    two 2-lane shards, computed apart as two ranks would."""
    from crazyflie_nmpc_tpu_torch.solver import hover_yref, init_rti
    from crazyflie_nmpc_tpu_torch.solver.rti_batched import (
        rti_step_batched, to_batch_last)

    x0s = cs.hover_batch(spec64, 4, seed=4)
    yref, yref_e = hover_yref(spec64, device="cpu")

    def step(x):
        st = to_batch_last(init_rti(spec64, x, device="cpu"))
        return rti_step_batched(spec64, st, x, yref, yref_e,
                                IPMConfig(iters=8), layout="batch_last")[1]
    whole = step(x0s)
    return whole, [step(x0s[:2]), step(x0s[2:])]


def test_shard_check_passes_on_real_shards(pod_outputs):
    whole, shards = pod_outputs
    err = cs.check_shards("[pod]", [o.u_plan for o in shards], whole.u_plan,
                          cs.POD_TOL)
    assert err <= 1e-12


@pytest.mark.parametrize("plant", ["swapped", "one_lane_off", "short"])
def test_shard_check_sees_a_wrong_shard(pod_outputs, plant):
    whole, shards = pod_outputs
    got = [o.u_plan.clone() for o in shards]
    if plant == "swapped":
        got = got[::-1]
    elif plant == "one_lane_off":
        got[1][3, 2, 0] += 2e-6
    else:
        got[1] = got[1][..., :1]
    with pytest.raises(SystemExit, match="pod"):
        cs.check_shards("[pod]", got, whole.u_plan, cs.POD_TOL)


def test_fleet_check(pod_outputs):
    whole, shards = pod_outputs
    kkt, mu = whole.kkt_res, whole.qp_mu
    right = (kkt.amax(), mu.mean())
    cs.check_fleet("[pod]", right, kkt, mu)
    for wrong in ((shards[0].kkt_res.amax(), mu.mean()),
                  (kkt.amax(), shards[0].qp_mu.mean())):
        if float(wrong[0]) != float(right[0]) or float(
                wrong[1]) != float(right[1]):
            with pytest.raises(SystemExit, match="fleet"):
                cs.check_fleet("[pod]", wrong, kkt, mu)


def test_replicated_check_sees_a_wrong_gather_order(spec64):
    """A stage-sharded result whose chunks were gathered in the wrong
    order (or one rank's copy that differs) fails [pod_ranks]' check."""
    from crazyflie_nmpc_tpu_torch.solver import hover_yref, init_rti, rti_step

    x0 = cs.hover_batch(spec64, 1, seed=2)[0]
    yref, yref_e = hover_yref(spec64, device="cpu")
    new, _ = rti_step(spec64, init_rti(spec64, x0, device="cpu"), x0, yref,
                      yref_e, IPMConfig(iters=10))
    u = new.u_traj
    assert cs.check_replicated("[pod_ranks] (b)", [u, u.clone()], u, 1e-8,
                               1e-9) == 0.0
    swapped = torch.cat([u[N // 2:], u[:N // 2]])
    off = u.clone()
    off[3, 1] += 1e-6
    for bad in ([u, swapped], [off, u]):
        with pytest.raises(SystemExit, match="rank"):
            cs.check_replicated("[pod_ranks] (b)", bad, u, 1e-8, 1e-9)


@pytest.fixture(scope="module")
def certified_run(spec64):
    """[certified_loops]' loops at N=10 on the CPU (2 hover ticks from 0.3
    m, certified; 2 batched ticks at B=3) with the oracle inline."""
    from crazyflie_nmpc_tpu_torch.models import hover_state
    from crazyflie_nmpc_tpu_torch.solver import hover_yref

    yref, yref_e = hover_yref(spec64, device="cpu")
    x = hover_state(spec64.params, dtype=torch.float64, device="cpu").clone()
    x[0] = 0.3
    hov, plain, _ = cs.certified_loop(
        spec64, x, lambda t: (yref, yref_e), 2,
        IPMConfig(iters=8, escalate_iters=16), cs.oracle_plan,
        plain_ticks=2)
    xb = x.repeat(3, 1)
    xb[:, 0] = torch.tensor([0.3, 0.02, -0.25], dtype=torch.float64)
    bat, _, _, _ = cs.certified_batched_loop(
        spec64, xb, 2, IPMConfig(iters=8, escalate_iters=16,
                                 escalate_capacity=4), cs.oracle_plan)
    return hov, plain, bat


def test_certified_check_passes_on_the_port(certified_run):
    hov, _, bat = certified_run
    assert len(bat) == 6
    for plans in (hov, bat):
        assert cs.check_certified("[certified_loops]",
                                  cs.plan_errors(plans)) < cs.CERT_TOL


@pytest.mark.parametrize("plant", ["plan_off", "nan", "empty"])
def test_certified_check_sees_a_wrong_oracle_plan(certified_run, plant):
    hov, _, _ = certified_run
    (u, ref), rest = hov[0], hov[1:]
    if plant == "plan_off":
        ref = ref.copy()
        ref[4, 1] += 2 * cs.CERT_TOL
    elif plant == "nan":
        ref = np.full_like(ref, np.nan)
    plans = [] if plant == "empty" else [(u, ref)] + rest
    with pytest.raises(SystemExit, match="oracle"):
        cs.check_certified("[certified_loops]", cs.plan_errors(plans))


# ---- [pscan] and [bringup] (the associative-scan Riccati, the launch
# layer)


def test_pscan_runs_in_the_main_sequence_before_the_loops():
    assert "pscan" in cs.PHASES
    assert all("pscan" not in g for g in cs.CONCURRENT)
    assert cs.PHASES.index("pscan") < cs.PHASES.index("swarm")


@pytest.fixture
def no_card(monkeypatch):
    """The card's sync calls as no-ops, so the checks run on CPU tensors."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a, **k: None)


def test_pscan_parity_passes_on_the_port(no_card):
    errs = cs.pscan_parity(50, "cpu")
    assert set(errs) == {"vs sequential", "vs CPU", "factors"}
    assert max(max(e.values()) for e in errs.values()) < 1e-12


def test_pscan_check_sees_a_wrong_P():
    from crazyflie_nmpc_tpu_torch.ops import riccati
    from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as rp

    lq = cs.pscan_lq(12, torch.float64, "cpu")
    fac = [lq[k] for k in ("A", "B", "Qxx", "Ruu", "S", "P_term")]
    fr, ref = rp.factors_pscan(*fac), riccati.factorize(*fac)
    cs.check_pscan("[pscan]", dict(P=fr.P, K=fr.K), dict(P=ref.P, K=ref.K))
    bad = fr.P.clone()
    bad[3, 2, 2] += 1e-8
    with pytest.raises(SystemExit, match="P off by"):
        cs.check_pscan("[pscan]", dict(P=bad, K=fr.K),
                       dict(P=ref.P, K=ref.K))


def test_pscan_parity_sees_a_swapped_scan_operand(no_card, monkeypatch):
    from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as rp

    scan = rp.associative_scan
    monkeypatch.setattr(rp, "associative_scan",
                        lambda fn, elems, reverse=False: scan(
                            lambda a, b: fn(b, a), elems, reverse))
    with pytest.raises(SystemExit, match="vs sequential"):
        cs.pscan_parity(50, "cpu")


def test_pscan_parity_sees_a_sync_inside_the_scan(no_card, monkeypatch):
    """A wait on the card inside the scan: the sync debug mode raises (as
    torch does, planted here on the CPU) and the run fails."""
    from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as rp

    combine = rp._combine

    def syncing(ei, ej):
        raise RuntimeError("called a synchronizing CUDA operation")

    monkeypatch.setattr(rp, "_combine", syncing)
    with pytest.raises(SystemExit, match="waits on the card"):
        cs.pscan_parity(50, "cpu")
    monkeypatch.setattr(rp, "_combine", combine)
    with pytest.raises(ValueError, match="other"):
        cs.run_without_sync("[pscan]", lambda: (_ for _ in ()).throw(
            ValueError("other")))


def test_bringup_cpu_comparison_sees_a_differing_run():
    from crazyflie_nmpc_tpu_torch import bringup

    a, b = (bringup.nmpc_predictor(steps=2, device="cpu")
            for _ in range(2))
    assert cs.hold_close("[bringup]", a["result"].x, b["result"].x,
                         cs.BRINGUP_PREDICTOR_TOL) == 0.0
    with pytest.raises(SystemExit, match=r"max \|diff\| 2\.0+e-06"):
        cs.hold_close("[bringup]", a["result"].x + 2e-6, b["result"].x,
                      cs.BRINGUP_PREDICTOR_TOL)


def test_session_check_sees_a_crashed_pane_reported_as_healthy():
    from crazyflie_nmpc_tpu_torch import bringup

    out = bringup.session({"bad": ("bag_play", "/nonexistent/no.bag"),
                           "ok": ("teleop", 5, 0)})
    cs.check_session("[bringup]", out, healthy=("ok",), crashed=("bad",))
    with pytest.raises(SystemExit, match="pane bad crashed"):
        cs.check_session("[bringup]", out, healthy=("ok", "bad"))
    healthy = dict(out, bad={"summary": {}})
    with pytest.raises(SystemExit, match="should have crashed"):
        cs.check_session("[bringup]", healthy, healthy=("ok",),
                         crashed=("bad",))
    with pytest.raises(SystemExit, match="panes"):
        cs.check_session("[bringup]", {"ok": out["ok"]}, healthy=("ok",),
                         crashed=("bad",))


def test_swarm_pane_check_sees_no_K2():
    steps = cs.BRINGUP_SWARM_TICKS + 1
    cs.check_step_launches("[bringup] swarm pane",
                           _step_counts(steps, 0), steps, 0)
    with pytest.raises(SystemExit, match="kkt_sweep_c2 launched 0"):
        cs.check_step_launches("[bringup] swarm pane",
                               _step_counts(steps, 0, kkt_sweep_c2=0),
                               steps, 0)


def test_composition_bars_pass_and_see_a_planted_fault():
    from crazyflie_nmpc_tpu_torch import bringup

    out = bringup.teleop(ticks=10, port=0)
    cs.check_bars("[bringup] teleop", cs.wire_composition_bars("teleop",
                                                               out))
    with pytest.raises(SystemExit, match="device setpoint"):
        cs.check_bars("[bringup] teleop", cs.wire_composition_bars(
            "teleop", dict(out, device_setpoint=(3.0, -3.0, 0.0, 35999))))
    cmd = np.tile([0.1, -0.2, 0.0, 43000.0], (5, 1))
    bench = {"cmd_vel": cmd, "mocap_published": 5,
             "device_setpoint": (0.0, 0.0, 0.0, 43000)}
    cs.check_bars("[bringup] bench", cs.bench_bars(bench, 5))
    for bad, match in ((dict(mocap_published=4), "mocap published"),
                       (dict(cmd_vel=cmd * [1, 12, 1, 1]), "roll/pitch"),
                       (dict(device_setpoint=None), "no setpoint")):
        with pytest.raises(SystemExit, match=match):
            cs.check_bars("[bringup] bench", cs.bench_bars(
                dict(bench, **bad), 5))


def test_loop_graphs_check_sees_one_differing_bit():
    """[swarm_wire]'s graphed-vs-op-by-op check: equal outputs pass; one
    entry one ulp off, or an output missing, fails."""
    rng = np.random.default_rng(5)
    want = [torch.as_tensor(rng.standard_normal((4, 3)), dtype=torch.float32)
            for _ in range(4)]
    got = [w.clone() for w in want]
    assert cs.graphs_agree("[swarm_wire] LoopGraphs", got, want) == 4
    got[2][1, 1] = torch.nextafter(got[2][1, 1], torch.tensor(np.inf))
    with pytest.raises(SystemExit, match=r"outputs \[2\] of 4 differ"):
        cs.graphs_agree("[swarm_wire] LoopGraphs", got, want)
    with pytest.raises(SystemExit, match="differ"):
        cs.graphs_agree("[swarm_wire] LoopGraphs", want[:3], want)


@pytest.fixture(scope="module")
def win_inputs():
    return cs.kernel_inputs(5, torch.float64, "cpu", n=6)


def test_split_vs_fused_is_zero_on_the_same_sums(win_inputs):
    """[kernel]'s K5a/K5b-vs-K2 check: the plain versions run K2's sums in
    K2's order, so both differences are exactly 0."""
    (g_abs, g_rel), (r_abs, r_rel) = cs.split_vs_fused(win_inputs)
    assert g_abs == g_rel == r_abs == r_rel == 0.0


@pytest.mark.parametrize("kernel, out, part", [
    ("bwd_c2", 1, 0), ("fwd_c2", 0, 1)], ids=["kff", "dx"])
def test_split_vs_fused_sees_a_planted_fault(win_inputs, monkeypatch, kernel,
                                             out, part):
    """A last-bit change in one output of K5a or K5b shows in its own
    difference, and only there."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    real = getattr(ck, kernel)

    def planted(*args):
        outs = list(real(*args))
        outs[out] = outs[out] * (1 + 1e-15)
        return tuple(outs)

    monkeypatch.setattr(ck, kernel, planted)
    diffs = cs.split_vs_fused(win_inputs)
    assert diffs[part][0] > 0.0
    assert diffs[1 - part] == (0.0, 0.0)


def test_at_lanes_cuts_and_tiles_the_lane_axis():
    a = torch.arange(6.0).reshape(2, 3)
    cut, _, other = cs.at_lanes((a, a, 0.5), 2)
    assert torch.equal(cut, a[:, :2]) and cut.is_contiguous()
    assert other == 0.5
    (tiled,) = cs.at_lanes((a,), 7)
    assert torch.equal(tiled, torch.cat([a, a, a], dim=-1)[:, :7])


@pytest.mark.parametrize("name", ["kkt_sweep", "backward_sweep"])
def test_riccati_group_kernels_are_listed(name):
    """K8a and K9a, a group of threads a lane: timed at every B with their
    occupancy (GROUP_KERNELS), checked on a ragged last tile and at B=1
    (RAGGED_KERNELS), with riccati_kernels' launch shape and occupancy
    entry, and found in a trace under their own CUDA function's name."""
    import re

    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    assert name in cs.GROUP_KERNELS and name in cs.RAGGED_KERNELS
    geometry, blocks_per_sm, group = cs.group_kernel(name)
    assert geometry is rk.riccati_launch_geometry
    assert blocks_per_sm.func is rk.riccati_blocks_per_sm
    assert blocks_per_sm.keywords == {"kernel": name}
    assert group == rk.RICCATI_GROUP
    pattern = cs.kernel_pattern(name)
    assert re.search(pattern, f"void (anonymous namespace)::{name}_kernel"
                              f"<float>(float const*, int, int)")
    other = "backward_sweep" if name == "kkt_sweep" else "kkt_sweep"
    for stray in (f"{other}_kernel<float>", f"{name}_c2_kernel<float>",
                  "backward_vector_sweep_kernel<float>"):
        assert not re.search(pattern, stray), stray


def test_corr_split_vs_fused_is_bitwise_on_the_same_sums(win_inputs):
    """[kernel]'s K5c-then-K5b-vs-K3 check: the plain versions run K3's
    sums in K3's order, so the rollouts are equal bit for bit."""
    assert cs.corr_split_vs_fused(win_inputs) is True


@pytest.mark.parametrize("kernel, out", [("bwd_vec_c2", None),
                                         ("fwd_c2", 1)], ids=["kff", "du"])
def test_corr_split_vs_fused_sees_a_planted_fault(win_inputs, monkeypatch,
                                                  kernel, out):
    """A last-bit change in K5c's kff or in K5b's du breaks the check."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    real = getattr(ck, kernel)

    def planted(*args):
        got = real(*args)
        if out is None:
            return got * (1 + 1e-15)
        got = list(got)
        got[out] = got[out] * (1 + 1e-15)
        return tuple(got)

    monkeypatch.setattr(ck, kernel, planted)
    assert cs.corr_split_vs_fused(win_inputs) is False


@pytest.mark.parametrize("name", ["bwd_vec_c2", "forward_sweep"])
def test_k5c_and_k9b_are_listed_as_group_kernels(name):
    """K5c and K9b, a group of threads a lane: timed at every B with their
    occupancy (GROUP_KERNELS), checked on a ragged last tile and at B=1
    (RAGGED_KERNELS), K5c also at N=400 at every B (LONG_GROUP_KERNELS),
    with their module's launch shape and occupancy entry, and found in a
    trace under their own CUDA function's name."""
    import re

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    assert name in cs.GROUP_KERNELS and name in cs.RAGGED_KERNELS
    geometry, blocks_per_sm, group = cs.group_kernel(name)
    if name == "bwd_vec_c2":
        assert name in cs.WIN_KERNELS and name in cs.LONG_GROUP_KERNELS
        assert (geometry, blocks_per_sm, group) == (
            ck.bwd_vec_launch_geometry, ck.bwd_vec_blocks_per_sm,
            ck.BWD_VEC_GROUP)
        assert cs.KERNEL_INFO[name]["source"].endswith(
            "csrc/corrector_sweep_c2.cu")
        strays = ("bwd_c2_kernel<float>", "fwd_c2_kernel<float>",
                  "corrector_sweep_c2_kernel<float, float, float, false>")
    else:
        assert (geometry, blocks_per_sm, group) == (
            rk.forward_launch_geometry, rk.forward_blocks_per_sm,
            rk.FORWARD_GROUP)
        strays = ("kkt_sweep_kernel<float>", "backward_sweep_kernel<float>",
                  "backward_vector_sweep_kernel<float>",
                  "corrector_sweep_kernel<float>")
    pattern = cs.kernel_pattern(name)
    assert re.search(pattern, f"void (anonymous namespace)::{name}_kernel"
                              f"<float>(float const*, int, int)")
    for stray in strays:
        assert not re.search(pattern, stray), stray
    assert not re.search(cs.kernel_pattern("bwd_c2"),
                         "bwd_vec_c2_kernel<float>")


@pytest.mark.parametrize("name", ["corrector_sweep", "backward_vector_sweep"])
def test_k8b_and_k9c_are_listed_as_group_kernels(name):
    """K8b and K9c, a group of threads a lane: timed at every B with their
    occupancy (GROUP_KERNELS), checked on a ragged last tile and at B=1
    (RAGGED_KERNELS), with riccati_kernels' launch shape and occupancy
    entry, and found in a trace under their own CUDA function's name."""
    import re

    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    assert name in cs.GROUP_KERNELS and name in cs.RAGGED_KERNELS
    assert name in cs.UNCONDENSED_KERNELS and name not in cs.WIN_KERNELS
    geometry, blocks_per_sm, group = cs.group_kernel(name)
    assert geometry is rk.vector_launch_geometry
    assert blocks_per_sm.func is rk.vector_blocks_per_sm
    assert blocks_per_sm.keywords == {"kernel": name}
    assert group == rk.VECTOR_GROUP
    assert cs.KERNEL_INFO[name]["source"].endswith("csrc/riccati.cu")
    pattern = cs.kernel_pattern(name)
    assert re.search(pattern, f"void (anonymous namespace)::{name}_kernel"
                              f"<float>(float const*, int, int)")
    other = ("backward_vector_sweep" if name == "corrector_sweep"
             else "corrector_sweep")
    for stray in (f"{other}_kernel<float>", "kkt_sweep_kernel<float>",
                  "forward_sweep_kernel<float>",
                  "corrector_sweep_c2_kernel<float, float, float, false>",
                  "bwd_vec_c2_kernel<float>"):
        assert not re.search(pattern, stray), stray


@pytest.fixture(scope="module")
def riccati_inputs():
    return cs.kernel_inputs(5, torch.float64, "cpu", n=5)


def test_uncondensed_split_vs_fused_is_bitwise_on_the_same_sums(
        riccati_inputs):
    """[kernel]'s uncondensed check: the plain versions of K8a and K8b are
    their split forms' in turn, so K9a's gains, K9b's rollout on K8a's
    gains and K9c then K9b against K8b are all equal bit for bit."""
    assert cs.uncondensed_split_vs_fused(riccati_inputs) == (True, True,
                                                              True)


@pytest.mark.parametrize("kernel, part", [
    ("backward_sweep", 0), ("backward_vector_sweep", 2)],
    ids=["K9a", "K9c"])
def test_uncondensed_split_vs_fused_sees_a_planted_fault(
        riccati_inputs, monkeypatch, kernel, part):
    """A last-bit change in K9a's kff or in K9c's kff shows in its own
    comparison, and only there."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import riccati_kernels as rk

    real = getattr(rk, kernel)

    def planted(*args):
        got = real(*args)
        if isinstance(got, torch.Tensor):
            return got * (1 + 1e-15)
        got = list(got)
        got[1] = got[1] * (1 + 1e-15)
        return tuple(got)

    monkeypatch.setattr(rk, kernel, planted)
    same = cs.uncondensed_split_vs_fused(riccati_inputs)
    assert [s is False for s in same] == [i == part for i in range(3)]


def test_kernels_line_has_17_kernels():
    """The second-to-last line's table: the 15 kernels of the solver's
    paths (every pl.pallas_call site of the JAX package's ops/pallas/)
    and the two speed-of-light probes, each with its TPU file:line."""
    table = {**cs.KERNEL_INFO, **cs.PROBE_INFO}
    assert len(table) == 17
    assert all(set(info) == {"source", "replaces"} for info in table.values())
    assert table["kkt_sweep"]["replaces"].endswith("riccati_kernels.py:459")
    assert table["backward_sweep"]["replaces"].endswith(
        "riccati_kernels.py:233")


def test_k6_is_listed_as_a_group_kernel():
    """K6 on K1's block (32 lanes of a pair, 8 threads a lane): timed at
    every B with its occupancy (GROUP_KERNELS; its grid spans the M pairs
    too), checked on a ragged last tile, at B=1 and at one stage pair
    (RAGGED_KERNELS, N_PAIR), with condensed_kernels' launch shape and
    occupancy entry, and found in a trace under its own CUDA function's
    name, not K1's."""
    import re

    from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as ck

    assert "condense2" in cs.GROUP_KERNELS
    assert "condense2" in cs.RAGGED_KERNELS and cs.N_PAIR == 2
    assert "condense2" in cs.PAIR_GRID_KERNELS
    assert cs.B_RAGGED % ck.CONDENSE_LANES != 0
    geometry, blocks_per_sm, group = cs.group_kernel("condense2")
    assert geometry is ck.condense_launch_geometry
    assert blocks_per_sm is ck.condense_blocks_per_sm
    assert group == ck.CONDENSE_THREADS // ck.CONDENSE_LANES == 8
    pattern = cs.kernel_pattern("condense2")
    assert re.search(pattern, "void (anonymous namespace)::condense2_kernel"
                              "<float>(float const*, int)")
    assert not re.search(pattern, "prep_condense2_kernel<float, 4>")


def test_fma_chain_is_checked_at_ragged_lanes():
    """[roofline] holds fma_chain and stage_replay (8 lanes a block each)
    at B_RAGGED, on a ragged last tile and at B=1 besides B_CHECK; on the
    CPU the plain chain of the parity inputs is finite at B=1 and one
    group of products short differs."""
    from crazyflie_nmpc_tpu_torch.ops.cuda import sol_kernels as sk
    from crazyflie_nmpc_tpu_torch.roofline import ipm_iter_sol as sol

    batches = cs.PROBE_BATCHES["fma_chain"]
    assert batches[:2] == (cs.B_CHECK, cs.B_RAGGED) and batches[-1] == 1
    assert cs.PROBE_BATCHES["stage_replay"] == batches
    assert set(cs.PROBE_BATCHES) == set(cs.PROBE_INFO)
    assert [B for B in batches if B % sk.FMA_LANES] == [batches[2], 1]
    assert [B for B in batches if B % sk.REPLAY_LANES] == [batches[2], 1]
    (a, b), _ = sol.probe_inputs(1, torch.float64, "cpu", parity=True)
    full = sk.fma_chain(a, b, reps=32)
    _, rel = cs.compare([full], [sk.fma_chain_plain(a, b, reps=16)])
    assert bool(full.isfinite().all()) and rel > cs.TOL["float64"]
