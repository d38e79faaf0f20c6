"""Closed-loop NMPC simulation: plant + policy + RTI controller, tick by
tick (PyTorch counterpart of `runtime/closed_loop.py`).

The pure-software equivalent of the reference's hardware loop: the plant
is the same RK4 model the estimator's sim solver uses, the controller is
`solver.rti.rti_step` at the 66.6 Hz tick, and delay compensation mirrors
the reference's pipeline: the state fed to the NMPC is propagated
`delay_steps` stages ahead under the commands in flight
(acados_estimator.cpp:573-593), and the applied command is the stage-1
control u1 (acados_mpc.cpp:619-670).

The JAX package's tick `lax.scan` is a Python loop here; every carried
value and output stays on the device of the initial state (the spec's),
and the per-tick outputs are stacked there at the end.  With escalation
off (`IPMConfig(iters=8)`) a tick never waits on the card: the failure
guard selects with `torch.where`, never with a host branch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from crazyflie_nmpc_tpu_torch.ops import ipm
from crazyflie_nmpc_tpu_torch.ops.integrators import integrate
from crazyflie_nmpc_tpu_torch.solver import policies as policies_mod
from crazyflie_nmpc_tpu_torch.solver.ocp import OCPSpec
from crazyflie_nmpc_tpu_torch.solver.rti import RTIState, init_rti, rti_step


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Static closed-loop configuration.

    delay_steps: round-trip delay in control periods (reference default:
      60 ms / 15 ms = 4, acados_predictor.launch:62).  0 = ideal loop
      applying u0 with no prediction.
    plant_substeps: RK4 substeps for the simulated plant per tick.
    predictor: "pending" integrates the measurement forward under the
      commands actually in flight; "last_command" is the reference's
      scheme verbatim, one ZOH integration of length delay under the last
      published control (acados_estimator.cpp:573-593).
    guard_failures: hold-last-action on solver failure: a non-finite solve
      publishes the previous command and keeps the previous iterate
      (acados_mpc.cpp:714-717).
    remat: recompute each tick in the backward pass
      (`torch.utils.checkpoint`, non-reentrant; the JAX package's
      `jax.checkpoint` of the tick) instead of keeping its activations:
      differentiating through a long flight then holds one tick's
      activations at a time.  The recomputation must take the forward's
      escalation branches (`ops.ipm.BranchLog`): it reads the same values,
      and a tick that took another branch raises RuntimeError rather than
      give another gradient.
    ipm: the solver configuration; the default is the certified one (8
      iterations + escalation to 32; escalation reads one comparison on
      the host per tick, `ops.ipm.solve`).
    """

    delay_steps: int = 0
    plant_substeps: int = 1
    predictor: str = "pending"
    guard_failures: bool = True
    remat: bool = False
    ipm: ipm.IPMConfig = dataclasses.field(
        default_factory=ipm.certified_config)


class LoopResult(NamedTuple):
    x: Any            # (T, nx) true plant states at each tick
    u: Any            # (T, nu) controls applied during [t, t+1)
    u_cmd: Any        # (T, nu) controls commanded at each tick
    kkt_res: Any      # (T,) solver residual per tick
    policy_mode: Any  # (T,) policy mode per tick


def _stack(outs) -> LoopResult:
    return LoopResult(*(torch.stack(col) for col in zip(*outs)))


def simulate(spec: OCPSpec, x_init: torch.Tensor,
             policy_state: policies_mod.PolicyState,
             traj_table: torch.Tensor, steps: int,
             config: LoopConfig = LoopConfig(),
             measure=None) -> LoopResult:
    """Run `steps` ticks of the closed loop from `x_init`.

    With delay_steps = d > 0 the actuation path is a d-tick pipeline: the
    command issued at tick t reaches the rotors at tick t+d, and the
    controller solves from the measured state predicted d stages ahead
    (config.predictor).

    measure: optional (state0, fn) measurement model with
      fn(state, x_plant) -> (state', x_measured).  None = ideal feedback.
      The estimator chain plugs in here (estimator_in_the_loop).
    """
    if config.predictor not in ("pending", "last_command"):
        raise ValueError(
            f"LoopConfig.predictor must be 'pending' or 'last_command', "
            f"got {config.predictor!r}")
    d = config.delay_steps
    f = spec.ode()
    uss = spec.steady_input(x_init.dtype).to(x_init.device)

    mstate, measure_fn = measure if measure is not None else (None, None)
    # pending command pipeline: commands in flight (oldest first)
    u_pipe = uss.expand((max(d, 1),) + uss.shape)

    def predict(x, u_pipe, u_prev):
        if d == 0:
            return x
        if config.predictor == "last_command":
            return integrate(f, spec.params, x, u_prev, d * spec.dt,
                             d * spec.sim_steps)
        for k in range(d):
            x = integrate(f, spec.params, x, u_pipe[k], spec.dt,
                          spec.sim_steps)
        return x

    def tick(x_plant, rti_state, pol_state, u_pipe, u_prev, mstate):
        yref, yref_e, pol_next = policies_mod.make_yref(
            spec, pol_state, traj_table)
        if measure_fn is None:
            x_meas = x_plant
        else:
            mstate, x_meas = measure_fn(mstate, x_plant)
        x_pred = predict(x_meas, u_pipe, u_prev)

        rti_new, out = rti_step(spec, rti_state, x_pred, yref, yref_e,
                                config.ipm)
        u_cmd = out.u0
        if config.guard_failures:
            ok = (torch.isfinite(out.u_plan).all()
                  & torch.isfinite(out.x_plan).all())
            u_cmd = torch.where(ok, u_cmd, u_prev)
            rti_state = RTIState(**{
                fld.name: torch.where(ok, getattr(rti_new, fld.name),
                                      getattr(rti_state, fld.name))
                for fld in dataclasses.fields(RTIState)})
        else:
            rti_state = rti_new

        if d > 0:
            u_apply = u_pipe[0]
            u_pipe = torch.cat([u_pipe[1:d], u_cmd[None]], dim=0)
        else:
            u_apply = u_cmd

        x_next = integrate(f, spec.params, x_plant, u_apply, spec.dt,
                           config.plant_substeps)
        return ((x_next, rti_state, pol_next, u_pipe, u_cmd, mstate),
                (x_plant, u_apply, u_cmd, out.kkt_res, pol_state.mode))

    carry = (x_init, init_rti(spec, x_init, device=x_init.device),
             policy_state, u_pipe, uss, mstate)
    outs = []
    for _ in range(steps):
        if config.remat:
            carry, out = checkpoint(
                tick, *carry, use_reentrant=False,
                context_fn=lambda: ipm.BranchLog().contexts())
        else:
            carry, out = tick(*carry)
        outs.append(out)
    return _stack(outs)


def tracking_error(res: LoopResult, traj_table):
    """Per-tick position error over the TRACKING window of a loop result
    (numpy; reads the result back from the card).

    The playhead advances one row per tick from 0, so the k-th tracking
    tick aligns with table row k; the window closes when the policy
    latches to Position_Hold.
    """
    import numpy as np

    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    track = host(res.policy_mode) == policies_mod.TRACKING
    n = int(track.sum())
    return np.linalg.norm(host(res.x)[track, :3] - host(traj_table)[:n, :3],
                          axis=1)


def _table(traj_table, spec: OCPSpec, x_init):
    ny = spec.cost.W.shape[0]
    if traj_table is None:
        return torch.zeros((1, ny), dtype=x_init.dtype, device=x_init.device)
    return torch.as_tensor(traj_table).to(device=x_init.device,
                                          dtype=x_init.dtype)


def hover_regulation(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                     steps=1320, config: LoopConfig = LoopConfig()):
    """BASELINE config 1: hover regulation closed loop (20 s at 66.6 Hz)."""
    pol = policies_mod.regulation_state(setpoint, device=x_init.device)
    return simulate(spec, x_init, pol, _table(None, spec, x_init), steps,
                    config)


def trajectory_tracking(spec: OCPSpec, x_init, traj_table, steps=None,
                        config: LoopConfig = LoopConfig()):
    """BASELINE config 2: precomputed-trajectory tracking (helix etc.)."""
    ny = spec.cost.W.shape[0]
    if spec.f is not None:
        # custom-model spec: the regulation setpoint is unused in TRACKING
        # mode but must have the full (ny,) layout (policies.make_yref)
        pol = policies_mod.tracking_state(
            setpoint=torch.zeros((ny,), dtype=x_init.dtype,
                                 device=x_init.device),
            device=x_init.device)
    else:
        pol = policies_mod.tracking_state(device=x_init.device)
    steps = steps or traj_table.shape[0]
    return simulate(spec, x_init, pol, traj_table, steps, config)


def cmd_vel_loop(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                 steps: int = 660, delay_steps: int = 4,
                 config: LoopConfig = LoopConfig(), gains=None,
                 plant_substeps: int = 10, meas_delay_steps: int = 0,
                 predictor: str = "motvel", policy_state=None,
                 traj_table=None, measure=None):
    """The reference's actual actuation architecture, closed in software:

        NMPC (rotor-level internal model, u1/x4 extraction)
          -> to_cmd_vel                      (acados_mpc.cpp:644-670)
          -> radio pipe                      (actuation leg)
          -> onboard attitude/rate cascade   (models.firmware)
          -> rotor physics

    with a single-last-command delay predictor over the total round trip
    delay_steps (the reference's `delay` rosparam).  meas_delay_steps of
    it are on the sensing leg (the NMPC's measurement is that many ticks
    stale), the rest is the command pipe.

    predictor: "motvel" the reference verbatim, ZOH rotor-level
      integration under the last published u0 over max(d, 1)*sim_steps
      substeps (acados_estimator.cpp:578-586); "cmd_vel" propagates
      through the onboard cascade holding the last emitted cmd_vel, d
      control periods, each from a fresh motor state (the lag resets on
      each call, as in the JAX package).

    policy_state / traj_table select the policy (None = Regulation at
    `setpoint`); measure is an optional (state0, fn) measurement model
    applied to the stale plant state (estimator_measurement).

    Returns LoopResult: x = true plant states, u = rotor speeds the
    onboard mixer actually produced, u_cmd = the NMPC's published u0.
    """
    from crazyflie_nmpc_tpu_torch.models.firmware import (
        AttitudeGains,
        attitude_plant_step,
        init_motor_state,
    )
    from crazyflie_nmpc_tpu_torch.solver.outputs import krpm2pwm, to_cmd_vel

    gains = gains if gains is not None else AttitudeGains()
    if predictor not in ("motvel", "cmd_vel"):
        raise ValueError(f"predictor must be 'motvel' or 'cmd_vel', "
                         f"got {predictor!r}")
    d = delay_steps
    dm = meas_delay_steps
    if not 0 <= dm <= d:
        raise ValueError(f"meas_delay_steps must be in [0, delay_steps], "
                         f"got {dm} with delay_steps={d}")
    da = d - dm                      # actuation-leg pipe depth
    f = spec.ode()
    dev, dtype = x_init.device, x_init.dtype
    uss = spec.steady_input(dtype).to(dev)
    pol_state = (policy_state if policy_state is not None
                 else policies_mod.regulation_state(setpoint, device=dev))
    table = _table(traj_table, spec, x_init)
    mstate, measure_fn = measure if measure is not None else (None, None)
    rti_state = init_rti(spec, x_init, device=dev)

    hover_cmd = torch.cat([torch.zeros((3,), dtype=dtype, device=dev),
                           krpm2pwm(uss.mean()).reshape(1)])
    cmd_pipe = hover_cmd.expand(max(da, 1), 4)
    x_hist = x_init.expand((max(dm, 1),) + x_init.shape)
    x_plant, u_prev, cmd_prev = x_init, uss, hover_cmd
    motor = init_motor_state(spec.params, x_init)

    outs = []
    for _ in range(steps):
        yref, yref_e, pol_next = policies_mod.make_yref(
            spec, pol_state, table)

        # measurement leg: the NMPC sees the dm-tick-stale plant state
        x_stale = x_hist[0] if dm > 0 else x_plant
        if dm > 0:
            x_hist = torch.cat([x_hist[1:dm], x_plant[None]], dim=0)
        if measure_fn is None:
            x_meas = x_stale
        else:
            mstate, x_meas = measure_fn(mstate, x_stale)

        # single-last-command predictor over the full round trip
        if d == 0:
            x_pred = x_meas
        elif predictor == "motvel":
            x_pred = integrate(f, spec.params, x_meas, u_prev, d * spec.dt,
                               max(d, 1) * spec.sim_steps)
        else:
            x_pred = x_meas
            for _ in range(d):
                x_pred, _, _ = attitude_plant_step(
                    spec.params, x_pred, cmd_prev, spec.dt,
                    substeps=plant_substeps, gains=gains)

        rti_state, out = rti_step(spec, rti_state, x_pred, yref, yref_e,
                                  config.ipm)
        tw = to_cmd_vel(out.u1, out.x_at(4))
        cmd = torch.stack([tw.roll_deg, tw.pitch_deg, tw.yawrate_deg,
                           tw.thrust_pwm])

        if da > 0:
            cmd_apply = cmd_pipe[0]
            cmd_pipe = torch.cat([cmd_pipe[1:da], cmd[None]], dim=0)
        else:
            cmd_apply = cmd

        x_next, u_rotor, motor = attitude_plant_step(
            spec.params, x_plant, cmd_apply, spec.dt,
            substeps=plant_substeps, gains=gains, motor=motor)

        outs.append((x_plant, u_rotor, out.u0, out.kkt_res, pol_state.mode))
        x_plant, pol_state, u_prev, cmd_prev = x_next, pol_next, out.u0, cmd
    return _stack(outs)


def estimator_measurement(spec: OCPSpec, x_init):
    """The reference estimator chain as a `simulate` measurement model.

    Reduces the true plant state to the raw sensor channels on the
    reference's wire (mocap position, stabilizer Euler attitude, gyro
    rates, acados_estimator.cpp:452-513), then reassembles the 13-state:
    quaternion from Euler, IIR-LPF position differentiation for world
    velocity (its 0.7686 DC gain included), body-frame rotation.  Returns
    the (state0, fn) pair for simulate(..., measure=...).
    """
    from crazyflie_nmpc_tpu_torch.estimator.pipeline import (fuse,
                                                             init_estimator)
    from crazyflie_nmpc_tpu_torch.models import rotations

    def fn(est, x_plant):
        return fuse(est, x_plant[..., :3],
                    rotations.quat_to_euler(x_plant[..., 3:7]),
                    x_plant[..., 10:], spec.dt)

    return init_estimator(spec.params, x_init[..., :3]), fn


def estimator_in_the_loop(spec: OCPSpec, x_init, setpoint=(0.0, 0.0, 0.5),
                          steps: int = 660, delay_steps: int = 4,
                          config: LoopConfig = LoopConfig(),
                          policy_state=None, traj_table=None):
    """Full-fidelity closed loop: the NMPC sees only the estimator chain's
    reconstruction of the plant, `simulate` with `estimator_measurement`
    plugged in.  `delay_steps` overrides config.delay_steps; delay
    compensation integrates the measured state forward under the commands
    in flight (config.predictor).  Returns LoopResult with x = true plant
    states."""
    cfg = dataclasses.replace(config, delay_steps=delay_steps)
    pol0 = (policy_state if policy_state is not None
            else policies_mod.regulation_state(setpoint,
                                               device=x_init.device))
    return simulate(spec, x_init, pol0, _table(traj_table, spec, x_init),
                    steps, cfg, measure=estimator_measurement(spec, x_init))


def flight_configuration(spec: OCPSpec, traj_table, steps=None,
                         delay_steps: int = 4,
                         config: LoopConfig = LoopConfig(),
                         predictor: str = "cmd_vel", gains=None,
                         meas_delay_steps: int = 0,
                         plant_substeps: int = 10):
    """The reference's flight configuration, every block the paper flew
    composed in one loop:

        helix Tracking policy          (acados_mpc.cpp:458-488)
          + full estimator chain        (acados_estimator.cpp:356-440)
          + 60 ms round-trip delay      (delay_steps=4 x 15 ms, split
            sensing/actuation via meas_delay_steps)
          + single-last-command delay predictor
                                        (acados_estimator.cpp:573-593)
          + u1/x4 -> cmd_vel extraction (acados_mpc.cpp:619-625,644-670)
          + onboard attitude cascade    (models.firmware)
          + rotor physics.

    predictor: "cmd_vel" (default), the model-consistent single-last-
    command predictor; "motvel" the reference's rotor-level one verbatim.
    Runs on the spec's device (the table goes there).  Returns LoopResult
    (x = true plant states); feed it to tracking_error.
    """
    table = torch.as_tensor(traj_table).to(spec.lbu.device)
    x0 = table[0, :13]
    ny = spec.cost.W.shape[0]
    setpoint = (torch.zeros((ny,), dtype=table.dtype, device=table.device)
                if spec.f is not None else (0.0, 0.0, 0.5))
    return cmd_vel_loop(
        spec, x0, steps=steps or table.shape[0], delay_steps=delay_steps,
        config=config, gains=gains, plant_substeps=plant_substeps,
        meas_delay_steps=meas_delay_steps, predictor=predictor,
        policy_state=policies_mod.tracking_state(setpoint=setpoint,
                                                 device=table.device),
        traj_table=table, measure=estimator_measurement(spec, x0))
