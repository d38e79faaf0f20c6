"""Differentiable MPC (`runtime.tuning`, `LoopConfig(remat=True)`) vs the
JAX package's, float64 on the CPU.

The case is the JAX package's tuning loop cut to N=6 stages of 15 ms
(tf=0.09), `hover_regulation` from x = 0.4 m, 6 ticks,
IPMConfig(iters=3), and as objective mean squared position error plus
`settle` times its tail plus `u_weight` times the control-rate penalty
(`hover_objective`'s terms; both weights 0 gives the plain mean squared
error).  One jitted JAX `value_and_grad` of that loop takes x0, the log
weights and the objective's two weights as arguments, so it compiles
once (at XLA's optimization level 0) for every test here:

  * the saturating case (the reference weights: the climb puts the
    rotors within 0.002 kRPM of the 22 kRPM box and 0.11 kRPM of 0),
    where the mirror-image rotor pairs tie in the IPM's step-length
    minimum and rounding decides the split of their gradient (ROADMAP
    Queue 3, F4): the loss, the state-weight entries and each rotor
    pair's summed gradient to 1e-9, the whole gradient to 2e-3,
    relative to its largest entry;
  * the detuned case (`test_tuning.py`'s weights, inputs well inside the
    box): the whole gradient to 1e-8 relative to its largest entry;
  * a 2-step `tune_diagonal_cost` against the same program stepped by
    `optax.adam`.

Also: the IPM's min/max tie rules against JAX's, `torch.optim.Adam`
against `optax.adam` on fixed gradients, and remat against stored
gradients to 1e-12 (escalation's host branch recomputed alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import solver as jsolver
from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops import ipm as jipm
from crazyflie_nmpc_tpu.runtime import closed_loop as jcl
from crazyflie_nmpc_tpu.runtime import tuning as jtuning
from crazyflie_nmpc_tpu_torch import convert, device
from crazyflie_nmpc_tpu_torch.ops import ipm as tipm
from crazyflie_nmpc_tpu_torch.runtime import closed_loop as tcl
from crazyflie_nmpc_tpu_torch.runtime import tuning as ttuning
from _torch_shared import one_torch_thread  # noqa: F401

N, TF, TICKS, ITERS = 6, 0.09, 6, 3
SETPOINT = (0.0, 0.0, 0.5)
# the detuned weights of tests/test_tuning.py: position 100x too small
Q_DETUNED = np.array([1.2, 1.0, 1.0, 1e-3, 1e-3, 1e-3, 1e-3,
                      0.7, 1.0, 4.0, 1e-5, 1e-5, 10.0])
W_DETUNED = np.concatenate([Q_DETUNED, np.full(4, 0.06)])
WE_DETUNED = 50.0 * Q_DETUNED
ROTOR_PAIRS = ((13, 16), (14, 15))   # mirror-image rotors of the X frame


def _objective(xs, us, settle, u_weight, sp):
    """hover_objective's terms, shared by both packages (xp = jnp or
    torch through the array methods)."""
    pos_err = ((xs[:, :3] - sp) ** 2).sum(1)
    tail = pos_err[int(0.6 * pos_err.shape[0]):]
    du = us[1:] - us[:-1]
    return (pos_err.mean() + settle * tail.mean()
            + u_weight * (du ** 2).sum(1).mean())


@pytest.fixture(scope="module")
def jax_vg():
    """value_and_grad(loss, argnums=(1, 2)) of the JAX loop, compiled
    once: (x0, log W diag, log W_e diag, settle, u_weight) -> (loss,
    (d/dlogW, d/dlogW_e))."""
    js = jsolver.default_ocp(N=N, tf=TF, dtype=jnp.float64)
    cfg = jcl.LoopConfig(ipm=jipm.IPMConfig(iters=ITERS))
    sp = jnp.asarray(SETPOINT)

    def loss(x0, logw, logwe, settle, u_weight):
        s = jtuning.spec_with_diag_cost(js, jnp.exp(logw), jnp.exp(logwe))
        r = jcl.hover_regulation(s, x0, steps=TICKS, config=cfg)
        return _objective(r.x, r.u, settle, u_weight, sp)

    x0 = hover_state(js.params, dtype=jnp.float64).at[0].set(0.4)
    args = (x0, jnp.zeros(17), jnp.zeros(13), 0.0, 0.0)
    fn = jax.jit(jax.value_and_grad(loss, argnums=(1, 2))).lower(
        *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})

    def call(logw, logwe, settle=0.0, u_weight=0.0):
        v, (gw, gwe) = fn(x0, jnp.asarray(logw), jnp.asarray(logwe),
                          settle, u_weight)
        return float(v), np.asarray(gw), np.asarray(gwe)

    return dict(call=call, js=js, x0=np.asarray(x0))


@pytest.fixture(scope="module")
def port(jax_vg):
    tspec = convert.spec_from_numpy(convert.leaves_from_spec(jax_vg["js"]),
                                    N, device="cpu", dtype=torch.float64)
    return dict(spec=tspec, x0=torch.as_tensor(jax_vg["x0"]))


def _port_loop(port, spec, remat=False, ipm_cfg=None, ticks=TICKS):
    cfg = tcl.LoopConfig(ipm=ipm_cfg or tipm.IPMConfig(iters=ITERS),
                         remat=remat)
    return tcl.hover_regulation(spec, port["x0"], steps=ticks, config=cfg)


def _mean_squared_error(res, settle=0.0, u_weight=0.0):
    sp = torch.tensor(SETPOINT, dtype=torch.float64)
    return _objective(res.x, res.u, settle, u_weight, sp)


def _port_vg(port, w, we, settle=0.0, u_weight=0.0, **loop):
    logw = torch.log(torch.as_tensor(w)).requires_grad_(True)
    spec = ttuning.spec_with_diag_cost(port["spec"], torch.exp(logw),
                                       torch.as_tensor(we))
    res = _port_loop(port, spec, **loop)
    val = _mean_squared_error(res, settle, u_weight)
    g, = torch.autograd.grad(val, logw)
    return float(val.detach()), g.numpy(), res


def _reference_weights(port):
    return (torch.diagonal(port["spec"].cost.W).numpy(),
            torch.diagonal(port["spec"].cost.W_e).numpy())


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_saturating_gradient_f4(jax_vg, port):
    """F4: the loss and every direction that keeps the rotor pairs'
    symmetry agree; the split of a pair's gradient does not, because
    rounding breaks the pairs' tie in the step-length minimum at
    different ticks in the two packages."""
    w, we = _reference_weights(port)
    v, g, res = _port_vg(port, w, we)
    vj, gj, _ = jax_vg["call"](np.log(w), np.log(we))
    # the case saturates: rotors at the box on both sides
    u = res.u.detach()
    assert float(u.max()) > 21.99 and float(u.min()) < 0.2
    assert abs(v - vj) <= 1e-12 * abs(vj)

    def symmetric(a):
        return np.concatenate([a[:13], [a[i] + a[j] for i, j in ROTOR_PAIRS]])

    scale = np.abs(gj).max()
    assert np.abs(symmetric(g) - symmetric(gj)).max() <= 1e-9 * scale
    assert _rel(g, gj) <= 2e-3


def test_detuned_gradient_matches_jax(jax_vg, port):
    v, g, res = _port_vg(port, W_DETUNED, WE_DETUNED)
    vj, gj, _ = jax_vg["call"](np.log(W_DETUNED), np.log(WE_DETUNED))
    # inside the box: no rotor near 0 or 22 kRPM
    u = res.u.detach()
    assert 15.0 < float(u.min()) and float(u.max()) < 17.0
    assert abs(v - vj) <= 1e-13 * abs(vj)
    assert _rel(g, gj) <= 1e-8
    assert np.all(np.isfinite(g)) and g[0] < 0.0


def test_tune_diagonal_cost_matches_jax(jax_vg, port):
    """Two Adam steps of `tune_diagonal_cost` on hover_objective against
    the JAX program stepped by optax.adam (`tune_diagonal_cost`'s own
    update): every loss, the best iterate's weights."""
    import optax

    spec = ttuning.spec_with_diag_cost(port["spec"],
                                       torch.as_tensor(W_DETUNED),
                                       torch.as_tensor(WE_DETUNED))
    cfg = tcl.LoopConfig(ipm=tipm.IPMConfig(iters=ITERS))
    res = ttuning.tune_diagonal_cost(
        spec, lambda s: tcl.hover_regulation(s, port["x0"], steps=TICKS,
                                             config=cfg),
        ttuning.hover_objective(SETPOINT), iters=2, lr=0.15)

    theta = (jnp.log(W_DETUNED), jnp.log(WE_DETUNED))
    opt = optax.adam(0.15)
    state = opt.init(theta)
    want, thetas = [], [theta]
    for _ in range(2):
        v, gw, gwe = jax_vg["call"](*theta, settle=4.0, u_weight=1e-5)
        updates, state = opt.update((jnp.asarray(gw), jnp.asarray(gwe)),
                                    state)
        theta = optax.apply_updates(theta, updates)
        want.append(v)
        thetas.append(theta)
    want.append(jax_vg["call"](*theta, settle=4.0, u_weight=1e-5)[0])
    losses = res.losses.numpy()
    assert losses.shape == (3,)
    np.testing.assert_allclose(losses, want, rtol=1e-10)
    best = thetas[int(np.argmin(want))]
    np.testing.assert_allclose(res.w_diag.numpy(), np.exp(best[0]),
                               rtol=1e-10)
    np.testing.assert_allclose(res.we_diag.numpy(), np.exp(best[1]),
                               rtol=1e-10)
    assert float(torch.diagonal(res.spec.cost.W)[0]) == float(res.w_diag[0])


def test_adam_matches_optax():
    """torch.optim.Adam(lr) and optax.adam(lr) take the same steps on the
    same gradients (b1 0.9, b2 0.999, eps 1e-8; m-hat / (sqrt(v-hat) +
    eps))."""
    import optax

    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(17)
    grads = rng.standard_normal((6, 17)) * np.logspace(-6, 2, 17)
    p = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.Adam([p], lr=0.15)
    jx = jnp.asarray(x0)
    jopt = optax.adam(0.15)
    state = jopt.init(jx)
    for g in grads:
        p.grad = torch.as_tensor(g)
        opt.step()
        updates, state = jopt.update(jnp.asarray(g), state)
        jx = optax.apply_updates(jx, updates)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jx),
                                   rtol=1e-13, atol=1e-13)


def _jax_grad_of(fn, *args):
    return [np.asarray(a) for a in jax.grad(fn, argnums=tuple(
        range(len(args))))(*(jnp.asarray(a) for a in args))]


def _torch_grad_of(fn, *args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts)]


def _tied_step():
    """Inputs whose fraction-to-boundary ratios tie: two entries at 0.5,
    and tau * 0.5 = 1 with tau = 2."""
    v = np.array([[1.0, 1.0, 3.0]])
    dv = np.array([[-2.0, -2.0, 1.0]])
    return v, dv


def _slack_qp(lb, ub):
    """The fields of a one-stage QP (nx=1, nu=2) that `init_state`
    reads, zero but the bounds."""
    z = 0.0 * lb
    return _Fields(dict(c=z[:, :1], ru=z, lb=lb, ub=ub, qx=z[:, :1],
                        p=z[0, :1], dx0=z[0, :1]))


@pytest.mark.parametrize("case", ["ratio_tie", "tie_at_one", "slack_floor"])
def test_ipm_tie_rules_match_jax(case):
    """At a tie, min/max split the gradient half to each side in the JAX
    package (`jnp.minimum`, `jnp.maximum`, `jnp.min`); the port's step
    length and initial slacks follow it (`torch.clamp` passed all of it
    to the clamped side)."""
    if case == "slack_floor":
        # -lb and ub exactly at s_min_init = 1e-2
        lb, ub = np.array([[-1e-2, -0.5]]), np.array([[1e-2, 0.5]])

        def jfn(lb, ub):
            st = jipm.init_state(_slack_qp(lb, ub))
            return jnp.sum(st[2] * jnp.arange(1, 3)) + jnp.sum(st[3])

        def tfn(lb, ub):
            st = tipm.init_state(_slack_qp(lb, ub))
            return (st[2] * torch.arange(1, 3)).sum() + st[3].sum()

        args = (lb, ub)
    else:
        tau = 1.0 if case == "ratio_tie" else 2.0
        args = _tied_step()

        def jfn(v, dv):
            return jipm._max_step(v, dv, tau)

        def tfn(v, dv):
            return tipm._max_step(v, dv, tau)

    for got, want in zip(_torch_grad_of(tfn, *args),
                         _jax_grad_of(jfn, *args)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


class _Fields:
    def __init__(self, d):
        self.__dict__.update(d)


def test_remat_matches_stored_gradients(port):
    """LoopConfig(remat=True) recomputes each tick in the backward pass:
    the same loss and gradient as the stored-activations pass."""
    v0, g0, r0 = _port_vg(port, W_DETUNED, WE_DETUNED, settle=4.0,
                          u_weight=1e-5, ticks=5)
    v1, g1, r1 = _port_vg(port, W_DETUNED, WE_DETUNED, settle=4.0,
                          u_weight=1e-5, ticks=5, remat=True)
    assert v1 == v0
    assert torch.equal(r1.x, r0.x) and torch.equal(r1.u, r0.u)
    np.testing.assert_allclose(g1, g0, rtol=1e-12,
                               atol=1e-12 * np.abs(g0).max())


def test_remat_recomputes_the_escalation_branch(port, monkeypatch):
    """With escalation on, each tick's host branch (`ops.ipm.solve`) is
    read again when the tick is recomputed, the same way: the gradients
    equal the stored ones and every forward check is made once more in
    the backward pass.  A recomputation that took the other branch (here
    planted) raises, naming the solve (the checkpoint's own check sees
    only the saved tensors' metadata, which a re-solve need not
    change)."""
    cfg = tipm.IPMConfig(iters=ITERS, escalate_iters=5)
    kw = dict(ipm_cfg=cfg, ticks=3)
    _, g0, _ = _port_vg(port, W_DETUNED, WE_DETUNED, **kw)
    device.reset_host_syncs()
    logw = torch.log(torch.as_tensor(W_DETUNED)).requires_grad_(True)
    spec = ttuning.spec_with_diag_cost(port["spec"], torch.exp(logw),
                                       torch.as_tensor(WE_DETUNED))
    res = _port_loop(port, spec, remat=True, **kw)
    forward = device.host_syncs().get("escalation", 0)
    g1, = torch.autograd.grad(_mean_squared_error(res), logw)
    # every tick is recomputed: the loss reads each tick's applied input
    assert forward == 3
    assert device.host_syncs()["escalation"] == 2 * forward
    np.testing.assert_allclose(g1.numpy(), g0, rtol=1e-12,
                               atol=1e-12 * np.abs(g0).max())

    # the other branch on recomputation: each primary solve's mu moved
    # across the escalation tolerance
    spec = ttuning.spec_with_diag_cost(port["spec"], torch.exp(logw),
                                       torch.as_tensor(WE_DETUNED))
    res = _port_loop(port, spec, remat=True, **kw)
    real = tipm._solve

    def flipped(qp, config, *a):
        sol = real(qp, config, *a)
        if config.escalate_iters:
            mu = sol.stats["mu"]
            sol.stats["mu"] = torch.where(mu > config.escalate_mu_tol, 0.0,
                                          1.0)
        return sol

    monkeypatch.setattr(tipm, "_solve", flipped)
    with pytest.raises(RuntimeError, match="another escalation branch"):
        torch.autograd.grad(_mean_squared_error(res), logw)


def test_remat_is_part_of_the_loop_config():
    cfg = tcl.LoopConfig(remat=True)
    assert cfg.remat and convert.leaves_from_loop_config(cfg)["remat"]
