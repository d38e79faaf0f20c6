"""Plain reference of one closed-loop tick of the Crazyflie NMPC.

One SQP-RTI iteration of the reference OCP (generate_c_code.py:41-147)
written from the problem statement, with nothing taken from the program
under test:

  * the quaternion quadrotor ODE restated from the equations of motion
    (export_ode_model.py:85-97) and the classic ERK4 step;
  * the ERK4 map's sensitivities by complex-step differentiation (no
    variational equations, no automatic differentiation);
  * the Gauss-Newton QP of the diagonal least-squares cost on the
    uncondensed stages (no partial condensing);
  * the QP solved by the Mehrotra predictor-corrector interior-point
    method that the configuration names (its iterations, tau, initial
    point, escalation), each Newton system by a plain Riccati recursion
    with `torch.linalg.cholesky`.  Block-2 condensing eliminates states
    exactly, so in exact arithmetic the condensed and the stage-wise
    problem give the same Newton steps, step lengths and iterates;
  * the cmd_vel policy of the reference node (acados_mpc.cpp:644-670).

Tensors are batch-first: x_traj (B, N+1, 13), u_traj (B, N, 4).  Every
function takes a `Precision`: float64 is the reference; float32 with the
operands of every matrix product rounded to TF32 is the control of the
correctness check (the precision a later change to tensor cores would
bring).
"""

from __future__ import annotations

import dataclasses
import math

import torch

# physical constants (export_ode_model.py:33-42)
G0 = 9.8066
MQ = 33e-3
IXX = 1.395e-5
IYY = 1.395e-5
IZZ = 2.173e-5
CD = 7.9379e-6
CT = 3.25e-4
ARM_L = 32.5e-3
NX, NU = 13, 4

# thrust map (acados_mpc.cpp:421-425) and the firmware clamp
PWM_SCALE = 0.2685
PWM_OFFSET = 4070.3
PWM_MAX = 60000.0


def hover_speed() -> float:
    """sqrt(m g / 4 Ct), kRPM."""
    return math.sqrt(MQ * G0 / (4.0 * CT))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, to nearest
    even), the operand precision of the tensor cores' TF32 products."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    """The working dtype, and whether matrix products round their
    operands to TF32 (float32 only)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @property
    def complex_dtype(self):
        return torch.complex128 if self.dtype == torch.float64 \
            else torch.complex64

    @property
    def step(self) -> float:
        """The complex step: far below the dtype's resolution, above its
        smallest normal number."""
        return 1e-200 if self.dtype == torch.float64 else 1e-30

    def mm(self, a, b):
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def mv(self, a, v):
        return self.mm(a, v[..., None])[..., 0]


REFERENCE = Precision(torch.float64)
CONTROL_TF32 = Precision(torch.float32, tf32=True)


def ode(x, u, stack=None):
    """xdot = f(x, u), x (..., 13), u (..., 4); polynomial, so it holds
    in complex arithmetic.  `stack` joins the 13 rates on a last axis
    (torch's by default; numpy arrays pass numpy's)."""
    q1, q2, q3, q4 = x[..., 3], x[..., 4], x[..., 5], x[..., 6]
    vx, vy, vz = x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]
    w1, w2, w3, w4 = (u[..., i] * u[..., i] for i in range(4))

    dx = (vx * (2 * q1 * q1 + 2 * q2 * q2 - 1)
          - vy * (2 * q1 * q4 - 2 * q2 * q3)
          + vz * (2 * q1 * q3 + 2 * q2 * q4))
    dy = (vy * (2 * q1 * q1 + 2 * q3 * q3 - 1)
          + vx * (2 * q1 * q4 + 2 * q2 * q3)
          - vz * (2 * q1 * q2 - 2 * q3 * q4))
    dz = (vz * (2 * q1 * q1 + 2 * q4 * q4 - 1)
          - vx * (2 * q1 * q3 - 2 * q2 * q4)
          + vy * (2 * q1 * q2 + 2 * q3 * q4))
    dq1 = -(q2 * wx + q3 * wy + q4 * wz) / 2
    dq2 = (q1 * wx - q4 * wy + q3 * wz) / 2
    dq3 = (q4 * wx + q1 * wy - q2 * wz) / 2
    dq4 = (q2 * wy - q3 * wx + q1 * wz) / 2
    dvx = vy * wz - vz * wy + G0 * (2 * q1 * q3 - 2 * q2 * q4)
    dvy = vz * wx - vx * wz - G0 * (2 * q1 * q2 + 2 * q3 * q4)
    dvz = (vx * wy - vy * wx - G0 * (2 * q1 * q1 + 2 * q4 * q4 - 1)
           + CT * (w1 + w2 + w3 + w4) / MQ)
    dwx = -(CT * ARM_L * (w1 + w2 - w3 - w4) - IYY * wy * wz
            + IZZ * wy * wz) / IXX
    dwy = -(CT * ARM_L * (w1 - w2 - w3 + w4) + IXX * wx * wz
            - IZZ * wx * wz) / IYY
    dwz = -(CD * (w1 - w2 + w3 - w4) - IXX * wx * wy + IYY * wx * wy) / IZZ
    rates = [dx, dy, dz, dq1, dq2, dq3, dq4, dvx, dvy, dvz, dwx, dwy, dwz]
    return stack(rates) if stack else torch.stack(rates, dim=-1)


def rk4(x, u, dt, stack=None):
    """The classic 4-stage explicit Runge-Kutta step (acados ERK)."""
    k1 = ode(x, u, stack)
    k2 = ode(x + 0.5 * dt * k1, u, stack)
    k3 = ode(x + 0.5 * dt * k2, u, stack)
    k4 = ode(x + dt * k3, u, stack)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def linearize(x, u, dt, prec: Precision):
    """F(x_k, u_k) and its Jacobians A (..., 13, 13), B (..., 13, 4) by
    complex-step differentiation, one direction at a time."""
    h = prec.step
    xc, uc = x.to(prec.complex_dtype), u.to(prec.complex_dtype)
    cols = []
    for j in range(NX + NU):
        if j < NX:
            xj = xc.clone()
            xj[..., j] += 1j * h
            cols.append(rk4(xj, uc, dt).imag / h)
        else:
            uj = uc.clone()
            uj[..., j - NX] += 1j * h
            cols.append(rk4(xc, uj, dt).imag / h)
    J = torch.stack(cols, dim=-1).to(prec.dtype)
    return rk4(x, u, dt), J[..., :NX], J[..., NX:]


def init_iterate(x0, N, dt):
    """The warm start of a fresh vehicle: hover input on every stage and
    its rollout from x0 (B, 13)."""
    B = x0.shape[0]
    u = torch.full((B, N, NU), hover_speed(), dtype=x0.dtype,
                   device=x0.device)
    xs = [x0]
    for k in range(N):
        xs.append(rk4(xs[-1], u[:, k], dt))
    return torch.stack(xs, dim=1), u


# --- the QP's Newton systems: a Riccati recursion per lane ---------------

def riccati_factor(A, Bm, q, ruu, pT, prec):
    """The matrix part of the backward Riccati pass of
        min sum_k 1/2 dx_k'diag(q_k)dx_k + 1/2 du_k'diag(ruu_k)du_k
            + 1/2 dx_N'diag(pT)dx_N + (linear terms)
        s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k:
    the feedback gains K_k, the Cholesky factors L_k of the input
    Hessians and the cost-to-go Hessians P_{k+1}, per stage."""
    N = A.shape[1]
    P = torch.diag_embed(pT)
    Ks, Ls, Ps = [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[:, k], Bm[:, k]
        Bt = Bk.transpose(-1, -2)
        PA = prec.mm(P, Ak)
        Quu = prec.mm(Bt, prec.mm(P, Bk)) + torch.diag_embed(ruu[:, k])
        Qux = prec.mm(Bt, PA)
        L = torch.linalg.cholesky(Quu)
        K = -torch.cholesky_solve(Qux, L)
        Pn = (prec.mm(Ak.transpose(-1, -2), PA)
              + prec.mm(Qux.transpose(-1, -2), K) + torch.diag_embed(q[:, k]))
        Ks[k], Ls[k], Ps[k] = K, L, P
        P = 0.5 * (Pn + Pn.transpose(-1, -2))
    return Ks, Ls, Ps


def riccati_solve(A, Bm, c, qx, ru, p_term, dx0, factors, prec):
    """The vector pass on a factorization and the forward rollout: the
    step (dx (B, N+1, 13), du (B, N, 4)) for the linear terms qx, ru,
    p_term, the dynamics residuals c and the initial deviation dx0."""
    Ks, Ls, Ps = factors
    N = A.shape[1]
    p = p_term
    kffs = [None] * N
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[:, k], Bm[:, k]
        m = p + prec.mv(Ps[k], c[:, k])
        Qu = ru[:, k] + prec.mv(Bk.transpose(-1, -2), m)
        kffs[k] = -torch.cholesky_solve(Qu[..., None], Ls[k])[..., 0]
        p = (qx[:, k] + prec.mv(Ak.transpose(-1, -2), m)
             + prec.mv(Ks[k].transpose(-1, -2), Qu))
    dx, du = [dx0], []
    for k in range(N):
        u = prec.mv(Ks[k], dx[-1]) + kffs[k]
        du.append(u)
        dx.append(prec.mv(A[:, k], dx[-1]) + prec.mv(Bm[:, k], u) + c[:, k])
    return torch.stack(dx, dim=1), torch.stack(du, dim=1)


# --- the interior-point method ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class Solver:
    """The configuration's IPM settings (their meaning is Mehrotra's
    predictor-corrector with the fraction-to-boundary rule)."""

    iters: int = 8
    tau: float = 0.995
    s_min_init: float = 1e-2
    mu0_init: float = 1.0
    escalate_iters: int = 0
    escalate_mu_tol: float = 1e-9
    escalate_capacity: int = 0
    #: the dtype the configuration states: its mu floor, 100 eps^2, stops
    #: the steps of a converged lane
    stated_dtype: torch.dtype = torch.float32

    @property
    def mu_floor(self) -> float:
        eps = torch.finfo(self.stated_dtype).eps
        return float(100.0 * eps * eps)


def _compl(lam, s, n):
    """Mean complementarity per lane of the stacked (lower, upper)
    bounds (2, B, N, 4)."""
    return (lam * s).sum(dim=(0, 2, 3)) / n


def _max_step(v, dv, tau):
    """Per lane, the largest step <= 1 that keeps v + a dv >= (1 - tau) v
    over every entry: tau times the least ratio -v/dv over dv < 0."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(tau * ratio.amin(dim=(0, 2, 3)), max=1.0)


def ipm_solve(qp: dict, solver: Solver, iters: int, prec: Precision):
    """Mehrotra's predictor-corrector on the box-constrained QP `qp`
    (stage data A, B, c; diagonal Hessians q, ruu, pT; gradients qx, ru,
    p_T; input bounds lb, ub relative to the iterate; dx0), `iters`
    iterations from the cold initial point.  Returns (dx, du, mu)."""
    A, Bm, c = qp["A"], qp["B"], qp["c"]
    lb, ub = qp["lb"], qp["ub"]
    Bsz, N = A.shape[0], A.shape[1]
    dt = prec.dtype
    bnd = torch.stack([-lb, ub])                       # (2, B, N, 4)
    n = 2 * N * NU
    s = torch.clamp(bnd, min=solver.s_min_init)
    lam = solver.mu0_init / s
    sgn = torch.tensor([1.0, -1.0], dtype=dt,
                       device=A.device)[:, None, None, None]
    z_dx = torch.zeros((Bsz, N + 1, NX), dtype=dt, device=A.device)
    z_du = torch.zeros((Bsz, N, NU), dtype=dt, device=A.device)
    r1x = qx_full(qp)
    r1u = qp["ru"] - lam[0] + lam[1]
    r2 = torch.cat([-qp["dx0"][:, None], -c], dim=1)
    r34 = bnd - s
    tiny = torch.finfo(dt).tiny
    bc = lambda v: v[:, None, None]  # noqa: E731  (B,) -> (B, 1, 1)
    for _ in range(iters):
        mu = _compl(lam, s, n)
        r5 = lam * s
        rt = (r5 + lam * r34) / s
        ruu_shift = qp["ruu"] + lam[0] / s[0] + lam[1] / s[1]
        factors = riccati_factor(A, Bm, qp["q"], ruu_shift, qp["pT"], prec)
        c_res, dx0_res = -r2[:, 1:], -r2[:, 0]
        _, ddu_a = riccati_solve(A, Bm, c_res, r1x[:, :-1],
                                 r1u + rt[0] - rt[1], r1x[:, -1], dx0_res,
                                 factors, prec)
        ds_a = sgn * ddu_a + r34
        dlam_a = -(r5 + lam * ds_a) / s
        ones = torch.cat([s, lam])
        a_aff = _max_step(ones, torch.cat([ds_a, dlam_a]), 1.0)
        mu_aff = _compl(lam + bc(a_aff) * dlam_a, s + bc(a_aff) * ds_a, n)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=tiny)) ** 3,
                            0.0, 1.0)
        r5_c = r5 - bc(sigma) * bc(mu) + ds_a * dlam_a
        rt_c = (r5_c + lam * r34) / s
        ddx, ddu = riccati_solve(A, Bm, c_res, r1x[:, :-1],
                                 r1u + rt_c[0] - rt_c[1], r1x[:, -1],
                                 dx0_res, factors, prec)
        ds = sgn * ddu + r34
        dlam = -(r5_c + lam * ds) / s
        alpha = _max_step(ones, torch.cat([ds, dlam]), solver.tau)
        alpha = torch.where(mu <= solver.mu_floor, 0.0, alpha)
        a = bc(alpha)
        z_dx = z_dx + a * ddx
        z_du = z_du + a * ddu
        s = s + a * ds
        lam = lam + a * dlam
        r1x, r1u, r2, r34 = ((1.0 - a) * r1x, (1.0 - a) * r1u,
                             (1.0 - a) * r2, (1.0 - a) * r34)
    return z_dx, z_du, _compl(lam, s, n)


def qx_full(qp):
    """The state gradients of every stage and the terminal one,
    (B, N+1, 13)."""
    return torch.cat([qp["qx"], qp["p_T"][:, None]], dim=1)


# --- one tick ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Problem:
    """The OCP's numbers: horizon, stage length, diagonal weights, input
    box."""

    N: int
    dt: float
    q: tuple
    r: tuple
    terminal_factor: float
    u_min: float
    u_max: float


def build_qp(problem: Problem, x, u, x0, yref, yref_e, prec):
    """The Gauss-Newton QP at the iterate (x (B, N+1, 13), u (B, N, 4))
    for the measured state x0 (B, 13) and the references yref
    (B, N, 17), yref_e (B, 13)."""
    dev = x.device
    q = torch.tensor(problem.q, dtype=prec.dtype, device=dev)
    r = torch.tensor(problem.r, dtype=prec.dtype, device=dev)
    pT = problem.terminal_factor * q
    B, N = u.shape[0], u.shape[1]
    x_next, A, Bm = linearize(x[:, :-1], u, problem.dt, prec)
    return dict(
        A=A, B=Bm, c=x_next - x[:, 1:],
        q=q.expand(B, N, NX), qx=q * (x[:, :-1] - yref[..., :NX]),
        ruu=r.expand(B, N, NU).clone(), ru=r * (u - yref[..., NX:]),
        pT=pT.expand(B, NX), p_T=pT * (x[:, -1] - yref_e),
        lb=problem.u_min - u, ub=problem.u_max - u, dx0=x0 - x[:, 0])


def tick_answers(problem: Problem, solver: Solver, x, u, x0, yref, yref_e,
                 prec: Precision = REFERENCE) -> dict:
    """Every answer one SQP-RTI iteration may give each lane: the plain
    solve's next iterate (x', u') and final mu, and where the
    configuration escalates, the escalation re-solve's (from the same
    cold start with `escalate_iters` iterations).  Inputs are cast to
    the precision's dtype."""
    cast = lambda t: t.to(prec.dtype)  # noqa: E731
    x, u, x0, yref, yref_e = map(cast, (x, u, x0, yref, yref_e))
    qp = build_qp(problem, x, u, x0, yref, yref_e, prec)
    dx, du, mu = ipm_solve(qp, solver, solver.iters, prec)
    out = dict(plain=(x + dx, u + du, mu), escalated=None)
    if solver.escalate_iters > 0 and solver.escalate_capacity > 0:
        dx, du, mu_e = ipm_solve(qp, solver, solver.escalate_iters, prec)
        out["escalated"] = (x + dx, u + du, mu_e)
    return out


def rti_tick(problem: Problem, solver: Solver, x, u, x0, yref, yref_e,
             prec: Precision = REFERENCE):
    """One SQP-RTI iteration as the configuration runs it: the plain
    solve, then the re-solve of the worst `escalate_capacity` lanes whose
    mu exceeds the tolerance.  Returns the next iterate (x', u')."""
    ans = tick_answers(problem, solver, x, u, x0, yref, yref_e, prec)
    x1, u1, mu = ans["plain"]
    if ans["escalated"] is not None:
        bad = mu > solver.escalate_mu_tol
        cap = min(solver.escalate_capacity, mu.shape[0])
        idx = torch.topk(torch.where(bad, mu, -torch.inf), cap).indices
        idx = idx[bad[idx]]
        x1, u1 = x1.clone(), u1.clone()
        x1[idx], u1[idx] = ans["escalated"][0][idx], ans["escalated"][1][idx]
    return x1, u1


def plant_step(x, u, dt, substeps: int = 1, prec: Precision = REFERENCE):
    """The plant: `substeps` ERK4 steps of the ODE over dt under the held
    input."""
    x, u = x.to(prec.dtype), u.to(prec.dtype)
    for _ in range(substeps):
        x = rk4(x, u, dt / substeps)
    return x


def quat_to_euler(q):
    """Unit quaternion (w, x, y, z) -> (roll, pitch, yaw) from the
    earth->body rotation matrix (acados_mpc.cpp:384-404)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r11 = 2 * (qw * qw + qx * qx) - 1
    r21 = 2 * (qx * qy - qw * qz)
    r31 = 2 * (qx * qz + qw * qy)
    r32 = 2 * (qy * qz - qw * qx)
    r33 = 2 * (qw * qw + qz * qz) - 1
    return (torch.atan2(r32, r33),
            -torch.asin(torch.clamp(r31, -1.0, 1.0)),
            torch.atan2(r21, r11))


def cmd_vel(u1, x4):
    """The reference node's command from (u1, x4) (acados_mpc.cpp:
    644-670): pitch, roll (degrees), thrust (PWM ticks, clamped to
    [0, 60000]) and yaw rate (deg/s), stacked (..., 4)."""
    q = x4[..., 3:7] / torch.linalg.vector_norm(x4[..., 3:7], dim=-1,
                                                keepdim=True)
    roll, pitch, _ = quat_to_euler(q)
    deg = 180.0 / math.pi
    thrust = (u1.mean(dim=-1) * 1000.0 - PWM_OFFSET) / PWM_SCALE
    return torch.stack([pitch * deg, -roll * deg,
                        torch.clamp(thrust, 0.0, PWM_MAX), x4[..., 12] * deg],
                       dim=-1)
