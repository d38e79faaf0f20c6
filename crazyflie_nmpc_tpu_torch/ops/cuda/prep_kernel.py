"""RTI preparation kernels, CUDA and plain PyTorch: the fused preparation
+ block-2 condensing (K1) and the preparation without condensing (K7),
each with the exact ERK4 matrix VDE (vde_order=4) or the order-2 midpoint
sensitivities (vde_order=2).

Counterparts of `crazyflie_nmpc_tpu/ops/pallas/prep_kernel.py:
prep_condense2` and `prep_sweep` (whose `batch_rows > 1` variant,
`_prep_sweep_2d`, computes the same outputs in the same layout).
`prep_condense2` launches `csrc/prep_condense2.cu` (32 lanes of one
stage pair a block, its tangent columns spread over 8 threads a lane; its
launch shape is `prep_launch_geometry`'s) and `prep_sweep`
`csrc/prep_sweep.cu` (one thread per lane and stage) for CUDA tensors;
CPU tensors run `prep_condense2_ref` / `prep_sweep_ref`, the CPU tests'
path and the kernels' yardstick on the card.

Layout: batch-last, every input and output contiguous with B last:
  x (N+1, 13, B), u (N, 4, B), yref (N, 17, B), q_diag (13, B),
  r_diag/lbu/ubu (4, B), params (9, B) = [g0, mq, Ixx, Iyy, Izz, Cd, Ct,
  l, dt].  Callers materialise shared tiles with `.contiguous()`.
"""

from __future__ import annotations

import torch

from crazyflie_nmpc_tpu_torch.ops.cuda import _build

NX = 13
NU = 4
NY = NX + NU
NPARAM = 9
_SOURCE = "prep_condense2.cu"
_SWEEP_SOURCE = "prep_sweep.cu"
# K1's launch shape (csrc/prep_condense2.cu's kLanes, kThreads and
# kLaneValues, which its launch checks): PREP_LANES consecutive lanes of one
# stage pair a block, PREP_THREADS threads (PREP_THREADS / PREP_LANES a
# lane), PREP_LANE_VALUES[vde_order] values of the compute dtype in shared
# memory per lane
PREP_LANES = 32
PREP_THREADS = 256
PREP_LANE_VALUES = {4: 589, 2: 397}

_CND_KEYS = ("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar", "rbar")


# --- plain PyTorch version (batch-last, stage axis leading) ---------------

def _mm(a, b):
    """(S, n, k, B) @ (S, k, m, B)."""
    return torch.einsum("sikb,skjb->sijb", a, b)


def _mtm(a, b):
    """a^T b: (S, k, n, B), (S, k, m, B) -> (S, n, m, B)."""
    return torch.einsum("skib,skjb->sijb", a, b)


def _mv(a, v):
    return torch.einsum("sikb,skb->sib", a, v)


def _mtv(a, v):
    return torch.einsum("skib,skb->sib", a, v)


def _dyn_rows(p, x, u, pi):
    """13 dynamics channels of x (S, 13, B), u (S, 4, B); p (9, B)."""
    g0, Ixx, Iyy, Izz, Cd, Ct, l = p[0], p[2], p[3], p[4], p[5], p[6], p[7]
    imq, iIxx, iIyy, iIzz = pi
    q1, q2, q3, q4 = x[:, 3], x[:, 4], x[:, 5], x[:, 6]
    vbx, vby, vbz = x[:, 7], x[:, 8], x[:, 9]
    wx, wy, wz = x[:, 10], x[:, 11], x[:, 12]
    w1, w2, w3, w4 = u[:, 0], u[:, 1], u[:, 2], u[:, 3]
    thrust = (Ct * (w1 * w1 + w2 * w2 + w3 * w3 + w4 * w4)) * imq
    return torch.stack([
        (vbx * (2 * q1 * q1 + 2 * q2 * q2 - 1)
         - vby * (2 * q1 * q4 - 2 * q2 * q3)
         + vbz * (2 * q1 * q3 + 2 * q2 * q4)),
        (vby * (2 * q1 * q1 + 2 * q3 * q3 - 1)
         + vbx * (2 * q1 * q4 + 2 * q2 * q3)
         - vbz * (2 * q1 * q2 - 2 * q3 * q4)),
        (vbz * (2 * q1 * q1 + 2 * q4 * q4 - 1)
         - vbx * (2 * q1 * q3 - 2 * q2 * q4)
         + vby * (2 * q1 * q2 + 2 * q3 * q4)),
        -(q2 * wx) / 2 - (q3 * wy) / 2 - (q4 * wz) / 2,
        (q1 * wx) / 2 - (q4 * wy) / 2 + (q3 * wz) / 2,
        (q4 * wx) / 2 + (q1 * wy) / 2 - (q2 * wz) / 2,
        (q2 * wy) / 2 - (q3 * wx) / 2 + (q1 * wz) / 2,
        vby * wz - vbz * wy + g0 * (2 * q1 * q3 - 2 * q2 * q4),
        vbz * wx - vbx * wz - g0 * (2 * q1 * q2 + 2 * q3 * q4),
        vbx * wy - vby * wx - g0 * (2 * q1 * q1 + 2 * q4 * q4 - 1) + thrust,
        -(Ct * l * (w1 * w1 + w2 * w2 - w3 * w3 - w4 * w4)
          - Iyy * wy * wz + Izz * wy * wz) * iIxx,
        -(Ct * l * (w1 * w1 - w2 * w2 - w3 * w3 + w4 * w4)
          + Ixx * wx * wz - Izz * wx * wz) * iIyy,
        -(Cd * (w1 * w1 - w2 * w2 + w3 * w3 - w4 * w4)
          - Ixx * wx * wy + Iyy * wx * wy) * iIzz,
    ], dim=1)


def _jx_dense(p, x, pi):
    """df/dx (S, 13, 13, B) from the hand-derived sparse entries."""
    g0, Ixx, Iyy, Izz = p[0], p[2], p[3], p[4]
    _, iIxx, iIyy, iIzz = pi
    q1, q2, q3, q4 = x[:, 3], x[:, 4], x[:, 5], x[:, 6]
    vbx, vby, vbz = x[:, 7], x[:, 8], x[:, 9]
    wx, wy, wz = x[:, 10], x[:, 11], x[:, 12]
    entries = {
        (0, 3): 4 * q1 * vbx - 2 * q4 * vby + 2 * q3 * vbz,
        (0, 4): 4 * q2 * vbx + 2 * q3 * vby + 2 * q4 * vbz,
        (0, 5): 2 * q2 * vby + 2 * q1 * vbz,
        (0, 6): -2 * q1 * vby + 2 * q2 * vbz,
        (0, 7): 2 * q1 * q1 + 2 * q2 * q2 - 1,
        (0, 8): -(2 * q1 * q4 - 2 * q2 * q3),
        (0, 9): 2 * q1 * q3 + 2 * q2 * q4,
        (1, 3): 4 * q1 * vby + 2 * q4 * vbx - 2 * q2 * vbz,
        (1, 4): 2 * q3 * vbx - 2 * q1 * vbz,
        (1, 5): 4 * q3 * vby + 2 * q2 * vbx + 2 * q4 * vbz,
        (1, 6): 2 * q1 * vbx + 2 * q3 * vbz,
        (1, 7): 2 * q1 * q4 + 2 * q2 * q3,
        (1, 8): 2 * q1 * q1 + 2 * q3 * q3 - 1,
        (1, 9): -(2 * q1 * q2 - 2 * q3 * q4),
        (2, 3): 4 * q1 * vbz - 2 * q3 * vbx + 2 * q2 * vby,
        (2, 4): 2 * q4 * vbx + 2 * q1 * vby,
        (2, 5): -2 * q1 * vbx + 2 * q4 * vby,
        (2, 6): 4 * q4 * vbz + 2 * q2 * vbx + 2 * q3 * vby,
        (2, 7): -(2 * q1 * q3 - 2 * q2 * q4),
        (2, 8): 2 * q1 * q2 + 2 * q3 * q4,
        (2, 9): 2 * q1 * q1 + 2 * q4 * q4 - 1,
        (3, 4): -wx / 2, (3, 5): -wy / 2, (3, 6): -wz / 2,
        (3, 10): -q2 / 2, (3, 11): -q3 / 2, (3, 12): -q4 / 2,
        (4, 3): wx / 2, (4, 5): wz / 2, (4, 6): -wy / 2,
        (4, 10): q1 / 2, (4, 11): -q4 / 2, (4, 12): q3 / 2,
        (5, 3): wy / 2, (5, 4): -wz / 2, (5, 6): wx / 2,
        (5, 10): q4 / 2, (5, 11): q1 / 2, (5, 12): -q2 / 2,
        (6, 3): wz / 2, (6, 4): wy / 2, (6, 5): -wx / 2,
        (6, 10): -q3 / 2, (6, 11): q2 / 2, (6, 12): q1 / 2,
        (7, 3): 2 * g0 * q3, (7, 4): -2 * g0 * q4, (7, 5): 2 * g0 * q1,
        (7, 6): -2 * g0 * q2,
        (7, 8): wz, (7, 9): -wy, (7, 11): -vbz, (7, 12): vby,
        (8, 3): -2 * g0 * q2, (8, 4): -2 * g0 * q1, (8, 5): -2 * g0 * q4,
        (8, 6): -2 * g0 * q3,
        (8, 7): -wz, (8, 9): wx, (8, 10): vbz, (8, 12): -vbx,
        (9, 3): -4 * g0 * q1, (9, 6): -4 * g0 * q4,
        (9, 7): wy, (9, 8): -wx, (9, 10): -vby, (9, 11): vbx,
        (10, 11): (Iyy - Izz) * wz * iIxx, (10, 12): (Iyy - Izz) * wy * iIxx,
        (11, 10): (Izz - Ixx) * wz * iIyy, (11, 12): (Izz - Ixx) * wx * iIyy,
        (12, 10): (Ixx - Iyy) * wy * iIzz, (12, 11): (Ixx - Iyy) * wx * iIzz,
    }
    J = x.new_zeros((x.shape[0], NX, NX, x.shape[-1]))
    for (i, j), v in entries.items():
        J[:, i, j] = v
    return J


def _ju_dense(p, u, pi):
    """df/du (S, 13, 4, B): rows 9..12 (rotor thrust and torques)."""
    Cd, Ct, l = p[5], p[6], p[7]
    imq, iIxx, iIyy, iIzz = pi
    tcm = 2.0 * Ct * imq
    tlx = 2.0 * Ct * l * iIxx
    tly = 2.0 * Ct * l * iIyy
    tdz = 2.0 * Cd * iIzz
    signs = ((9, tcm, (1, 1, 1, 1)), (10, tlx, (-1, -1, 1, 1)),
             (11, tly, (-1, 1, 1, -1)), (12, tdz, (-1, 1, -1, 1)))
    G = u.new_zeros((u.shape[0], NX, NU, u.shape[-1]))
    for row, coef, sg in signs:
        for j in range(NU):
            G[:, row, j] = (coef if sg[j] > 0 else -coef) * u[:, j]
    return G


def _vde_stage(p, x, u, order=4):
    """ERK4 step + sensitivities: (A (S,13,13,B), B (S,13,4,B), x_next).
    order 4: the exact matrix VDE; order 2 (`_vde_stage_o2`): the state
    still through the exact ERK4, A = I + dt J + dt^2/2 J J and
    B = dt (G + dt/2 J G) from the Jacobian J at the midpoint state x2."""
    dt = p[8]
    pi = (1.0 / p[1], 1.0 / p[2], 1.0 / p[3], 1.0 / p[4])
    eye = torch.eye(NX, dtype=x.dtype, device=x.device)[None, :, :, None]
    k1 = _dyn_rows(p, x, u, pi)
    x2 = x + 0.5 * dt * k1
    k2 = _dyn_rows(p, x2, u, pi)
    x3 = x + 0.5 * dt * k2
    k3 = _dyn_rows(p, x3, u, pi)
    x4 = x + dt * k3
    k4 = _dyn_rows(p, x4, u, pi)
    x_next = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    J2 = _jx_dense(p, x2, pi)
    G = _ju_dense(p, u, pi)
    if order == 2:
        A = eye + dt * J2 + (dt * dt / 2.0) * _mm(J2, J2)
        Bm = dt * (G + (dt / 2.0) * _mm(J2, G))
        return A, Bm, x_next
    J1 = _jx_dense(p, x, pi)
    J3 = _jx_dense(p, x3, pi)
    J4 = _jx_dense(p, x4, pi)

    K1 = J1
    K2 = _mm(J2, eye + 0.5 * dt * K1)
    K3 = _mm(J3, eye + 0.5 * dt * K2)
    K4 = _mm(J4, eye + dt * K3)
    A = eye + (dt / 6.0) * (K1 + 2 * K2 + 2 * K3 + K4)

    M1 = G
    M2 = G + _mm(J2, 0.5 * dt * M1)
    M3 = G + _mm(J3, 0.5 * dt * M2)
    M4 = G + _mm(J4, dt * M3)
    Bm = (dt / 6.0) * (M1 + 2 * M2 + 2 * M3 + M4)
    return A, Bm, x_next


def prep_condense2_ref(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu,
                       params, vde_order=4):
    """Plain PyTorch `prep_condense2` (the same math, all pairs at once)."""
    N = u_traj.shape[0]
    xe, xo, xoo = x_traj[0:N:2], x_traj[1:N:2], x_traj[2:N + 1:2]
    ue, uo = u_traj[0::2], u_traj[1::2]
    ye, yo = yref[0::2], yref[1::2]
    qd = q_diag

    A0, B0, x1p = _vde_stage(params, xe, ue, vde_order)
    A1, B1, x2p = _vde_stage(params, xo, uo, vde_order)
    c0 = x1p - xo
    c1 = x2p - xoo
    qx0 = qd * (xe - ye[:, :NX])
    qx1 = qd * (xo - yo[:, :NX])
    ru0 = r_diag * (ue - ye[:, NX:])
    ru1 = r_diag * (uo - yo[:, NX:])

    qA = qd[None, :, None, :] * A0
    qB = qd[None, :, None, :] * B0
    eye = torch.eye(NX, dtype=qd.dtype, device=qd.device)[None, :, :, None]
    h = qd * c0 + qx1
    cnd = dict(
        Abar=_mm(A1, A0),
        Bbar=torch.cat([_mm(A1, B0), B1], dim=2),
        cbar=_mv(A1, c0) + c1,
        Qbar=_mtm(A0, qA) + eye * qd[None, None],
        S1T=_mtm(B0, qA),
        R00=_mtm(B0, qB),
        qbar=qx0 + _mtv(A0, h),
        rbar=torch.cat([ru0 + _mtv(B0, h), ru1], dim=1),
    )
    c = torch.stack([c0, c1], dim=1).reshape(N, NX, -1)
    cnd = {k: v.contiguous() for k, v in cnd.items()}
    return (cnd, A0.contiguous(), B0.contiguous(), c, lbu - u_traj,
            ubu - u_traj)


def prep_sweep_ref(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu, params,
                   vde_order=4):
    """Plain PyTorch `prep_sweep` (all stages at once)."""
    x = x_traj[:-1]
    A, Bm, x_next = _vde_stage(params, x, u_traj, vde_order)
    return tuple(t.contiguous() for t in (
        A, Bm, x_next - x_traj[1:], q_diag * (x - yref[:, :NX]),
        r_diag * (u_traj - yref[:, NX:]), lbu - u_traj, ubu - u_traj))


# --- CUDA kernel wrappers --------------------------------------------------

def _vde_form(vde_order):
    """The symbol infix of the VDE order: "" for the exact ERK4 matrix VDE
    (4), "_o2" for the order-2 midpoint sensitivities."""
    if vde_order not in (2, 4):
        raise ValueError(f"vde_order={vde_order} (2 or 4)")
    return "_o2" if vde_order == 2 else ""


def prep_launch_geometry(B: int, dtype, vde_order: int = 4) -> dict:
    """K1's launch at B lanes of `dtype` (`_build.lane_geometry`); the
    grid's second dimension is the number of stage pairs."""
    _vde_form(vde_order)
    return _build.lane_geometry(B, dtype, PREP_LANES, PREP_THREADS,
                                PREP_LANE_VALUES[vde_order])


def prep_blocks_per_sm(dtype=torch.float32, vde_order: int = 4) -> int:
    """K1's resident blocks per SM (PREP_LANES lanes each)."""
    return _build.blocks_per_sm(
        _SOURCE, f"prep_condense2_occupancy{_vde_form(vde_order)}", dtype)


def prep_condense2(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu, params,
                   vde_order=4):
    """One launch from (x, u, yref) to the condensed QP data, A and B
    from the exact ERK4 matrix VDE (vde_order=4) or the order-2 midpoint
    sensitivities (vde_order=2, `_vde_stage`).

    Returns (cnd, Ae, Be, c, lb, ub): `cnd` holds Abar (M,13,13,B),
    Bbar (M,13,8,B), cbar (M,13,B), Qbar (M,13,13,B), S1T (M,4,13,B),
    R00 (M,4,4,B), qbar (M,13,B), rbar (M,8,B); Ae/Be the even-stage
    Jacobians (M,13,13,B)/(M,13,4,B); c the defect (N,13,B); lb/ub the
    bound offsets (N,4,B).  CPU tensors take the plain version.
    """
    N, _, B = u_traj.shape
    if N % 2 != 0:
        raise ValueError("prep_condense2 needs even N")
    form = _vde_form(vde_order)
    if x_traj.device.type == "cpu":
        return prep_condense2_ref(x_traj, u_traj, yref, q_diag, r_diag,
                                  lbu, ubu, params, vde_order)
    M = N // 2
    dev, dt = x_traj.device, x_traj.dtype
    new = lambda *s: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    outs = (new(M, NX, NX, B), new(M, NX, 2 * NU, B), new(M, NX, B),
            new(M, NX, NX, B), new(M, NU, NX, B), new(M, NU, NU, B),
            new(M, NX, B), new(M, 2 * NU, B),
            new(M, NX, NX, B), new(M, NX, NU, B),
            new(N, NX, B), new(N, NU, B), new(N, NU, B))
    geo = prep_launch_geometry(B, dt, vde_order)
    _build.run(prep_condense2, _SOURCE, dict(
        x=x_traj, u=u_traj, yref=yref, q_diag=q_diag, r_diag=r_diag,
        lbu=lbu, ubu=ubu, params=params), outs, dict(
        x=(N + 1, NX, B), u=(N, NU, B), yref=(N, NY, B), q_diag=(NX, B),
        r_diag=(NU, B), lbu=(NU, B), ubu=(NU, B), params=(NPARAM, B)),
        [M, B, geo["grid"], geo["threads"], geo["smem"]], form=form)
    return (dict(zip(_CND_KEYS, outs[:8])),) + outs[8:]


def prep_sweep(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu, params,
               vde_order=4):
    """One launch from (x, u, yref) to the stage-wise QP data, inputs and
    vde_order as `prep_condense2`'s, at any N.

    Returns (A (N,13,13,B), B (N,13,4,B), c (N,13,B), qx (N,13,B),
    ru (N,4,B), lb (N,4,B), ub (N,4,B)).  CPU tensors take the plain
    version.
    """
    form = _vde_form(vde_order)
    if x_traj.device.type == "cpu":
        return prep_sweep_ref(x_traj, u_traj, yref, q_diag, r_diag, lbu, ubu,
                              params, vde_order)
    N, _, B = u_traj.shape
    dev, dt = x_traj.device, x_traj.dtype
    ins = dict(x=x_traj, u=u_traj, yref=yref, q_diag=q_diag, r_diag=r_diag,
               lbu=lbu, ubu=ubu, params=params)
    _build.check("prep_sweep", ins, dict(
        x=(N + 1, NX, B), u=(N, NU, B), yref=(N, NY, B), q_diag=(NX, B),
        r_diag=(NU, B), lbu=(NU, B), ubu=(NU, B), params=(NPARAM, B)),
        dt, dev)
    new = lambda *s: torch.empty(s, dtype=dt, device=dev)  # noqa: E731
    outs = (new(N, NX, NX, B), new(N, NX, NU, B), new(N, NX, B),
            new(N, NX, B), new(N, NU, B), new(N, NU, B), new(N, NU, B))
    sfx = "f32" if dt == torch.float32 else "f64"
    _build.launch(_SWEEP_SOURCE, f"prep_sweep{form}_{sfx}",
                  list(ins.values()) + list(outs), [N, B])
    prep_sweep.launches += 1
    return outs


prep_condense2.launches = 0
prep_sweep.launches = 0
