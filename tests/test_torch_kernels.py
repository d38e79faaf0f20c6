"""The port's four kernels vs the JAX package's Pallas kernels.

The plain PyTorch versions (what the wrappers run on CPU tensors) are held
against `prep_condense2`, `kkt_sweep_c2`, `corrector_sweep_c2` and
`expand2` run in Pallas interpret mode, float64, N=10 (M=5), B=8, on the
same numpy inputs.  The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, which needs a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.models import hover_state
from crazyflie_nmpc_tpu.ops.pallas import condensed_kernels as jck
from crazyflie_nmpc_tpu.ops.pallas import prep_kernel as jpk
from crazyflie_nmpc_tpu.solver import default_ocp, hover_yref, init_rti
from crazyflie_nmpc_tpu_torch.ops.cuda import condensed_kernels as tck
from crazyflie_nmpc_tpu_torch.ops.cuda import prep_kernel as tpk
from _torch_shared import one_torch_thread  # noqa: F401

N, M, B = 10, 5, 8
PREP_OUT = ("Abar", "Bbar", "cbar", "Qbar", "S1T", "R00", "qbar", "rbar",
            "Ae", "Be", "c", "lb", "ub")
KKT_OUT = ("K", "kff", "L", "Pc", "dx", "du")


def _t(a):
    return torch.as_tensor(np.array(a))


def _flat_prep(out):
    cnd, Ae, Be, c, lb, ub = out
    return dict(cnd, Ae=Ae, Be=Be, c=c, lb=lb, ub=ub)


@pytest.fixture(scope="module")
def case():
    """Numpy inputs from a seed, every kernel run on both sides."""
    rng = np.random.default_rng(5)
    spec = default_ocp(N=N, dtype=jnp.float64)
    yref, yref_e = hover_yref(spec)
    x0s = (np.asarray(hover_state(spec.params, dtype=jnp.float64))[None]
           + 0.05 * rng.standard_normal((B, 13)))
    st = jax.vmap(lambda x: init_rti(spec, x))(jnp.asarray(x0s))
    x = np.moveaxis(np.asarray(st.x_traj), 0, -1)
    u = (np.moveaxis(np.asarray(st.u_traj), 0, -1)
         + 0.3 * rng.standard_normal((N, 4, B)))
    par = spec.params
    W = np.diagonal(np.asarray(spec.cost.W))
    tile = lambda v: np.broadcast_to(np.asarray(v, np.float64)[:, None],  # noqa: E731
                                     (len(v), B)).copy()
    k1 = (x, u, np.broadcast_to(np.asarray(yref)[:, :, None],
                                (N, 17, B)).copy(),
          tile(W[:13]), tile(W[13:]), tile(np.asarray(spec.lbu)),
          tile(np.asarray(spec.ubu)),
          tile([par.g0, par.mq, par.Ixx, par.Iyy, par.Izz, par.Cd, par.Ct,
                par.l, float(spec.dt)]))
    jprep = _flat_prep(jpk.prep_condense2(
        *map(jnp.asarray, k1), block_b=B, pairs_per_step=1, interpret=True))
    tprep = _flat_prep(tpk.prep_condense2(*map(_t, k1)))

    # sweep inputs: the condensed data plus a barrier shift and residuals
    pT = tile(50.0 * W[:13])
    k2 = (jprep["Abar"], jprep["Bbar"], jprep["cbar"], jprep["Qbar"],
          jprep["S1T"], jprep["R00"], jprep["qbar"],
          np.tile(W[13:], 2)[None, :, None]
          + rng.uniform(0.01, 1.0, (M, 8, B)),
          jprep["rbar"], pT,
          pT * (x[-1] - np.asarray(yref_e)[:, None]),
          0.01 * rng.standard_normal((13, B)))
    k2 = tuple(np.array(a) for a in k2)
    jkkt = dict(zip(KKT_OUT, jck.kkt_sweep_c2(
        *map(jnp.asarray, k2), block_b=B, stages_per_step=1,
        interpret=True)))
    tkkt = dict(zip(KKT_OUT, tck.kkt_sweep_c2(*map(_t, k2))))

    k3 = tuple(np.array(a) for a in (
        k2[0], k2[1], k2[2], k2[6],
        k2[8] + 0.1 * rng.standard_normal((M, 8, B)),
        jkkt["K"], jkkt["L"], jkkt["Pc"], k2[10], k2[11]))
    jcorr = jck.corrector_sweep_c2(*map(jnp.asarray, k3), block_b=B,
                                   stages_per_step=1, interpret=True)
    tcorr = tck.corrector_sweep_c2(*map(_t, k3))

    k4 = (jprep["Ae"], jprep["Be"], jprep["c"], np.asarray(jkkt["dx"])[:-1],
          np.asarray(jkkt["du"])[:, :4])
    k4 = tuple(np.array(a) for a in k4)
    jexp = jck.expand2(*map(jnp.asarray, k4), block_b=B, stages_per_step=1,
                       interpret=True, even_only=True)
    texp = tck.expand2(*map(_t, k4))
    return dict(prep=(jprep, tprep), kkt=(jkkt, tkkt),
                corr=(dict(dx=jcorr[0], du=jcorr[1]),
                      dict(dx=tcorr[0], du=tcorr[1])),
                exp=(jexp, texp))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", PREP_OUT)
def test_prep_condense2_plain_matches_pallas(case, name):
    jprep, tprep = case["prep"]
    _close(tprep[name], jprep[name], 1e-12)


@pytest.mark.parametrize("name", KKT_OUT)
def test_kkt_sweep_c2_plain_matches_pallas(case, name):
    jkkt, tkkt = case["kkt"]
    _close(tkkt[name], jkkt[name], 1e-10)


@pytest.mark.parametrize("name", ("dx", "du"))
def test_corrector_sweep_c2_plain_matches_pallas(case, name):
    jcorr, tcorr = case["corr"]
    _close(tcorr[name], jcorr[name], 1e-10)


def test_expand2_plain_matches_pallas(case):
    jexp, texp = case["exp"]
    _close(texp, jexp, 1e-10)


def test_packed_cholesky_matches_torch():
    """`_chol_n` packs torch.linalg.cholesky's factor column-major, and
    the packed solves invert L L^T."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((8, 8, 5))
    Q = torch.as_tensor(np.einsum("ikb,jkb->ijb", X, X)
                        + 8 * np.eye(8)[:, :, None])
    L = tck._chol_n(Q, 8)
    full = torch.linalg.cholesky(Q.permute(2, 0, 1))
    for j in range(8):
        for i in range(j, 8):
            np.testing.assert_allclose(L[tck._pk(i, j, 8)], full[:, i, j],
                                       rtol=1e-12, atol=1e-12)
    y = torch.as_tensor(rng.standard_normal((8, 3, 5)))
    sol = tck._cho_solve_n(L, y, 8)
    np.testing.assert_allclose(torch.einsum("ijb,jkb->ikb", Q, sol), y,
                               rtol=1e-10, atol=1e-10)
