"""The port's associative-scan Riccati (`ops.riccati_pscan`) against the
JAX package's and against the port's sequential `ops.riccati`, on the CPU
in float64.

The LQ problems are `tests/test_riccati.py`'s shape (`random_lq`), made
from a seed with numpy; the three cases are that file's pscan cases
(`test_riccati.py:138-185`) at its bars: cost-to-go P and p to 1e-9, the
solve's dx and du to rtol 1e-8 / atol 1e-9, the factors' P to 1e-9 and K
to rtol 1e-8.  The hand-written scan (`associative_scan`, the recursion of
`jax.lax.associative_scan`) is also held against a sequential fold, both
directions, at lengths 1-17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu.ops import riccati_pscan as jpscan
from crazyflie_nmpc_tpu_torch.ops import riccati
from crazyflie_nmpc_tpu_torch.ops import riccati_pscan as pscan
from _torch_shared import one_torch_thread  # noqa: F401

# each JAX function compiled as one program (eager dispatch of the scan's
# many small ops compiles each of them instead)
J_COST_TO_GO = jax.jit(jpscan.cost_to_go_pscan)
J_SOLVE = jax.jit(jpscan.solve_lq_pscan)
J_FACTORS = jax.jit(jpscan.factors_pscan)
KEYS = ("A", "B", "c", "Qxx", "qx", "Ruu", "ru", "S", "P_term", "p_term",
        "dx0")


def random_lq(seed, N=8, nx=5, nu=3):
    """`test_riccati.random_lq`'s problem, drawn with numpy (float64)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    A = 0.9 * n((N, nx, nx)) / np.sqrt(nx) + 0.5 * np.eye(nx)
    Mq, Mr = n((N, nx, nx)), n((N, nu, nu))
    Mp = n((nx, nx))
    return dict(A=A, B=n((N, nx, nu)), c=0.1 * n((N, nx)),
                Qxx=Mq @ Mq.transpose(0, 2, 1) + 0.5 * np.eye(nx),
                qx=n((N, nx)),
                Ruu=Mr @ Mr.transpose(0, 2, 1) + 0.5 * np.eye(nu),
                ru=n((N, nu)), S=0.1 * n((N, nu, nx)),
                P_term=Mp @ Mp.T + 0.5 * np.eye(nx), p_term=n(nx),
                dx0=n(nx))


def port(lq):
    return {k: torch.as_tensor(v) for k, v in lq.items()}


def jax_(lq):
    return {k: jnp.asarray(v) for k, v in lq.items()}


def test_cost_to_go_matches_sequential_and_jax():
    lq = random_lq(21, N=12, nx=7, nu=3)
    t = port(lq)
    P, p = pscan.cost_to_go_pscan(*(t[k] for k in KEYS[:-1]))
    fr = riccati.factorize(t["A"], t["B"], t["Qxx"], t["Ruu"], t["S"],
                           t["P_term"])
    _, p_ref = riccati.backward_vector(fr, t["A"], t["B"], t["qx"],
                                       t["ru"], t["c"], t["p_term"])
    np.testing.assert_allclose(P.numpy(), fr.P.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(p.numpy(), p_ref.numpy(), rtol=1e-9,
                               atol=1e-9)
    j = jax_(lq)
    jP, jp = J_COST_TO_GO(*(j[k] for k in KEYS[:-1]))
    np.testing.assert_allclose(P.numpy(), np.asarray(jP), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("seed, N", [(22, 8), (23, 16), (24, 13)])
def test_solve_matches_sequential_and_jax(seed, N):
    """The log-depth solve equals the sequential one and the JAX pscan
    (N=13: an odd-length scan at every level of the recursion)."""
    lq = random_lq(seed, N=N, nx=6, nu=2)
    t = port(lq)
    dx, du = pscan.solve_lq_pscan(**t)
    dx_ref, du_ref = riccati.solve_lq(**t)
    jdx, jdu = J_SOLVE(**jax_(lq))
    for got, ref in ((dx, dx_ref.numpy()), (du, du_ref.numpy()),
                     (dx, np.asarray(jdx)), (du, np.asarray(jdu))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-9)
    assert dx.shape == (N + 1, 6) and du.shape == (N, 2)


def test_factors_match():
    lq = random_lq(24, N=10, nx=5, nu=3)
    t = port(lq)
    args = [t[k] for k in ("A", "B", "Qxx", "Ruu", "S", "P_term")]
    fr = pscan.factors_pscan(*args)
    fr_ref = riccati.factorize(*args)
    np.testing.assert_allclose(fr.P.numpy(), fr_ref.P.numpy(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(fr.K.numpy(), fr_ref.K.numpy(), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(fr.Quu_chol.numpy(),
                               fr_ref.Quu_chol.numpy(), rtol=1e-8,
                               atol=1e-9)
    jfr = J_FACTORS(*(jnp.asarray(lq[k]) for k in
                      ("A", "B", "Qxx", "Ruu", "S", "P_term")))
    np.testing.assert_allclose(fr.K.numpy(), np.asarray(jfr.K), rtol=1e-8,
                               atol=1e-9)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward",
                                                        "reverse"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 16, 17])
def test_associative_scan_is_the_inclusive_fold(n, reverse):
    """A non-commutative operator (matrix products, earlier element on
    the right) scanned by the hand-written recursion equals the
    sequential fold; reversed, each position holds the fold from it to
    the end."""
    rng = np.random.default_rng(n)
    mats = torch.as_tensor(0.5 * rng.standard_normal((n, 3, 3)))
    elems = pscan._Affine(mats, torch.zeros(n, 3, dtype=mats.dtype))
    if reverse:
        out = pscan.associative_scan(
            lambda a, b: pscan._compose(b, a), elems, reverse=True)
        want, acc = [None] * n, None
        for k in range(n - 1, -1, -1):
            acc = mats[k] if acc is None else acc @ mats[k]
            want[k] = acc
    else:
        out = pscan.associative_scan(pscan._compose, elems)
        want, acc = [], None
        for k in range(n):
            acc = mats[k] if acc is None else mats[k] @ acc
            want.append(acc)
    np.testing.assert_allclose(out.M.numpy(), torch.stack(want).numpy(),
                               rtol=1e-12, atol=1e-14)


def test_swapped_operands_give_another_answer():
    """The reverse scan's operand swap matters: without it the cost-to-go
    is wrong, so the parity above sees a swapped operand."""
    t = port(random_lq(21, N=12, nx=7, nu=3))
    args = [t[k] for k in KEYS[:-1]]
    P, _ = pscan.cost_to_go_pscan(*args)
    orig = pscan.associative_scan
    try:
        pscan.associative_scan = lambda fn, elems, reverse=False: orig(
            lambda a, b: fn(b, a), elems, reverse)
        P_bad, _ = pscan.cost_to_go_pscan(*args)
    finally:
        pscan.associative_scan = orig
    assert float((P_bad - P).abs().max()) > 1e-3
