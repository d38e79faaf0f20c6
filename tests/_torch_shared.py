"""Setup shared by the port's CPU test files (`tests/test_torch_*.py`).

    from _torch_shared import one_torch_thread  # noqa: F401

makes `one_torch_thread` an autouse fixture of the importing module;
`jit_o0` compiles a JAX reference program once, at XLA's optimization
level 0, and `o0` runs one that way.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These problems are too small for intra-op threads: one thread per
    worker keeps the suite's other workers from waiting on idle spins.
    numpy's BLAS (the oracle of tests/_reference_rti.py) gets one thread
    too, where threadpoolctl is installed: its default pool of one thread
    a core took 2-6 cores for the certified loops and was no faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        blas = None
    else:
        blas = threadpool_limits(limits=1, user_api="blas")
    yield
    if blas is not None:
        blas.restore_original_limits()
    torch.set_num_threads(n)


def jit_o0(fn):
    """fn jitted and compiled once, at its first call, at XLA's
    optimization level 0: these tests pay for the compile of the JAX
    reference programs (the Pallas kernels' interpret-mode ones among
    them), not for their run."""
    import jax

    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)
    return call


def o0(fn, *args):
    """fn(*args), jitted and compiled at XLA's optimization level 0."""
    return jit_o0(fn)(*args)
