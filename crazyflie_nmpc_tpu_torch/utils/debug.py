"""Debug utilities (counterpart of `utils/debug.py`): the numerics plane.

The reference tolerates benign data races between ROS callbacks and
timers (acados_estimator.cpp:196-229); the functional core here removes
shared mutable state, so the debug plane is about numerics:

- `check_finite(tree, where)` raises on NaN/Inf anywhere in a tree of
  tensors with a per-leaf report;
- `finite_or_fallback(value, fallback)`: the hold-last-action guard, on
  the device (no host read);
- `assert_deterministic(fn, *args)` runs a function twice and verifies
  bitwise-identical results (the deterministic-replay property the
  closed-loop tests rely on).
"""

from __future__ import annotations

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import host_array
from crazyflie_nmpc_tpu_torch.utils import tree


def check_finite(value, where: str = "") -> None:
    """Raise FloatingPointError naming every non-finite leaf (a read of
    each leaf on the host)."""
    bad = []
    for path, leaf in tree.flatten_with_path(value):
        arr = host_array(leaf)
        if not np.all(np.isfinite(arr)):
            n = int(np.size(arr) - np.isfinite(arr).sum())
            bad.append(f"{tree.keystr(path)}: {n} non-finite")
    if bad:
        raise FloatingPointError(
            f"non-finite values{' in ' + where if where else ''}: "
            + "; ".join(bad))


def finite_or_fallback(value, fallback):
    """`value` if every leaf is finite, else `fallback`, chosen on the
    device (the hold-last-action semantics of the reference's
    failed-solve path, acados_mpc.cpp:714-717)."""
    ok = torch.ones((), dtype=torch.bool)
    for x in tree.flatten(value)[0]:
        ok = ok & torch.isfinite(torch.as_tensor(x)).all()
    return tree.tree_map(lambda v, f: torch.where(ok, v, f), value,
                         fallback)


def assert_deterministic(fn, *args, runs: int = 2) -> None:
    """Run `fn(*args)` `runs` times; raise if any result bit differs."""
    ref = tree.flatten(fn(*args))[0]
    ref = [host_array(x) for x in ref]
    for k in range(1, runs):
        out = [host_array(x) for x in tree.flatten(fn(*args))[0]]
        for i, (a, b) in enumerate(zip(ref, out)):
            if not np.array_equal(a, b, equal_nan=True):
                raise AssertionError(
                    f"run {k} differs from run 0 at leaf {i}: "
                    f"max |diff| = {np.abs(a - b).max()}")
