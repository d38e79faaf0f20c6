"""Checkpoint / resume for carried solver state (counterpart of
`utils/checkpoint.py`).

The reference has no checkpointing (SURVEY.md §5): its only persistent
state is acados' implicit warm start inside nlp_out plus the trajectory
playhead.  Here all carried state is explicit trees of tensors (RTIState,
PolicyState, EstimatorState), so checkpointing is exact: flatten to
arrays, save, restore.  A batched state (a swarm) is one file.

The file is the JAX package's: an `.npz` of `leaf_i` arrays in the
JAX leaf order (`utils.tree`) plus a `__treedef__` record that neither
side reads back.  So a state saved by either package resumes in the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from crazyflie_nmpc_tpu_torch.device import host_array
from crazyflie_nmpc_tpu_torch.utils import tree


def save_state(path: str, state) -> None:
    """Save any tree of tensors (or arrays, numbers) to an .npz."""
    leaves, _ = tree.flatten(state)
    arrays = {f"leaf_{i}": host_array(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        tree.treedef_str(state).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Restore a tree saved by save_state (by either package); `like`
    gives the structure, and each leaf's dtype and device, to rebuild
    into: typically a freshly initialized state."""
    data = np.load(path)
    leaves_like, _ = tree.flatten(like)
    leaves = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor):
            leaves.append(torch.as_tensor(arr).to(dtype=ref.dtype,
                                                  device=ref.device))
        else:
            leaves.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return tree.unflatten(like, leaves)
