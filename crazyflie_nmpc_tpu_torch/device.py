"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; raise when there is none.

    There is no silent fallback to the CPU: a caller that wants the CPU
    (the tests do) passes `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_tensor(values, dtype, device) -> torch.Tensor:
    """A small 1-D tensor of Python numbers on `device`, each entry filled
    there: unlike `torch.tensor(values, device=...)` it copies nothing
    from the host, so it never waits for the card.  A tensor is moved and
    cast instead."""
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=dtype)
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device)
                        for v in values])


def host_array(v):
    """A tensor (on any device) or array-like as a numpy array."""
    import numpy as np

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def from_host(values, dtype, device) -> torch.Tensor:
    """A host array (numpy, a list or a CPU tensor) on `device` in `dtype`.
    To the card it goes through pinned memory, copied without blocking:
    a copy from pageable memory would wait for the card's queue to
    drain.  A tensor already on `device` is only cast."""
    dev = torch.device(device)
    if isinstance(values, torch.Tensor) and values.device.type != "cpu":
        return values.to(device=dev, dtype=dtype)
    t = torch.as_tensor(values).to(dtype)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


# Host syncs the serving path makes on purpose, counted by reason: the
# emit of a tick's command and the batched solver's escalation check.
_HOST_SYNCS: dict = {}


@contextlib.contextmanager
def host_sync(reason: str):
    """Mark an intended wait on the card: it is counted under `reason`
    and let through `torch.cuda.set_sync_debug_mode`, which stays set for
    every other wait."""
    _HOST_SYNCS[reason] = _HOST_SYNCS.get(reason, 0) + 1
    mode = (torch.cuda.get_sync_debug_mode()
            if torch.cuda.is_initialized() else 0)
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def host_syncs() -> dict:
    return dict(_HOST_SYNCS)


def reset_host_syncs() -> None:
    _HOST_SYNCS.clear()
