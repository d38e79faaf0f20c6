"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

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
