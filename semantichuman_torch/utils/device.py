"""Device selection: entry points run on the card unless asked otherwise."""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device.  A CUDA device on a host without
    one raises; nothing here falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


@functools.cache
def _index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def index_tensor(values, device) -> torch.Tensor:
    """A constant int64 index tensor on `device`, made once per (values,
    device): a host-to-device copy in every step would make the host wait
    for the card."""
    return _index_tensor(tuple(int(v) for v in np.asarray(values).ravel()),
                         torch.device(device))
