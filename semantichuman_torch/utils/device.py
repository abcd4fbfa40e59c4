"""Device selection: entry points run on the card unless asked otherwise."""

from __future__ import annotations

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
