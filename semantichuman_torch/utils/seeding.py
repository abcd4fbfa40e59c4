"""Seed plumbing (the port's copy of `semantichuman_tpu/utils/seeding.py`,
without PRNG keys): every random draw of the port comes from a NumPy or
Python generator seeded with a plain int."""

from __future__ import annotations

import numpy as np


def as_seed(seed) -> int:
    """An int, or an integer array (its last entry, as a key's), -> int."""
    if isinstance(seed, (int, np.integer)):
        return int(seed)
    arr = np.asarray(seed)
    if arr.dtype.kind in "ui" and arr.size >= 1:
        return int(arr.ravel()[-1])
    raise TypeError(f"cannot derive a seed from {seed!r}")
