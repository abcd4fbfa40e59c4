"""Mesh connectivity (the part of `semantichuman_tpu/topology/adjacency.py`
that the port needs)."""

from __future__ import annotations

import numpy as np


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """[E, 2] unique undirected edges (row < col), sorted lexicographically."""
    f = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0)
