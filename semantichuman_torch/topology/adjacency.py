"""Mesh connectivity helpers (the port's copy of
`semantichuman_tpu/topology/adjacency.py`: opendr.topology's Cython
routines, reference usage mesh_sampling.py:99,119,231,247, in NumPy)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """[E, 2] unique undirected edges (row < col), sorted lexicographically."""
    f = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    return e


def vert_connectivity(n_verts: int, faces: np.ndarray) -> sp.csc_matrix:
    """Symmetric binary vertex-adjacency matrix [V, V] (CSC)."""
    e = unique_edges(faces)
    data = np.ones(len(e) * 2, dtype=np.float64)
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    return sp.csc_matrix((data, (rows, cols)), shape=(n_verts, n_verts))


def adjacency_lists(n_verts: int, faces: np.ndarray) -> list[np.ndarray]:
    """Per-vertex sorted neighbor index arrays."""
    adj = vert_connectivity(n_verts, faces).tocsr()
    return [adj.indices[adj.indptr[i]:adj.indptr[i + 1]] for i in range(n_verts)]


def triangle_lists(n_verts: int, faces: np.ndarray) -> list[list[tuple]]:
    """Per-vertex incident-triangle lists, each triangle as a (u, v, w) tuple
    in face order; lists ordered by face index (the spiral walk depends on a
    deterministic, face-ordered incidence structure)."""
    trigs: list[list[tuple]] = [[] for _ in range(n_verts)]
    for u, v, w in np.asarray(faces, dtype=np.int64):
        t = (int(u), int(v), int(w))
        trigs[t[0]].append(t)
        trigs[t[1]].append(t)
        trigs[t[2]].append(t)
    return trigs
