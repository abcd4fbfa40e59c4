"""Quadric-error-metric (QSLIM) edge-collapse decimation (the port's copy
of `semantichuman_tpu/topology/qem.py`).

Behavioral equivalent of the reference's decimator (mesh_sampling.py:20-227):
per-vertex plane quadrics, a cost heap over candidate edges with lazy
stale-cost re-push, collapse-to-endpoint (no optimal vertex placement), and
degenerate-face removal.  The produced downsample transform is a pure
row-selection (each coarse vertex IS a surviving fine vertex), which is what
lets the device-side pool be a single gather instead of a dense matmul.

Implementation differences from the reference (deliberate, documented):
  * plane equations come from face normals rather than an SVD null-space per
    face (identical planes for non-degenerate triangles, ~100x faster);
  * merged-vertex renaming uses a union-find representative map applied on
    heap pop rather than rewriting every queue entry in place (same candidate
    set, deterministic);
  * vertex liveness is tracked incrementally instead of re-uniquing the face
    array per collapse.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp


def vertex_quadrics(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[V, 4, 4] accumulated fundamental error quadrics per vertex."""
    v = np.asarray(verts, dtype=np.float64)
    f = np.asarray(faces, dtype=np.int64)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(p1 - p0, p2 - p0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    norm = np.where(norm < 1e-12, 1.0, norm)
    n = n / norm
    d = -np.sum(n * p0, axis=1, keepdims=True)
    eq = np.concatenate([n, d], axis=1)                      # [F, 4]
    quad = eq[:, :, None] * eq[:, None, :]                   # [F, 4, 4]
    Qv = np.zeros((len(v), 4, 4), dtype=np.float64)
    for k in range(3):
        np.add.at(Qv, f[:, k], quad)
    return Qv


def _pair_cost(Qv, verts, r, c):
    Qsum = Qv[r] + Qv[c]
    p1 = np.append(verts[r], 1.0)
    p2 = np.append(verts[c], 1.0)
    cost_keep_r = float(p1 @ Qsum @ p1)   # error if collapsing onto r
    cost_keep_c = float(p2 @ Qsum @ p2)   # error if collapsing onto c
    return min(cost_keep_r, cost_keep_c), cost_keep_r, cost_keep_c, Qsum


def qslim_decimate(verts: np.ndarray, faces: np.ndarray,
                   factor: float | None = None,
                   n_verts_desired: int | None = None):
    """Decimate to ceil(V*factor) (or n_verts_desired) vertices.

    Returns (new_faces [F',3] int32 renumbered to the coarse index space,
             keep_idx [V'] int64 surviving fine-vertex indices,
             D scipy CSC [V', V] binary row-selection matrix).
    """
    from .adjacency import unique_edges

    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64).copy()
    n_verts = len(verts)
    if n_verts_desired is None:
        if factor is None:
            raise ValueError("need factor or n_verts_desired")
        n_verts_desired = int(np.ceil(n_verts * factor))

    Qv = vertex_quadrics(verts, faces)

    rep = np.arange(n_verts)

    def find(i: int) -> int:
        root = i
        while rep[root] != root:
            root = rep[root]
        while rep[i] != root:       # path compression
            rep[i], i = root, rep[i]
        return root

    heap: list[tuple[float, tuple[int, int]]] = []
    for r, c in unique_edges(faces):
        cost, _, _, _ = _pair_cost(Qv, verts, int(r), int(c))
        heap.append((cost, (int(r), int(c))))
    heapq.heapify(heap)

    alive = np.ones(len(faces), dtype=bool)
    ref_count = np.bincount(faces.ravel(), minlength=n_verts)
    n_live_verts = int(np.count_nonzero(ref_count))

    while n_live_verts > n_verts_desired and heap:
        popped_cost, (r0, c0) = heapq.heappop(heap)
        r, c = find(r0), find(c0)
        if r == c:
            continue
        cost, cost_keep_r, cost_keep_c, Qsum = _pair_cost(Qv, verts, r, c)
        if cost > popped_cost + 1e-12:
            heapq.heappush(heap, (cost, (r, c)))
            continue
        # reference keeps the endpoint with the *smaller* post-collapse error
        # (mesh_sampling.py:174-179: destroy_c_cost < destroy_r_cost → keep r)
        if cost_keep_r < cost_keep_c:
            keep, destroy = r, c
        else:
            keep, destroy = c, r
        rep[destroy] = keep
        Qv[keep] = Qsum
        Qv[destroy] = Qsum

        touched = alive & np.any(faces == destroy, axis=1)
        idx = np.nonzero(touched)[0]
        if len(idx):
            f_t = faces[idx]
            # rename destroy → keep inside touched faces
            ref_count[destroy] -= int(np.count_nonzero(f_t == destroy))
            renamed = np.where(f_t == destroy, keep, f_t)
            ref_count[keep] += int(np.count_nonzero(f_t == destroy))
            faces[idx] = renamed
            # drop faces that became degenerate
            degen = ((renamed[:, 0] == renamed[:, 1])
                     | (renamed[:, 1] == renamed[:, 2])
                     | (renamed[:, 2] == renamed[:, 0]))
            dead = idx[degen]
            if len(dead):
                alive[dead] = False
                np.subtract.at(ref_count, faces[dead].ravel(), 1)
        n_live_verts = int(np.count_nonzero(ref_count > 0))

    live_faces = faces[alive]
    keep_idx = np.unique(live_faces.ravel())
    remap = np.full(n_verts, -1, dtype=np.int64)
    remap[keep_idx] = np.arange(len(keep_idx))
    new_faces = remap[live_faces].astype(np.int32)

    data = np.ones(len(keep_idx))
    D = sp.csc_matrix(
        (data, (np.arange(len(keep_idx)), keep_idx)),
        shape=(len(keep_idx), n_verts))
    return new_faces, keep_idx, D
