"""Topology compiler: template mesh -> the tables of a `MeshHierarchy`
(the port's copy of `semantichuman_tpu/topology/compiler.py`), cached as
a `.npz` with a `.meta` sidecar that holds its compile key.

At compile time the reference's `-1` spiral pads resolve to the explicit
dummy row index V_l of each level, so device code never needs
negative-index semantics (reference: models.py:49-51,
utils_spiral.py:85-94, main.py:183-193).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .adjacency import adjacency_lists, triangle_lists
from .hierarchy import (HierarchyLevels, MeshHierarchy, build_hierarchy,
                        build_hierarchy_from_meshes)
from .spiral import generate_spirals


def topology_key(verts, faces, ds_factors, step_sizes, dilation,
                 reference_vertex: int, level_meshes=None) -> str:
    """The compile key a cached hierarchy's `.meta` sidecar holds: the
    template geometry's fingerprint and every compile parameter."""
    geom = hashlib.sha1(
        np.ascontiguousarray(np.asarray(verts, np.float64)).tobytes()
        + np.ascontiguousarray(np.asarray(faces, np.int64)).tobytes()
    ).hexdigest()[:16]
    lm_sig = (None if level_meshes is None else
              tuple((len(v), len(f)) for v, f in level_meshes))
    return repr((geom, tuple(ds_factors), tuple(step_sizes), tuple(dilation),
                 int(reference_vertex), lm_sig))


def read_meta(cache_path: str) -> str | None:
    """The compile key saved beside a cached hierarchy, None without one."""
    meta_path = cache_path + ".meta"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        return f.read()


def save_cached(hier: MeshHierarchy, cache_path: str, key: str) -> None:
    """Save a hierarchy and its compile key beside it."""
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    hier.save(cache_path)
    with open(cache_path + ".meta", "w") as f:
        f.write(key)


def compile_topology(verts: np.ndarray, faces: np.ndarray,
                     ds_factors=(2, 2, 2, 2),
                     step_sizes=(2, 2, 1, 1, 1),
                     dilation=(2, 2, 1, 1, 1),
                     reference_vertex: int = 414,
                     cache_path: str | None = None,
                     level_meshes=None) -> MeshHierarchy:
    """Compile a template mesh into a MeshHierarchy (cached as .npz).

    The cache is keyed on every compile parameter through its `.meta`
    sidecar (`topology_key`).  A cache whose key differs, or that has no
    sidecar at all, is recompiled, never trusted."""
    key = topology_key(verts, faces, ds_factors, step_sizes, dilation,
                       reference_vertex, level_meshes)
    if (cache_path and os.path.exists(cache_path)
            and read_meta(cache_path) == key):
        return MeshHierarchy.load(cache_path)

    if level_meshes is None:
        levels = build_hierarchy(verts, faces, ds_factors)
    else:
        levels = build_hierarchy_from_meshes(verts, faces, level_meshes)
    hier = _finalize(levels, step_sizes, dilation, reference_vertex)
    if cache_path:
        save_cached(hier, cache_path, key)
    return hier


def _finalize(levels: HierarchyLevels, step_sizes, dilation,
              reference_vertex: int) -> MeshHierarchy:
    n_levels = len(levels.verts)

    # spiral anchor per level: the reference vertex, then its nearest coarse
    # vertex per level (reference: main.py:161-167)
    ref_points = [[reference_vertex]]
    anchor = levels.verts[0][reference_vertex]
    for l in range(1, n_levels):
        d = np.sum((levels.verts[l] - anchor[None]) ** 2, axis=1)
        ref_points.append([int(np.argmin(d))])

    adj = [adjacency_lists(len(levels.verts[l]), levels.faces[l])
           for l in range(n_levels)]
    trigs = [triangle_lists(len(levels.verts[l]), levels.faces[l])
             for l in range(n_levels)]
    tables, spiral_sizes, _ = generate_spirals(
        list(step_sizes), levels.verts, adj, trigs, ref_points,
        dilation=list(dilation))

    # resolve -1 pads to the explicit dummy row index per level
    spirals = []
    for l, t in enumerate(tables):
        dummy = levels.sizes[l]
        spirals.append(np.where(t < 0, dummy, t).astype(np.int32))

    # pool/unpool with dummy rows appended
    pool_idx, unpool_idx, unpool_w = [], [], []
    for l in range(n_levels - 1):
        fine_dummy = levels.sizes[l]
        coarse_dummy = levels.sizes[l + 1]
        pool_idx.append(np.concatenate(
            [levels.pool_idx[l], [fine_dummy]]).astype(np.int32))
        ui = np.concatenate(
            [levels.unpool_idx[l],
             [[coarse_dummy, coarse_dummy, coarse_dummy]]]).astype(np.int32)
        uw = np.concatenate(
            [levels.unpool_w[l], [[1.0, 0.0, 0.0]]]).astype(np.float32)
        unpool_idx.append(ui)
        unpool_w.append(uw)

    # original fine index of each coarsest vertex (composed D, main.py:118-123)
    c2f = np.asarray(levels.pool_idx[-1])
    for l in range(n_levels - 3, -1, -1):
        c2f = np.asarray(levels.pool_idx[l])[c2f]

    return MeshHierarchy(
        verts=levels.verts, faces=levels.faces, sizes=levels.sizes,
        spirals=spirals, spiral_sizes=spiral_sizes,
        reference_points=ref_points, pool_idx=pool_idx,
        unpool_idx=unpool_idx, unpool_w=unpool_w,
        coarse_to_fine=c2f.astype(np.int64))
