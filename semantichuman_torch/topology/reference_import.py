"""Import the reference's cached hierarchy pickle (the port's copy of
`semantichuman_tpu/topology/reference_import.py`).

The reference caches its QEM hierarchy as
`downsampling_matrices{dddd}.pkl` = {'M_verts_faces': [(v, f)...],
'A': [...], 'D': [scipy sparse...], 'U': [scipy sparse...], 'F': [...]}
(reference: main.py:93-116).  QSLIM heap tie-breaking makes regenerated
hierarchies machine-dependent (SURVEY.md §7.3), so DFAUST users carrying
reference checkpoints should import this pickle: the exact level meshes and
D/U transforms reproduce the exact spiral tables the checkpoints were
trained against (spirals are regenerated from the imported meshes with the
same deterministic walk).

D rows are binary vertex selectors (1 nnz/row); U rows hold ≤3 barycentric
entries.  Requires scipy only to unpickle the sparse matrices.
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np

from .compiler import _finalize, read_meta, save_cached
from .hierarchy import HierarchyLevels, MeshHierarchy


def _pool_from_D(D) -> np.ndarray:
    """[V_coarse] fine index per coarse vertex from a binary selector."""
    coo = D.tocoo()
    if coo.nnz != D.shape[0]:
        raise ValueError(
            f"reference D matrix must be a row selector (1 entry/row): "
            f"{coo.nnz} entries for {D.shape[0]} rows — transposed or "
            "corrupted pickle?")
    out = np.full(D.shape[0], -1, dtype=np.int64)
    out[coo.row] = coo.col
    if (out < 0).any():
        raise ValueError("reference D matrix has an empty row")
    return out


def _unpool_from_U(U) -> tuple[np.ndarray, np.ndarray]:
    """([V_fine, 3] coarse ids, [V_fine, 3] weights) from a ≤3-nnz/row U."""
    lil = U.tolil()
    n = U.shape[0]
    idx = np.zeros((n, 3), dtype=np.int32)
    w = np.zeros((n, 3), dtype=np.float32)
    for r in range(n):
        cols, vals = lil.rows[r], lil.data[r]
        if len(cols) > 3:
            raise ValueError(
                f"reference U row {r} has {len(cols)} entries (expected ≤3)")
        for k, (c, v) in enumerate(zip(cols, vals)):
            idx[r, k] = c
            w[r, k] = v
        for k in range(len(cols), 3):
            idx[r, k] = cols[0] if cols else 0
    return idx, w


def hierarchy_from_reference_pickle(path: str,
                                    step_sizes=(2, 2, 1, 1, 1),
                                    dilation=(2, 2, 1, 1, 1),
                                    reference_vertex: int = 414,
                                    cache_path: str | None = None
                                    ) -> MeshHierarchy:
    """downsampling_matrices pickle -> MeshHierarchy (optionally cached).

    The cache is keyed on the pickle's content hash + every parameter (same
    never-trust-a-stale-cache policy as compile_topology).  The pickle is
    the user's own reference file: unpickling runs its code, so load only
    a file you trust."""
    with open(path, "rb") as f:
        raw = f.read()
    key = repr((hashlib.sha1(raw).hexdigest()[:16], tuple(step_sizes),
                tuple(dilation), int(reference_vertex)))
    if (cache_path and os.path.exists(cache_path)
            and read_meta(cache_path) == key):
        return MeshHierarchy.load(cache_path)
    data = pickle.loads(raw)
    mvf = data["M_verts_faces"]
    verts = [np.asarray(v, dtype=np.float64) for v, _f in mvf]
    faces = [np.asarray(f, dtype=np.int32) for _v, f in mvf]
    pool_idx = [_pool_from_D(d) for d in data["D"]]
    unpool = [_unpool_from_U(u) for u in data["U"]]
    levels = HierarchyLevels(
        verts=verts, faces=faces, pool_idx=pool_idx,
        unpool_idx=[u[0] for u in unpool],
        unpool_w=[u[1] for u in unpool])
    hier = _finalize(levels, list(step_sizes), list(dilation),
                     reference_vertex)
    if cache_path:
        save_cached(hier, cache_path, key)
    return hier


def check_template_match(hier: MeshHierarchy, template_verts,
                         atol: float = 1e-5) -> None:
    """Raise if an imported hierarchy's level-0 mesh is not the template the
    assets/data pipeline are built from."""
    tv = np.asarray(template_verts)
    if hier.sizes[0] != len(tv):
        raise ValueError(
            f"reference hierarchy has {hier.sizes[0]} level-0 vertices, "
            f"template has {len(tv)} — wrong pickle for this dataset")
    if not np.allclose(hier.verts[0], tv, atol=atol):
        raise ValueError(
            "reference hierarchy's level-0 vertices differ from the "
            "template mesh — wrong pickle for this dataset")
