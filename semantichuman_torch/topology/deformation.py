"""Barycentric upsampling transform ("deformation transfer"; the port's
copy of `semantichuman_tpu/topology/deformation.py`).

For every fine-level vertex, find the nearest point on the coarse mesh
surface and express it as a barycentric combination of the containing
triangle's vertices (reference: mesh_sampling.py:47-95).  The result is a
sparse matrix with ≤3 nonzeros per row, which the device-side unpool applies
as a 3-way weighted row gather rather than a dense matmul.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .nearest import nearest_on_mesh


def upsample_transform(coarse_verts: np.ndarray, coarse_faces: np.ndarray,
                       fine_verts: np.ndarray):
    """Returns (U csc [V_fine, V_coarse], gather_idx [V_fine,3] int32,
    gather_w [V_fine,3] float32)."""
    face_idx, _, bary = nearest_on_mesh(coarse_verts, coarse_faces, fine_verts)
    tri = np.asarray(coarse_faces, dtype=np.int64)[face_idx]   # [V_fine, 3]
    n_fine = len(fine_verts)

    rows = np.repeat(np.arange(n_fine), 3)
    cols = tri.ravel()
    vals = bary.ravel()
    U = sp.csc_matrix((vals, (rows, cols)),
                      shape=(n_fine, len(coarse_verts)))
    return U, tri.astype(np.int32), bary.astype(np.float32)
