"""Geometry ops of the loss stack: pairwise distance matrices, face edge
lengths, signed part volumes (counterpart of
`semantichuman_tpu/ops/distance.py`).  The face gathers take one gather
table of the flat face list (`face_table`) through `ops/row_gather.py`, so
their backward sums in a fixed order."""

from __future__ import annotations

import numpy as np
import torch

from .csr_reduce import csr_reduce
from .row_gather import GatherTable, gather_rows


def _pair_sq(x: torch.Tensor) -> torch.Tensor:
    """[B, n, 3] -> [B, n, n] squared distances in the Gram form
    relu(r_j - 2<x_j, x_k> + r_k)."""
    r = torch.sum(x * x, dim=2)[:, :, None]
    inner = torch.einsum("bnd,bmd->bnm", x, x)
    return torch.relu(r - 2.0 * inner + r.transpose(1, 2))


def pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """[B, n, 3] -> [B, n, n] Euclidean distances, relu-guarded against
    negative numerical residue."""
    return torch.sqrt(_pair_sq(x))


def masked_pairwise_dist(x: torch.Tensor,
                         grad_mask: torch.Tensor) -> torch.Tensor:
    """pairwise_dist with zero (not NaN) gradients wherever grad_mask is 0.

    sqrt'(0) = inf, so entries excluded from a loss are cut from the
    gradient graph before the sqrt: the double-where."""
    d2 = _pair_sq(x)
    safe = torch.where(grad_mask, d2, torch.ones_like(d2))
    return torch.where(grad_mask, torch.sqrt(safe), torch.zeros_like(d2))


def face_corners(verts: torch.Tensor, faces: GatherTable):
    """[B, V, 3] -> the three corners of every face, each [B, F, 3]: one
    gather of the flat face table (`face_table`), split."""
    g = gather_rows(verts, faces)
    g = g.reshape(g.shape[0], -1, 3, g.shape[2])
    return g[:, :, 0], g[:, :, 1], g[:, :, 2]


def face_table(faces, n_verts: int, device) -> GatherTable:
    """The gather table of faces [F, 3] over n_verts vertex rows: index
    [3F], corner-major within a face."""
    return GatherTable.build(np.asarray(faces).reshape(-1), n_verts, device)


def face_edge_lengths(verts: torch.Tensor,
                      faces: GatherTable) -> torch.Tensor:
    """[B, V, 3], faces the face table -> [B, 3, F] lengths of the edges
    (AB, BC, AC)."""
    a, b, c = face_corners(verts, faces)
    ab = torch.linalg.vector_norm(a - b, dim=-1)
    bc = torch.linalg.vector_norm(b - c, dim=-1)
    ac = torch.linalg.vector_norm(a - c, dim=-1)
    return torch.stack([ab, bc, ac], dim=1)


def signed_part_volumes(verts: torch.Tensor, faces: GatherTable,
                        face_part_mask: torch.Tensor) -> torch.Tensor:
    """[B, V, 3], faces the face table -> [B, P] signed volume per part:
    vol_f = (v0 x v1) . v2 summed over the faces wholly inside each part;
    face_part_mask [F, P] one-hot (all-zero rows for faces that straddle
    parts)."""
    v0, v1, v2 = face_corners(verts, faces)
    vol_f = torch.sum(torch.linalg.cross(v0, v1, dim=-1) * v2, dim=-1)
    return torch.einsum("bf,fp->bp", vol_f, face_part_mask.to(vol_f.dtype))


def vertex_normals(verts: torch.Tensor, faces: GatherTable) -> torch.Tensor:
    """[B, V, 3], faces the face table -> [B, V, 3] area-weighted unit
    vertex normals: each face's cross product summed into its three
    corners by the fixed-order CSR reduce over the face table's inverse."""
    v0, v1, v2 = face_corners(verts, faces)
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)           # [B, F, 3]
    per_corner = fn[:, :, None, :].expand(-1, -1, 3, -1)
    normals = csr_reduce(per_corner.reshape(fn.shape[0], -1, 3).float()
                         .contiguous(), faces.inverse)
    norm = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return normals / torch.clamp(norm, min=1e-12)


def total_mesh_volume(verts: torch.Tensor,
                      faces: GatherTable) -> torch.Tensor:
    """[B, V, 3], faces the face table -> [B] signed enclosed volumes."""
    v0, v1, v2 = face_corners(verts, faces)
    xp = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    tc = (v0 + v1 + v2) / 3.0
    return torch.sum(xp * tc / 6.0, dim=(1, 2))
