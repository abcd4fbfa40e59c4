"""Geometry ops of the loss stack: pairwise distance matrices, face edge
lengths, signed part volumes (counterpart of
`semantichuman_tpu/ops/distance.py`)."""

from __future__ import annotations

import torch


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


def face_edge_lengths(verts: torch.Tensor,
                      faces: torch.Tensor) -> torch.Tensor:
    """[B, V, 3], faces [F, 3] int64 -> [B, 3, F] lengths of the edges
    (AB, BC, AC)."""
    a = verts.index_select(1, faces[:, 0])
    b = verts.index_select(1, faces[:, 1])
    c = verts.index_select(1, faces[:, 2])
    ab = torch.linalg.vector_norm(a - b, dim=-1)
    bc = torch.linalg.vector_norm(b - c, dim=-1)
    ac = torch.linalg.vector_norm(a - c, dim=-1)
    return torch.stack([ab, bc, ac], dim=1)


def signed_part_volumes(verts: torch.Tensor, faces: torch.Tensor,
                        face_part_mask: torch.Tensor) -> torch.Tensor:
    """[B, V, 3] -> [B, P] signed volume per part: vol_f = (v0 x v1) . v2
    summed over the faces wholly inside each part; face_part_mask [F, P]
    one-hot (all-zero rows for faces that straddle parts)."""
    v0 = verts.index_select(1, faces[:, 0])
    v1 = verts.index_select(1, faces[:, 1])
    v2 = verts.index_select(1, faces[:, 2])
    vol_f = torch.sum(torch.linalg.cross(v0, v1, dim=-1) * v2, dim=-1)
    return torch.einsum("bf,fp->bp", vol_f, face_part_mask.to(vol_f.dtype))
