"""Body measurement on the device (counterpart of
`semantichuman_tpu/ops/measure.py`; reference: utils_SH.py:144-161
measure_body_quick): precomputed girth polylines and bone lengths."""

from __future__ import annotations

import numpy as np
import torch

from .skeleton import bone_lengths, expand_kps


def pack_girth_tables(girth_edges, girth_factors):
    """Pad ragged per-part girth polylines into dense arrays:
    (edge_idx [P, Emax, 2] int32, factors [P, Emax] f32, mask [P, Emax])."""
    n_parts = len(girth_edges)
    emax = max(len(e) for e in girth_edges)
    idx = np.zeros((n_parts, emax, 2), dtype=np.int32)
    fac = np.zeros((n_parts, emax), dtype=np.float32)
    mask = np.zeros((n_parts, emax), dtype=np.float32)
    for p in range(n_parts):
        e = np.asarray(girth_edges[p], dtype=np.int32)
        f = np.asarray(girth_factors[p],
                       dtype=np.float32).reshape(len(e), -1)[:, 0]
        idx[p, :len(e)] = e
        fac[p, :len(e)] = f
        mask[p, :len(e)] = 1.0
        # pad by repeating the last point so padded segments have length 0
        idx[p, len(e):] = e[-1]
        fac[p, len(e):] = f[-1]
    return idx, fac, mask


def girths(verts: torch.Tensor, edge_idx: torch.Tensor,
           factors: torch.Tensor) -> torch.Tensor:
    """verts [B, V, 3], edge_idx [P, E, 2], factors [P, E] -> [B, P]
    closed-polyline girths."""
    b = verts.shape[0]
    n_parts, emax = edge_idx.shape[:2]
    flat = edge_idx.long()
    p0 = verts.index_select(1, flat[..., 0].reshape(-1))
    p1 = verts.index_select(1, flat[..., 1].reshape(-1))
    p0 = p0.reshape(b, n_parts, emax, 3)
    p1 = p1.reshape(b, n_parts, emax, 3)
    f = factors.to(verts.dtype)[None, :, :, None]
    pts = p0 * (1.0 - f) + p1 * f                          # [B, P, E, 3]
    closed = torch.cat([pts, pts[:, :, :1]], dim=2)
    seg = torch.linalg.vector_norm(torch.diff(closed, dim=2), dim=-1)
    return seg.sum(dim=-1)


def measure_body(verts: torch.Tensor, j_regressor: torch.Tensor,
                 edge_idx: torch.Tensor, factors: torch.Tensor,
                 skl_list) -> torch.Tensor:
    """[B, 32]-style measure vector: girths then bone lengths."""
    g = girths(verts, edge_idx, factors)
    kps = torch.einsum("jv,bvd->bjd", j_regressor.to(verts.dtype), verts)
    return torch.cat([g, bone_lengths(expand_kps(kps), skl_list)], dim=-1)
