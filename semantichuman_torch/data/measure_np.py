"""NumPy body-measurement helpers (the port's copy of
`semantichuman_tpu/data/measure_np.py`)."""

from __future__ import annotations

import numpy as np


def _ring_perimeter(pts: np.ndarray) -> float:
    """Perimeter of the closed polyline through pts (in order)."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1).sum()
    return float(seg + np.linalg.norm(pts[0] - pts[-1]))


def girths_np(verts: np.ndarray, factor_list, edge_point_index_list) -> np.ndarray:
    """Per measured part: girth = perimeter of the closed polyline through
    edge-interpolated points  p_k = v[e_k0]*(1-f_k) + v[e_k1]*f_k."""
    out = np.empty(len(factor_list))
    for i in range(len(factor_list)):
        e = np.asarray(edge_point_index_list[i], dtype=np.int64)
        f = np.asarray(factor_list[i], dtype=np.float64).reshape(len(e), -1)
        pts = verts[e[:, 0]] * (1.0 - f) + verts[e[:, 1]] * f
        out[i] = _ring_perimeter(pts)
    return out


def bone_lengths_np(kps: np.ndarray, skl_list) -> np.ndarray:
    """Per bone: |kps[a] - far|, far = kps[b] or midpoint(kps[b1], kps[b2])."""
    out = np.empty(len(skl_list))
    for k, bone in enumerate(skl_list):
        a = kps[bone[0]]
        b = kps[bone[1]] if len(bone) == 2 else 0.5 * (kps[bone[1]] + kps[bone[2]])
        out[k] = np.linalg.norm(a - b)
    return out


def plane_girth(plane_point: np.ndarray, plane_normal: np.ndarray,
                edge_points: np.ndarray):
    """Girth as the perimeter of a plane/edge-intersection ring.

    edge_points [N, 2, 3]: endpoint pairs of mesh edges crossing the plane.
    Each edge's line meets the plane at p0 + t (p1 - p0) with
    t = (d - n·p0) / (n·(p1-p0)); edges (near-)parallel to the plane are
    dropped.  The points are sorted by angle around their centroid in the
    plane and the closed-polyline length is returned.

    Returns (girth, points [N, 3], order [N])."""
    n = np.asarray(plane_normal, np.float64)
    n = n / np.linalg.norm(n)
    p0 = np.asarray(edge_points, np.float64)[:, 0]
    d = np.asarray(edge_points, np.float64)[:, 1] - p0
    denom = d @ n
    ok = np.abs(denom) > 1e-12 * np.maximum(
        np.linalg.norm(d, axis=1), 1e-300)
    if not np.any(ok):
        raise ValueError("plane_girth: no edge crosses the plane")
    p0, d, denom = p0[ok], d[ok], denom[ok]
    t = ((np.asarray(plane_point, np.float64) - p0) @ n) / denom
    pts = p0 + t[:, None] * d

    center = pts.mean(axis=0)
    rel = pts - center
    # in-plane orthonormal basis
    a = np.cross(n, [1.0, 0.0, 0.0])
    if np.linalg.norm(a) < 1e-8:
        a = np.cross(n, [0.0, 1.0, 0.0])
    a = a / np.linalg.norm(a)
    b = np.cross(n, a)
    order = np.argsort(np.arctan2(rel @ b, rel @ a))
    return _ring_perimeter(pts[order]), pts, order
