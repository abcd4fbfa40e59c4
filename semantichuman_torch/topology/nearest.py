"""Nearest-point-on-mesh queries (the port's copy of
`semantichuman_tpu/topology/nearest.py`; reference usage:
mesh_sampling.py:53).

Two backends with identical results:
  * the repo's C++ AABB tree, `native/aabb.cpp` as it stands, compiled at
    first use with `g++ -O3 -std=c++17 -fPIC -shared` into
    `semantichuman_torch/_build/` (git-ignored, named by a hash of the
    source and flags) and loaded with ctypes; a build that fails raises;
  * a chunked, vectorized NumPy brute force (Ericson's closest point on a
    triangle over all faces), the plain version (`native=False`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "aabb.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


@functools.cache
def _load_native() -> ctypes.CDLL:
    """The AABB library, built first if needed; raises if it cannot be."""
    src = NATIVE_SRC.read_bytes()
    key = hashlib.sha1(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libaabb_{key}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                ["g++", *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"cannot build {NATIVE_SRC} with g++: {e}; "
                               "pass native=False for the NumPy path") \
                from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed (rc={proc.returncode}) building "
                               f"{NATIVE_SRC}:\n{proc.stderr}")
        # renamed into place: a concurrent build never loads a partial file
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.aabb_nearest.restype = None
    lib.aabb_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # verts, V
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,    # faces, F
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,   # queries, N
        ctypes.POINTER(ctypes.c_int64),                    # out face idx
        ctypes.POINTER(ctypes.c_double),                   # out points
        ctypes.POINTER(ctypes.c_double),                   # out bary
    ]
    return lib


def closest_point_on_triangles(p: np.ndarray, a: np.ndarray, b: np.ndarray,
                               c: np.ndarray):
    """Closest points on triangles (a,b,c) to points p, fully broadcast.

    All inputs broadcast to a common leading shape [...]; returns
    (closest [..., 3], bary [..., 3], sqdist [...]).
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.sum(ab * ap, axis=-1)
    d2 = np.sum(ac * ap, axis=-1)
    bp = p - b
    d3 = np.sum(ab * bp, axis=-1)
    d4 = np.sum(ac * bp, axis=-1)
    cp = p - c
    d5 = np.sum(ab * cp, axis=-1)
    d6 = np.sum(ac * cp, axis=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-300
    # interior barycentrics (used when no edge/vertex region claims the point)
    denom = va + vb + vc
    denom = np.where(np.abs(denom) < eps, 1.0, denom)
    v_in = vb / denom
    w_in = vc / denom

    t_ab = d1 / np.where(np.abs(d1 - d3) < eps, 1.0, d1 - d3)
    t_ac = d2 / np.where(np.abs(d2 - d6) < eps, 1.0, d2 - d6)
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / np.where(np.abs(den_bc) < eps, 1.0, den_bc)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    # priority: vertex regions, then edge regions, then interior
    u = np.select(
        [in_a, in_b, in_c, on_ab, on_ac, on_bc],
        [1.0, 0.0, 0.0, 1.0 - t_ab, 1.0 - t_ac, 0.0],
        default=1.0 - v_in - w_in)
    v = np.select(
        [in_a, in_b, in_c, on_ab, on_ac, on_bc],
        [0.0, 1.0, 0.0, t_ab, 0.0, 1.0 - t_bc],
        default=v_in)
    w = 1.0 - u - v

    bary = np.stack([u, v, w], axis=-1)
    closest = u[..., None] * a + v[..., None] * b + w[..., None] * c
    diff = p - closest
    sqdist = np.sum(diff * diff, axis=-1)
    return closest, bary, sqdist


def nearest_on_mesh(verts: np.ndarray, faces: np.ndarray, queries: np.ndarray,
                    chunk: int = 128, native: bool = True):
    """For each query point: (face index [N], closest point [N,3], bary
    [N,3]), through the C++ AABB tree, or with native=False the chunked
    NumPy brute force."""
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    n = len(queries)
    if len(faces) == 0:
        raise ValueError("nearest_on_mesh: mesh has no faces "
                         "(degenerate decimation level?)")
    if faces.min() < 0 or faces.max() >= len(verts):
        raise ValueError("nearest_on_mesh: face indices outside "
                         f"[0, {len(verts)})")

    out_face = np.empty(n, dtype=np.int64)
    out_pt = np.empty((n, 3), dtype=np.float64)
    out_bary = np.empty((n, 3), dtype=np.float64)
    if native:
        lib = _load_native()
        lib.aabb_nearest(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(verts),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            out_face.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_pt.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out_bary.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out_face, out_pt, out_bary

    tri_a = verts[faces[:, 0]][None]    # [1, F, 3]
    tri_b = verts[faces[:, 1]][None]
    tri_c = verts[faces[:, 2]][None]
    for s in range(0, n, chunk):
        q = queries[s:s + chunk][:, None, :]     # [P, 1, 3]
        closest, bary, sqd = closest_point_on_triangles(q, tri_a, tri_b, tri_c)
        best = np.argmin(sqd, axis=1)
        rows = np.arange(len(best))
        out_face[s:s + chunk] = best
        out_pt[s:s + chunk] = closest[rows, best]
        out_bary[s:s + chunk] = bary[rows, best]
    return out_face, out_pt, out_bary
