"""Wavefront OBJ IO in plain NumPy (the port's copy of
`semantichuman_tpu/topology/obj_io.py`): triangle meshes with optional
per-vertex RGB colors (the nonstandard `v x y z r g b` form) and skeleton
point strips."""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Read an OBJ file. Returns (verts [V,3] float64, faces [F,3] int32).

    Quad faces are fan-triangulated; `v` lines with trailing color channels
    are accepted (colors ignored on load).
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(faces, dtype=np.int32))


def save_obj(path: str, verts, faces, vert_colors=None,
             skl_list=None, kps=None, samples_per_bone: int = 1000):
    """Write an OBJ, optionally with per-vertex colors and black skeleton
    polylines (bones rendered as dense point strips)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    lines = []
    for i, v in enumerate(verts):
        c = (192, 192, 192) if vert_colors is None else vert_colors[i]
        lines.append(f"v {v[0]:f} {v[1]:f} {v[2]:f} "
                     f"{int(c[0])} {int(c[1])} {int(c[2])}")
    if kps is not None:
        kps = np.asarray(kps, dtype=np.float64)
        if skl_list is not None:
            ts = np.linspace(0.0, 0.99, samples_per_bone)
            for bone in skl_list:
                p0 = kps[bone[0]]
                p1 = (kps[bone[1]] if len(bone) == 2
                      else 0.5 * (kps[bone[1]] + kps[bone[2]]))
                for p in p0[None] + (p1 - p0)[None] * ts[:, None]:
                    lines.append(f"v {p[0]:f} {p[1]:f} {p[2]:f} 0 0 0")
        else:
            for p in kps:
                lines.append(f"v {p[0]:f} {p[1]:f} {p[2]:f} 0 0 0")
    for f3 in faces + 1:
        lines.append(f"f {f3[0]} {f3[1]} {f3[2]}")
    with open(path, "w") as fp:
        fp.write("\n".join(lines) + "\n")


def save_skl(path: str, kps, skl_list, samples_per_bone: int = 1000):
    """Write a skeleton-only OBJ: the raw keypoints (black vertices) plus
    dense bone point strips."""
    kps = np.asarray(kps, dtype=np.float64)
    save_obj(path, kps, np.zeros((0, 3), dtype=np.int64),
             vert_colors=np.zeros((len(kps), 3), dtype=np.int32),
             skl_list=skl_list, kps=kps, samples_per_bone=samples_per_bone)
