"""Wavefront OBJ export (the writer of `semantichuman_tpu/topology/
obj_io.py`): triangle meshes with optional per-vertex RGB colors (the
nonstandard `v x y z r g b` form) and skeleton point strips."""

from __future__ import annotations

import numpy as np


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
