"""Mesh hierarchy: the multi-level QEM levels and the tables the device
model needs (the port's copy of `semantichuman_tpu/topology/hierarchy.py`
and of `MeshHierarchy` in `semantichuman_tpu/topology/compiler.py`).

`build_hierarchy` chains QSLIM decimation over ds_factors and collects per
level the vertices and faces, the downsample row selection (a gather index
vector) and the barycentric upsample gather (indices and weights)
(reference: mesh_sampling.py:229-287).  `compiler.compile_topology` turns
those levels into a `MeshHierarchy`, saved as a `.npz`.

Dummy-vertex convention: every level carries V+1 rows, the last one a zero
"dummy" vertex.  Spiral pads and out-of-part gathers already address that
row (index V), so device code never sees negative indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .deformation import upsample_transform
from .qem import qslim_decimate


@dataclass
class MeshHierarchy:
    """Everything the device model needs about one mesh topology."""
    # per level (L+1 levels)
    verts: list            # [V_l, 3] float64 template geometry
    faces: list            # [F_l, 3] int32
    sizes: list            # V_l
    spirals: list          # [V_l + 1, S_l] int32, pads resolved to V_l (dummy)
    spiral_sizes: list     # S_l
    reference_points: list  # list[list[int]] spiral anchor per level
    # per transition (L entries)
    pool_idx: list         # [V_{l+1} + 1] int32 (last entry = fine dummy V_l)
    unpool_idx: list       # [V_l + 1, 3] int32 (dummy row -> coarse dummy)
    unpool_w: list         # [V_l + 1, 3] float32
    # composed: original fine index of each coarsest-level vertex
    coarse_to_fine: np.ndarray

    @property
    def n_levels(self) -> int:
        return len(self.verts)

    def downsample_part_indices(self, part_dict: dict) -> dict:
        """Remap a {part: fine-vertex indices} dict onto the coarsest level.
        Coarse indices are ascending per part."""
        out = {}
        for name, fine_idx in part_dict.items():
            mask = np.isin(self.coarse_to_fine, np.asarray(fine_idx))
            out[name] = np.nonzero(mask)[0].astype(np.int32)
        return out

    def save(self, path: str) -> None:
        data = {"n_levels": np.array(self.n_levels)}
        for l in range(self.n_levels):
            data[f"verts_{l}"] = self.verts[l]
            data[f"faces_{l}"] = self.faces[l]
            data[f"spirals_{l}"] = self.spirals[l]
            data[f"refpts_{l}"] = np.asarray(self.reference_points[l])
        for l in range(self.n_levels - 1):
            data[f"pool_idx_{l}"] = self.pool_idx[l]
            data[f"unpool_idx_{l}"] = self.unpool_idx[l]
            data[f"unpool_w_{l}"] = self.unpool_w[l]
        data["coarse_to_fine"] = self.coarse_to_fine
        np.savez_compressed(path, **data)

    @staticmethod
    def load(path: str) -> "MeshHierarchy":
        with np.load(path, allow_pickle=False) as z:
            n = int(z["n_levels"])
            verts = [z[f"verts_{l}"] for l in range(n)]
            faces = [z[f"faces_{l}"] for l in range(n)]
            spirals = [z[f"spirals_{l}"] for l in range(n)]
            refpts = [z[f"refpts_{l}"].tolist() for l in range(n)]
            pool_idx = [z[f"pool_idx_{l}"] for l in range(n - 1)]
            unpool_idx = [z[f"unpool_idx_{l}"] for l in range(n - 1)]
            unpool_w = [z[f"unpool_w_{l}"] for l in range(n - 1)]
            coarse_to_fine = z["coarse_to_fine"]
        return MeshHierarchy(
            verts=verts, faces=faces, sizes=[len(v) for v in verts],
            spirals=spirals, spiral_sizes=[s.shape[1] for s in spirals],
            reference_points=refpts, pool_idx=pool_idx,
            unpool_idx=unpool_idx, unpool_w=unpool_w,
            coarse_to_fine=coarse_to_fine)


@dataclass
class HierarchyLevels:
    verts: list      # [L+1] arrays [V_l, 3]
    faces: list      # [L+1] arrays [F_l, 3] int32
    pool_idx: list   # [L] arrays [V_{l+1}] int64: coarse vertex -> fine index
    unpool_idx: list  # [L] arrays [V_l, 3] int32: fine vertex -> 3 coarse ids
    unpool_w: list   # [L] arrays [V_l, 3] float32 barycentric weights

    @property
    def sizes(self) -> list[int]:
        return [len(v) for v in self.verts]


def build_hierarchy(verts: np.ndarray, faces: np.ndarray,
                    ds_factors) -> HierarchyLevels:
    lv = [np.asarray(verts, dtype=np.float64)]
    lf = [np.asarray(faces, dtype=np.int32)]
    pool_idx, unpool_idx, unpool_w = [], [], []
    for factor in ds_factors:
        new_faces, keep_idx, _D = qslim_decimate(lv[-1], lf[-1],
                                                 factor=1.0 / factor)
        coarse_verts = lv[-1][keep_idx]
        _U, up_idx, up_w = upsample_transform(coarse_verts, new_faces, lv[-1])
        lv.append(coarse_verts)
        lf.append(new_faces)
        pool_idx.append(keep_idx)
        unpool_idx.append(up_idx)
        unpool_w.append(up_w)
    return HierarchyLevels(lv, lf, pool_idx, unpool_idx, unpool_w)


def build_hierarchy_from_meshes(verts: np.ndarray, faces: np.ndarray,
                                level_meshes) -> HierarchyLevels:
    """The levels from pre-decimated meshes (reference:
    mesh_sampling.py:267-287): pool selects each coarse vertex's nearest
    fine vertex; unpool is the usual barycentric transfer."""
    from scipy.spatial import cKDTree

    lv = [np.asarray(verts, dtype=np.float64)]
    lf = [np.asarray(faces, dtype=np.int32)]
    pool_idx, unpool_idx, unpool_w = [], [], []
    for cv, cf in level_meshes:
        cv = np.asarray(cv, dtype=np.float64)
        cf = np.asarray(cf, dtype=np.int32)
        _, nearest = cKDTree(lv[-1]).query(cv)
        _U, up_idx, up_w = upsample_transform(cv, cf, lv[-1])
        lv.append(cv)
        lf.append(cf)
        pool_idx.append(nearest.astype(np.int64))
        unpool_idx.append(up_idx)
        unpool_w.append(up_w)
    return HierarchyLevels(lv, lf, pool_idx, unpool_idx, unpool_w)
