"""Body-asset bundle: template mesh, joint regressor, part partition and
girth-measurement tables (the port's copy of
`semantichuman_tpu/data/assets.py`).  `BodyAssets.synthetic` builds the
procedural stand-in; loading the DFAUST asset files is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BodyAssets:
    template_verts: np.ndarray          # [V, 3]
    template_faces: np.ndarray          # [F, 3]
    j_regressor: np.ndarray             # [35, V]
    part_dict: dict                     # name -> fine vertex indices (17)
    girth_edges: list = field(default_factory=list)     # per measured part
    girth_factors: list = field(default_factory=list)
    edge_verts: np.ndarray | None = None                # [E, 2] mesh edges

    @staticmethod
    def load(asset_dir: str, template_path: str) -> "BodyAssets":
        raise NotImplementedError(
            "BodyAssets.load (the DFAUST asset files) is not ported yet: "
            "ROADMAP.md section 1, 'the DFAUST data path'; use "
            "data.synthetic=True")

    @staticmethod
    def synthetic(n_theta: int | None = None,
                  n_phi: int | None = None) -> tuple["BodyAssets", object]:
        """Procedural stand-in assets: (assets, SyntheticHuman)."""
        from ..topology.adjacency import unique_edges
        from .synthetic import SyntheticHuman

        sh = SyntheticHuman(n_theta=n_theta, n_phi=n_phi)
        assets = BodyAssets(
            template_verts=sh.template_verts,
            template_faces=sh.template_faces,
            j_regressor=sh.J_regressor,
            part_dict=sh.part_dict,
            girth_edges=sh.girth_edges,
            girth_factors=sh.girth_factors,
            edge_verts=unique_edges(sh.template_faces))
        return assets, sh


def part_color_map(part_dict: dict, n_verts: int) -> np.ndarray:
    """[V, 3] per-vertex part colours; vertices outside every part stay
    neutral grey."""
    from ..constants import PARTCOLOR_LIST

    colors = np.full((n_verts, 3), 192, dtype=np.int32)
    for k, idx in enumerate(part_dict.values()):
        colors[np.asarray(idx)] = PARTCOLOR_LIST[k % len(PARTCOLOR_LIST)]
    return colors
