"""Mesh hierarchy tables (the loading half of
`semantichuman_tpu/topology/compiler.py`).

The port compiles no topology: it loads the tables the device model needs
from a hierarchy `.npz` written by the JAX package's compiler, such as the
bundled `assets/topology_synth_full_2222.npz`.

Dummy-vertex convention: every level carries V+1 rows, the last one a zero
"dummy" vertex.  Spiral pads and out-of-part gathers already address that
row (index V), so device code never sees negative indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshHierarchy:
    """Everything the device model needs about one mesh topology."""
    # per level (L+1 levels)
    verts: list            # [V_l, 3] float64 template geometry
    sizes: list            # V_l
    spirals: list          # [V_l + 1, S_l] int32, pads resolved to V_l (dummy)
    spiral_sizes: list     # S_l
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

    @staticmethod
    def load(path: str) -> "MeshHierarchy":
        with np.load(path, allow_pickle=False) as z:
            n = int(z["n_levels"])
            verts = [z[f"verts_{l}"] for l in range(n)]
            spirals = [z[f"spirals_{l}"] for l in range(n)]
            pool_idx = [z[f"pool_idx_{l}"] for l in range(n - 1)]
            unpool_idx = [z[f"unpool_idx_{l}"] for l in range(n - 1)]
            unpool_w = [z[f"unpool_w_{l}"] for l in range(n - 1)]
            coarse_to_fine = z["coarse_to_fine"]
        return MeshHierarchy(
            verts=verts, sizes=[len(v) for v in verts],
            spirals=spirals, spiral_sizes=[s.shape[1] for s in spirals],
            pool_idx=pool_idx, unpool_idx=unpool_idx, unpool_w=unpool_w,
            coarse_to_fine=coarse_to_fine)
