"""Body-asset bundle: template mesh, joint regressor, part partition and
girth-measurement tables (the port's copy of
`semantichuman_tpu/data/assets.py`; the reference's asset/ directory
contract, SURVEY.md §2.4), loaded from disk by `BodyAssets.load` or built
procedurally by `BodyAssets.synthetic`."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..topology.obj_io import load_obj


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
        """Load the reference asset layout: J_regressor.npy,
        vert_part_index_dict.npy, factor_list.npy, edge_point_index_list.npy,
        edge_verts_index.npy (reference: configure/cfgs.py:55-59).

        Real DFAUST artifacts are pickled with heterogeneous wrappers —
        J_regressor may arrive as a 0-d object array holding a scipy sparse
        matrix (the SMPL distribution format), the girth tables as object
        arrays of ragged lists — so every array is coerced to a plain dense
        numeric layout here and shape-validated against the template, with
        errors that name the offending file (the reference's bare np.load
        at main.py:27 would instead fail deep inside training)."""
        tv, tf = load_obj(template_path)
        jr_path = os.path.join(asset_dir, "J_regressor.npy")
        j = _dense_float(np.load(jr_path, allow_pickle=True), jr_path)
        if j.ndim != 2 or j.shape[1] != len(tv):
            raise ValueError(
                f"{jr_path}: expected a [n_joints, {len(tv)}] regressor "
                f"matching the template's vertex count, got {j.shape}")
        if not np.all(np.isfinite(j)):
            raise ValueError(f"{jr_path}: non-finite entries")

        pd_path = os.path.join(asset_dir, "vert_part_index_dict.npy")
        pd_raw = np.load(pd_path, allow_pickle=True)
        try:
            pd = pd_raw.item()
        except (ValueError, AttributeError):
            pd = None
        if not isinstance(pd, dict):
            raise ValueError(
                f"{pd_path}: expected a pickled dict of part-name -> vertex "
                f"indices, got {type(pd if pd is not None else pd_raw)!r}")
        part_dict = {}
        for k, v in pd.items():
            idx = np.asarray(v).reshape(-1).astype(np.int64)
            if len(idx) and (idx.min() < 0 or idx.max() >= len(tv)):
                raise ValueError(
                    f"{pd_path}: part {k!r} has vertex indices outside "
                    f"[0, {len(tv)})")
            part_dict[k] = idx

        def opt(name):
            p = os.path.join(asset_dir, name)
            return ((np.load(p, allow_pickle=True), p)
                    if os.path.exists(p) else (None, p))

        factors, f_path = opt("factor_list.npy")
        edges, e_path = opt("edge_point_index_list.npy")
        girth_edges, girth_factors = [], []
        if edges is not None:
            girth_edges = [_ragged_int(e, e_path, i, n_verts=len(tv))
                           for i, e in enumerate(_as_list(edges, e_path))]
        if factors is not None:
            girth_factors = [_ragged_float(f, f_path, i)
                             for i, f in enumerate(_as_list(factors,
                                                            f_path))]
        if girth_edges and girth_factors:
            if len(girth_edges) != len(girth_factors):
                raise ValueError(
                    f"{e_path} has {len(girth_edges)} girth tables but "
                    f"{f_path} has {len(girth_factors)}")
            for i, (e, f) in enumerate(zip(girth_edges, girth_factors)):
                if len(e) and f.size % len(e):
                    raise ValueError(
                        f"girth table {i}: {len(e)} edges vs factor block "
                        f"of {f.size} entries (not a multiple)")

        ev, ev_path = opt("edge_verts_index.npy")
        if ev is not None:
            ev = _ragged_int(ev, ev_path, 0, n_verts=len(tv))
            if ev.ndim != 2 or ev.shape[1] != 2:
                raise ValueError(
                    f"{ev_path}: expected [E, 2] edge list, got {ev.shape}")
        return BodyAssets(
            template_verts=tv, template_faces=tf, j_regressor=j,
            part_dict=part_dict, girth_edges=girth_edges,
            girth_factors=girth_factors, edge_verts=ev)

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


def _dense_float(x, path: str) -> np.ndarray:
    """Coerce npy payloads to a dense float32 matrix: unwraps 0-d object
    arrays, densifies scipy sparse matrices (the SMPL J_regressor ships as
    a pickled scipy.sparse CSC inside an object array), rejects anything
    that ends up non-numeric."""
    if isinstance(x, np.ndarray) and x.dtype == object:
        if x.ndim == 0:
            x = x.item()
        elif x.size == 1:
            x = x.reshape(()).item()
        else:
            raise ValueError(
                f"{path}: object array of shape {x.shape} where a single "
                "matrix was expected")
    if hasattr(x, "toarray"):          # scipy sparse, no scipy import needed
        x = x.toarray()
    try:
        out = np.asarray(x, dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{path}: cannot coerce {type(x)!r} to a float "
                         f"matrix: {e}") from None
    return out


def _as_list(x, path: str) -> list:
    """Unwrap an npy payload into a Python list of per-part entries
    (object array of ragged lists, 0-d object array holding a list, or a
    plain 2-d array)."""
    if isinstance(x, np.ndarray) and x.dtype == object and x.ndim == 0:
        x = x.item()
    # NOTE: uniform per-part tables arrive as one [P, ...] array (np.save
    # of same-shaped lists), ragged ones as a 1-d object array — list()
    # splits both along axis 0
    try:
        return list(x)
    except TypeError:
        raise ValueError(f"{path}: expected a sequence of per-part tables, "
                         f"got {type(x)!r}") from None


def _ragged_int(e, path: str, i: int, n_verts: int) -> np.ndarray:
    if hasattr(e, "toarray"):
        e = e.toarray()
    try:
        out = np.asarray(e, dtype=np.int64)
    except (TypeError, ValueError) as err:
        raise ValueError(f"{path}[{i}]: not an integer index table: "
                         f"{err}") from None
    if out.size and (out.min() < 0 or out.max() >= n_verts):
        raise ValueError(f"{path}[{i}]: vertex indices outside "
                         f"[0, {n_verts})")
    return out


def _ragged_float(f, path: str, i: int) -> np.ndarray:
    if hasattr(f, "toarray"):
        f = f.toarray()
    try:
        out = np.asarray(f, dtype=np.float64)
    except (TypeError, ValueError) as err:
        raise ValueError(f"{path}[{i}]: not a numeric factor table: "
                         f"{err}") from None
    if not np.all(np.isfinite(out)):
        raise ValueError(f"{path}[{i}]: non-finite factors")
    return out


def part_color_map(part_dict: dict, n_verts: int) -> np.ndarray:
    """[V, 3] per-vertex part colours; vertices outside every part stay
    neutral grey."""
    from ..constants import PARTCOLOR_LIST

    colors = np.full((n_verts, 3), 192, dtype=np.int32)
    for k, idx in enumerate(part_dict.values()):
        colors[np.asarray(idx)] = PARTCOLOR_LIST[k % len(PARTCOLOR_LIST)]
    return colors
