"""Generate a synthetic SMPL-scale dataset + asset bundle on disk (the
port's copy of `semantichuman_tpu/cli/make_synthetic.py`, same arguments,
same files).

Produces everything the preprocessing/training CLIs consume — per-frame OBJ
directories, and an asset dir with J_regressor.npy, vert_part_index_dict.npy,
factor_list.npy, edge_point_index_list.npy, edge_verts_index.npy (the
reference's asset contract, configure/cfgs.py:55-59) — so the full pipeline
  make_synthetic -> obj2npy -> data_generation -> train
runs end-to-end without the (license-gated) DFAUST download:

  python -m semantichuman_torch.cli.make_synthetic --out_dir D
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.assets import BodyAssets
from ..topology.adjacency import unique_edges
from ..topology.obj_io import save_obj


def run(out_dir: str, n_train: int = 64, n_test: int = 16,
        n_theta: int | None = None, n_phi: int | None = None,
        seed: int = 0) -> dict:
    assets, sh = BodyAssets.synthetic(n_theta=n_theta, n_phi=n_phi)

    asset_dir = os.path.join(out_dir, "asset")
    os.makedirs(asset_dir, exist_ok=True)
    np.save(os.path.join(asset_dir, "J_regressor.npy"), sh.J_regressor)
    np.save(os.path.join(asset_dir, "vert_part_index_dict.npy"),
            np.asarray(sh.part_dict, dtype=object))
    np.save(os.path.join(asset_dir, "factor_list.npy"),
            np.asarray(sh.girth_factors, dtype=object))
    np.save(os.path.join(asset_dir, "edge_point_index_list.npy"),
            np.asarray(sh.girth_edges, dtype=object))
    np.save(os.path.join(asset_dir, "edge_verts_index.npy"),
            unique_edges(sh.template_faces))

    for split, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        odir = os.path.join(out_dir, f"obj_{split}")
        os.makedirs(odir, exist_ok=True)
        meshes = sh.sample_meshes(n, seed=s)
        for i in range(n):
            save_obj(os.path.join(odir, f"{i:06d}.obj"), meshes[i],
                     sh.template_faces)
    return {"out_dir": out_dir, "asset_dir": asset_dir,
            "n_train": n_train, "n_test": n_test,
            "n_verts": len(sh.template_verts)}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Generate a synthetic human mesh dataset + assets.")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_train", type=int, default=64)
    ap.add_argument("--n_test", type=int, default=16)
    ap.add_argument("--n_theta", type=int, default=None,
                    help="azimuthal resolution (default: SMPL-scale 53)")
    ap.add_argument("--n_phi", type=int, default=None,
                    help="polar resolution (default: SMPL-scale 130)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    report = run(args.out_dir, args.n_train, args.n_test, args.n_theta,
                 args.n_phi, args.seed)
    for k, v in report.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
