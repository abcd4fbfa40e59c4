"""OBJ frames -> stacked npy arrays + 32-d body-measure vectors (the
port's copy of `semantichuman_tpu/cli/obj2npy.py`, same arguments, same
files).

  python -m semantichuman_torch.cli.obj2npy --save_path D \
      --trainobj_path D/obj_train --testobj_path D/obj_test \
      --asset_dir D/asset

Capability parity with the reference's obj2npy.py (:12-114): stacks sorted
per-frame OBJ meshes into preprocessed/{train,test}.npy, copies the first
train frame as template/template.obj, and computes a 32-dim measure vector
per mesh — 16 girths from precomputed edge polylines + 16 bone lengths from
J_regressor keypoints — into {train,test}_measurements.npy.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np

from ..constants import MEASURE_SKL_LIST
from ..data.measure_np import bone_lengths_np, girths_np
from ..topology.obj_io import load_obj


def stack_objs(obj_dir: str) -> tuple[np.ndarray, str]:
    paths = sorted(glob.glob(os.path.join(obj_dir, "*.obj")))
    if not paths:
        raise FileNotFoundError(f"no .obj files in {obj_dir}")
    verts = []
    n0 = None
    for p in paths:
        v, _f = load_obj(p)
        if n0 is None:
            n0 = len(v)
        elif len(v) != n0:
            raise ValueError(f"{p}: {len(v)} vertices, expected {n0} "
                             "(fixed topology required)")
        verts.append(v.astype(np.float32))
    return np.stack(verts), paths[0]


def measure_stack(verts: np.ndarray, j_regressor: np.ndarray,
                  factor_list, edge_point_index_list) -> np.ndarray:
    """[N, V, 3] -> [N, 32] (16 girths + 16 bone lengths)."""
    out = np.empty((len(verts), 32), dtype=np.float64)
    for i, v in enumerate(verts):
        g = girths_np(v, factor_list, edge_point_index_list)
        kps = j_regressor @ v
        m = bone_lengths_np(kps, MEASURE_SKL_LIST)
        out[i] = np.concatenate([g, m])
    return out


def run(save_path: str, trainobj_path: str, testobj_path: str | None,
        asset_dir: str) -> dict:
    jreg = np.load(os.path.join(asset_dir, "J_regressor.npy"),
                   allow_pickle=True)
    factor_list = np.load(os.path.join(asset_dir, "factor_list.npy"),
                          allow_pickle=True)
    edges = np.load(os.path.join(asset_dir, "edge_point_index_list.npy"),
                    allow_pickle=True)

    pre = os.path.join(save_path, "preprocessed")
    os.makedirs(pre, exist_ok=True)
    os.makedirs(os.path.join(save_path, "template"), exist_ok=True)

    report = {}
    train, first_obj = stack_objs(trainobj_path)
    np.save(os.path.join(pre, "train.npy"), train)
    shutil.copy(first_obj, os.path.join(save_path, "template",
                                        "template.obj"))
    np.save(os.path.join(pre, "train_measurements.npy"),
            measure_stack(train, jreg, factor_list, edges))
    report["train"] = train.shape

    if testobj_path:
        test, _ = stack_objs(testobj_path)
        np.save(os.path.join(pre, "test.npy"), test)
        np.save(os.path.join(pre, "test_measurements.npy"),
                measure_stack(test, jreg, factor_list, edges))
        report["test"] = test.shape
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Stack per-frame OBJ meshes into npy arrays with "
                    "32-d body measures.")
    ap.add_argument("--save_path", required=True,
                    help="dataset root (gets preprocessed/ and template/)")
    ap.add_argument("--trainobj_path", required=True,
                    help="directory of training .obj frames")
    ap.add_argument("--testobj_path", default=None,
                    help="directory of test .obj frames (optional)")
    ap.add_argument("--asset_dir", required=True,
                    help="directory with J_regressor.npy, factor_list.npy, "
                         "edge_point_index_list.npy")
    args = ap.parse_args(argv)
    report = run(args.save_path, args.trainobj_path, args.testobj_path,
                 args.asset_dir)
    for split, shape in report.items():
        print(f"{split}: {shape}")


if __name__ == "__main__":
    main()
