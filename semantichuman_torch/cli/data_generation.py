"""Split stacked npy arrays into the per-sample training layout (the
port's copy of `semantichuman_tpu/cli/data_generation.py`, same arguments,
same files).

  python -m semantichuman_torch.cli.data_generation -r D --n_val 8

Capability parity with the reference's data_generation.py (:23-82): explodes
preprocessed/{train,test}.npy into points_{train,val,test}/NNNNNN.npy (+
measure_* dirs when measurements exist) and writes paths_{split}.npy name
indexes. The last `n_val` train samples become the val split.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _explode(pre: str, split: str, verts: np.ndarray,
             measures: np.ndarray | None, start: int = 0) -> list[str]:
    pdir = os.path.join(pre, f"points_{split}")
    os.makedirs(pdir, exist_ok=True)
    if measures is not None:
        mdir = os.path.join(pre, f"measure_{split}")
        os.makedirs(mdir, exist_ok=True)
    names = []
    for i in range(len(verts)):
        name = str(start + i).zfill(6)
        np.save(os.path.join(pdir, name + ".npy"),
                verts[i].astype(np.float32))
        if measures is not None:
            np.save(os.path.join(mdir, name + ".npy"),
                    measures[i].astype(np.float32))
        names.append(name)
    np.save(os.path.join(pre, f"paths_{split}.npy"), np.asarray(names))
    return names


def run(root_dir: str, n_val: int = 0) -> dict:
    pre = os.path.join(root_dir, "preprocessed")
    train = np.load(os.path.join(pre, "train.npy"), mmap_mode="r")
    mpath = os.path.join(pre, "train_measurements.npy")
    measures = np.load(mpath) if os.path.exists(mpath) else None
    if n_val < 0 or n_val >= len(train):
        raise ValueError(f"n_val={n_val} out of range for {len(train)} "
                         "train samples")

    n_train = len(train) - n_val
    report = {}
    report["train"] = len(_explode(
        pre, "train", train[:n_train],
        None if measures is None else measures[:n_train]))
    if n_val:
        report["val"] = len(_explode(
            pre, "val", train[n_train:],
            None if measures is None else measures[n_train:],
            start=n_train))

    tpath = os.path.join(pre, "test.npy")
    if os.path.exists(tpath):
        test = np.load(tpath, mmap_mode="r")
        tm = os.path.join(pre, "test_measurements.npy")
        report["test"] = len(_explode(
            pre, "test", test,
            np.load(tm) if os.path.exists(tm) else None))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Explode stacked npy datasets into per-sample files.")
    ap.add_argument("-r", "--root_dir", required=True,
                    help="dataset root containing preprocessed/")
    ap.add_argument("--n_val", type=int, default=0,
                    help="number of trailing train samples used as val")
    args = ap.parse_args(argv)
    report = run(args.root_dir, args.n_val)
    for split, n in report.items():
        print(f"{split}: {n} samples")


if __name__ == "__main__":
    main()
