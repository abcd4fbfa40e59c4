"""Host data pipeline (the port's copy of the array half of
`semantichuman_tpu/data/dataset.py`).

  * `ArraySource` - a batch source over an [N, V, 3] array;
  * `compute_stats`, `normalize_batch`, `unnormalize_batch` - the
    substring-matched normalization modes;
  * `BatchLoader` - seeded-shuffle batches with normalization and the dummy
    vertex, the same NumPy shuffles as the JAX package (so both see the
    same batch schedule), `set_epoch` and the resume-safe `cycle(anchor=)`;
  * `place_batch` - a host batch onto the device.

The DFAUST file layouts (`MeshData`, `FileSource`) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ShapeStats:
    mean: np.ndarray | None = None     # 'gass': per-vertex mean/std of train
    std: np.ndarray | None = None
    center: np.ndarray | None = None   # 'normal': per-sample bbox center
    scale: np.ndarray | None = None    # 'normal': per-sample 1/bbox-extent


class ArraySource:
    """Batch source over an in-memory [N, V, 3] array."""

    def __init__(self, verts: np.ndarray, measures: np.ndarray | None = None):
        self.verts = verts
        self.measures = measures

    def __len__(self):
        return len(self.verts)

    def take(self, idx: np.ndarray) -> dict:
        out = {"verts": np.asarray(self.verts[idx], dtype=np.float32),
               "idx": idx}
        if self.measures is not None:
            out["measure"] = np.asarray(self.measures[idx], dtype=np.float32)
        return out


def compute_stats(train_verts, test_verts, normalization: str) -> ShapeStats:
    """Normalization statistics (substring-matched modes compose)."""
    s = ShapeStats()
    if "gass" in normalization:
        s.mean = np.mean(train_verts, axis=0)
        std = np.std(train_verts, axis=0)
        # zero-variance coordinates map to the identity scale
        s.std = np.where(std < 1e-8, 1.0, std)
    if "normal" in normalization:
        # per-sample per-axis bbox stats of the TEST split, indexed by
        # test-sample id (the reference's quirk, kept)
        if test_verts is None:
            raise ValueError("'normal' normalization needs a test split")
        s.center = (np.max(test_verts, axis=1)
                    + np.min(test_verts, axis=1)) / 2
        s.scale = 1.0 / (np.max(test_verts, axis=1)
                         - np.min(test_verts, axis=1))
    return s


def unnormalize_batch(verts: np.ndarray, normalization: str,
                      stats: ShapeStats | None = None,
                      idx: np.ndarray | None = None) -> np.ndarray:
    """Invert the scaling modes ('gass', 'normal') on [B, V, 3] vertices
    (no dummy row), so eval metrics are true millimetres.  Rigid
    translations (zeromean / zeroroot) cancel in differences."""
    v = verts
    if "normal" in normalization:
        v = v / stats.scale[idx][:, None, :] + stats.center[idx][:, None, :]
    if "gass" in normalization:
        v = v * stats.std + stats.mean
    return v


def normalize_batch(verts: np.ndarray, normalization: str,
                    j_regressor: np.ndarray | None = None,
                    stats: ShapeStats | None = None,
                    idx: np.ndarray | None = None) -> np.ndarray:
    """Substring-matched normalization modes, vectorized over the batch."""
    v = verts
    if "zeromean" in normalization:
        v = v - np.mean(v, axis=1, keepdims=True)
    if "zeroroot" in normalization:
        root = np.einsum("v,bvd->bd", j_regressor[0], v)
        v = v - root[:, None, :]
    if "onelength" in normalization:
        ext = (np.max(v, axis=1) - np.min(v, axis=1))[:, 1]
        v = v / ext[:, None, None] * 1.5
    if "small" in normalization:
        v = v / 1.5
    if "gass" in normalization:
        v = (v - stats.mean) / stats.std
    if "normal" in normalization:
        v = (v - stats.center[idx][:, None, :]) * stats.scale[idx][:, None, :]
    return np.nan_to_num(v, nan=0.0)


class BatchLoader:
    """Seeded-shuffle batch iterator with normalization and dummy vertex."""

    # each train epoch gets its own block of shuffle-seed epochs for the
    # endless interp/exc cycle, so a run resumed at epoch E draws what the
    # uninterrupted run drew in epoch E
    EPOCH_ANCHOR_STRIDE = 1 << 16

    def __init__(self, source, batch_size: int, shuffle: bool = False,
                 seed: int = 0, normalization: str = "No",
                 j_regressor: np.ndarray | None = None,
                 stats: ShapeStats | None = None, dummy_node: bool = True,
                 drop_last: bool = False, pad_final: bool = False):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.normalization = normalization
        self.j_regressor = (None if j_regressor is None
                            else np.asarray(j_regressor, np.float32))
        self.stats = stats
        self.dummy_node = dummy_node
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.epoch = 0

    def __len__(self):
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def iter_indices(self):
        """The batch schedule only: {global_idx, pad, valid} dicts."""
        n = len(self.source)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        stop = ((n // self.batch_size) * self.batch_size if self.drop_last
                else n)
        for s in range(0, stop, self.batch_size):
            idx = order[s:s + self.batch_size]
            pad = 0
            if self.pad_final and len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            valid = np.ones(len(idx), np.float32)
            if pad:
                valid[-pad:] = 0.0
            yield {"global_idx": idx, "pad": pad, "valid": valid}

    def __iter__(self):
        for meta in self.iter_indices():
            idx = meta["global_idx"]
            batch = self.source.take(idx)
            v = normalize_batch(batch["verts"], self.normalization,
                                self.j_regressor, self.stats, idx)
            if self.dummy_node:
                z = np.zeros((v.shape[0], 1, v.shape[2]), dtype=v.dtype)
                v = np.concatenate([v, z], axis=1)
            batch["verts"] = v
            batch["pad"] = meta["pad"]
            batch["valid"] = meta["valid"]
            batch["global_idx"] = idx
            yield batch

    def cycle(self, anchor: int | None = None):
        """Endless iterator; anchor=E makes the draw sequence a pure
        function of E (resume-safe)."""
        if anchor is not None:
            self.epoch = anchor * self.EPOCH_ANCHOR_STRIDE
        while True:
            yield from self
            self.epoch += 1


def place_batch(batch: dict, device) -> dict:
    """Every numeric ndarray of a host batch except the id vectors onto
    `device` as a tensor; scalars and ids stay on the host."""
    out = {}
    for k, v in batch.items():
        if (isinstance(v, np.ndarray) and v.dtype != object
                and k not in ("idx", "global_idx")):
            out[k] = torch.as_tensor(v, device=device)
        else:
            out[k] = v
    return out
