"""Device-resident dataset (the port's counterpart of
`semantichuman_tpu/data/device_data.py`): a whole array split is staged on
the card once, normalized there once, and every batch is an on-device
index_select, so a step moves only a [B] index vector from the host.

Normalization equals the host path (`data/dataset.py:normalize_batch`):
every mode is a per-sample transform, so normalizing the whole split once
gives each batch's rows.  For train/interp sources the per-sample GT loss
inputs (face-edge lengths for the edge regularizer, part volumes for the
volume loss) are computed once over the staged split and staged too; their
bytes count in the trainer's budget (`gt_bytes`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import (face_edge_lengths, face_table,
                            signed_part_volumes)
from ..utils.device import resolve_device
from .dataset import ShapeStats

# edge-length staging cap per split ([N, 3, F] float32); a larger split
# recomputes its GT edges in the step
GT_EDGE_MAX_BYTES = 512 * 1024 * 1024


def gt_bytes(n: int, n_faces: int, n_vol_parts: int) -> int:
    """Bytes a split of n samples stages for its GT loss inputs."""
    edges = n * n_faces * 3 * 4
    return (edges if edges <= GT_EDGE_MAX_BYTES else 0) + n * n_vol_parts * 4


class DeviceDataSource:
    """One split's arrays on the device and its batch materializer."""

    def __init__(self, verts: np.ndarray, measures: np.ndarray | None,
                 normalization: str, j_regressor: np.ndarray | None = None,
                 stats: ShapeStats | None = None, device="cuda",
                 dummy_node: bool = True, gt_faces: np.ndarray | None = None,
                 gt_face_part_mask: np.ndarray | None = None):
        dev = resolve_device(device)
        self.device = dev
        self.n = len(verts)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.measures = None if measures is None else put(measures)
        v = put(verts)
        norm = normalization
        if "zeromean" in norm:
            v = v - v.mean(dim=1, keepdim=True)
        if "zeroroot" in norm:
            root = torch.einsum("v,bvd->bd", put(j_regressor[0]), v)
            v = v - root[:, None, :]
        if "onelength" in norm:
            ext = (v.amax(dim=1) - v.amin(dim=1))[:, 1]
            v = v / ext[:, None, None] * 1.5
        if "small" in norm:
            v = v / 1.5
        if "gass" in norm:
            v = (v - put(stats.mean)) / put(stats.std)
        if "normal" in norm:
            v = ((v - put(stats.center)[:self.n, None, :])
                 * put(stats.scale)[:self.n, None, :])
        v = torch.nan_to_num(v, nan=0.0)
        self.gt = None
        if gt_faces is not None:
            faces = face_table(gt_faces, v.shape[1], dev)
            gt = {}
            with torch.no_grad():
                if self.n * len(gt_faces) * 3 * 4 <= GT_EDGE_MAX_BYTES:
                    gt["gt_face_edges"] = face_edge_lengths(v, faces)
                if gt_face_part_mask is not None:
                    gt["gt_part_vols"] = signed_part_volumes(
                        v, faces, put(gt_face_part_mask))
            self.gt = gt or None
        if dummy_node:
            v = torch.cat([v, v.new_zeros((self.n, 1, v.shape[2]))], dim=1)
        self.verts = v

    def __len__(self):
        return self.n

    def batch_fn(self, idx: torch.Tensor) -> dict:
        """The batch of the int64 device index idx [B]: verts, measures
        and the staged GT loss inputs, each an index_select on the device
        (no host array is read, so a captured step can call it)."""
        out = {"verts": self.verts.index_select(0, idx)}
        if self.measures is not None:
            out["measure"] = self.measures.index_select(0, idx)
        for name, arr in (self.gt or {}).items():
            out[name] = arr.index_select(0, idx)
        return out

    def take(self, meta: dict, loader=None) -> dict:
        """One batch from index metadata (BatchLoader.iter_indices()): the
        same dict as a placed host batch.  With the BatchLoader `loader`
        that scheduled it, this process's rows of it (its process_slice)
        and their `valid` mask; `pad` stays the global batch's."""
        idx, valid = ((meta["global_idx"], meta["valid"]) if loader is None
                      else loader.local(meta))
        idx_dev = torch.as_tensor(np.asarray(idx, np.int64),
                                  device=self.device)
        return {**self.batch_fn(idx_dev), "pad": meta["pad"],
                "valid": torch.as_tensor(valid, device=self.device),
                "idx": idx, "global_idx": meta["global_idx"]}


class DeviceBatchLoader:
    """BatchLoader-shaped iterator whose batches materialize on the device;
    it reuses the host loader's schedule (seeded shuffle, drop_last,
    pad_final)."""

    def __init__(self, loader, source: DeviceDataSource):
        self.loader = loader
        self.source = source

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for meta in self.loader.iter_indices():
            yield self.source.take(meta, self.loader)

    def meta_cycle(self, anchor: int | None = None):
        """BatchLoader.cycle's endless, resume-safe schedule as index
        metadata: cycle() materializes it, and the epoch path
        (`Trainer._run_scan_chunk`) stages it on the device."""
        if anchor is not None:
            self.loader.epoch = anchor * self.loader.EPOCH_ANCHOR_STRIDE
        while True:
            yield from self.loader.iter_indices()
            self.loader.epoch += 1

    def cycle(self, anchor: int | None = None):
        """BatchLoader.cycle's endless, resume-safe schedule."""
        for meta in self.meta_cycle(anchor):
            yield self.source.take(meta, self.loader)
