"""The loss stack of the training step (counterpart of
`semantichuman_tpu/train/losses.py`):

  * rec       mean-L1 reconstruction
  * edgereg   per-face edge-length ratio regularizer (eps 1e-5 on the GT)
  * zpartreg  ties each non-leaf part's |z| to its girth measure
  * kps       regressed keypoints of an edited decode against the targets
  * weighted distance  orientation-weighted intra-part distance-matrix
              preservation, through the part_dist kernels
  * volume    per-part signed-volume preservation

`verts` tensors are [B, V+1, 3] with the dummy row last; "nodummy" slices
drop it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (KPS_KEEP, N_KPS_FULL, N_PARTS, NOLEAF_IN_MEASURE,
                         NOLEAF_PART_INDICES, SKL_LIST, bone_endpoint_arrays)
from ..ops.distance import face_edge_lengths, face_table, signed_part_volumes
from ..ops.row_gather import GatherTable, constant_table, gather_rows
from ..ops.part_dist import PartDistTables, fused_part_sums, part_dist_sums
from ..ops.skeleton import bone_vectors
from ..parallel.distributed import process_count
from ..parallel.mesh import all_reduce_sum
from ..utils.device import index_tensor, resolve_device


@dataclass(frozen=True)
class LossTables:
    """The static tables the losses read, on the device.  The gathers are
    `GatherTable`s (`ops/row_gather.py`): index and inverse, built once."""
    faces: GatherTable                # the [F, 3] faces as a gather of V rows
    j_regressor: torch.Tensor         # [35, V] float32
    part_indices: tuple               # 17 int32 numpy arrays (fine level)
    face_part_mask: torch.Tensor      # [F, n_noleaf] float32 one-hot
    kps_keep: GatherTable             # the 32 kept of 35 keypoints

    @property
    def device(self) -> torch.device:
        return self.j_regressor.device


def build_loss_tables(faces: np.ndarray, j_regressor: np.ndarray,
                      part_dict: dict, device="cuda") -> LossTables:
    faces = np.asarray(faces, dtype=np.int32)
    n_verts = j_regressor.shape[1]
    if faces.size and (faces.min() < 0 or faces.max() >= n_verts):
        raise ValueError(f"faces index outside [0, {n_verts})")
    part_of_vertex = np.full(n_verts, -1, dtype=np.int32)
    part_indices = []
    for k, idx in enumerate(part_dict.values()):
        part_of_vertex[np.asarray(idx)] = k
        part_indices.append(np.asarray(idx, dtype=np.int32))
    fp = part_of_vertex[faces]                    # [F, 3]
    uniform = (fp[:, 0] == fp[:, 1]) & (fp[:, 0] == fp[:, 2])
    mask = np.zeros((len(faces), len(NOLEAF_PART_INDICES)), dtype=np.float32)
    for col, p in enumerate(NOLEAF_PART_INDICES):
        mask[:, col] = uniform & (fp[:, 0] == p)
    dev = resolve_device(device)
    return LossTables(
        faces=face_table(faces, n_verts, dev),
        j_regressor=torch.as_tensor(np.asarray(j_regressor, np.float32),
                                    device=dev),
        part_indices=tuple(part_indices),
        face_part_mask=torch.as_tensor(mask, device=dev),
        kps_keep=GatherTable.build(KPS_KEEP, N_KPS_FULL, dev))


# --- primitive losses --------------------------------------------------------

def l1(a, b):
    return torch.mean(torch.abs(a - b))


def rec_loss(tx, tx_hat):
    return l1(tx, tx_hat)


def edgereg_loss(tx_nodummy, rec_nodummy, faces, gt_edges=None):
    """mean over batch/faces/edges of |rec_edge / (gt_edge + 1e-5) - 1|;
    gt_edges [B, 3, F] may be precomputed (a pure function of the data)."""
    if gt_edges is None:
        gt_edges = face_edge_lengths(tx_nodummy, faces)
    gt = gt_edges + 1e-5
    pred = face_edge_lengths(rec_nodummy, faces)
    return torch.mean(torch.abs(pred / gt - 1.0))


def zpartreg_loss(z, measure, relat: bool = True):
    """z [B, 17, nz], measure [B, 32] (16 girths + 16 lengths); the 12
    non-leaf parts against their girth columns."""
    z_norm = torch.sqrt(torch.sum(z ** 2, dim=2))
    noleaf = constant_table(NOLEAF_PART_INDICES, z.shape[1], z.device)
    zn = gather_rows(z_norm[:, :, None], noleaf)[:, :, 0]
    m = measure.index_select(1, index_tensor(NOLEAF_IN_MEASURE, z.device))
    if relat:
        return l1(zn / m, torch.ones_like(m))
    return l1(zn, m)


def regress_kps(verts_nodummy, j_regressor):
    """[B, V, 3] -> [B, 35, 3] full keypoints."""
    return torch.einsum("jv,bvd->bjd", j_regressor, verts_nodummy)


def kps_consistency_loss(rec_nodummy, target_kps_kept, j_regressor,
                         kps_keep: GatherTable):
    """L1 between regressed keypoints of a decode and the edit targets;
    kps_keep is `LossTables.kps_keep`."""
    kps_rec = regress_kps(rec_nodummy, j_regressor)
    return l1(gather_rows(kps_rec, kps_keep), target_kps_kept)


def _part_weight(i: int, n_part: int, point_num: int, w_part_mode: str,
                 edited_mask, n_edited):
    """Per-part loss weight."""
    if w_part_mode == "n/N":
        return n_part / point_num
    if w_part_mode == "1/K":
        return 1.0 / N_PARTS
    if w_part_mode == "1/rand_num":
        if edited_mask is None or n_edited is None:
            return 1.0 / N_PARTS
        return torch.where(edited_mask[i] > 0,
                           0.99 / torch.clamp(n_edited, min=1),
                           0.01 / torch.clamp(N_PARTS - n_edited, min=1))
    raise ValueError(f"unknown w_part_mode {w_part_mode!r}")


_BONE_IDX = bone_endpoint_arrays(SKL_LIST)


def part_bones(kps_full):
    """[B, 35, 3] -> [B, 17, 3] the per-part orientation bones."""
    return bone_vectors(kps_full, *_BONE_IDX)


def weighted_distance_loss(tx_nodummy, rec_nodummy, kps_full,
                           ptab: PartDistTables, a_full=None,
                           edited_mask=None, n_edited=None,
                           w_mode: str = "threshold",
                           w_threshold: float = 0.8,
                           w_part_mode: str = "1/K", relat: bool = True,
                           sums_fn=part_dist_sums,
                           global_counts: bool = False):
    """Orientation-adaptive weighted intra-part distance-matrix loss.

    a_full [B, 17] scales the GT distances of edited parts (1.0 elsewhere);
    edited_mask [17] and n_edited drive the '1/rand_num' part weights.
    `ptab` holds the part buckets and the leafkeep/all_one uniform-weight
    flags (PartDistTables(part_indices, leafkeep, w_mode, device)).  Every
    part goes through `fused_part_sums`: the part_dist kernels on a CUDA
    tensor, their plain versions on a CPU one.

    Each part's loss is a masked mean, sums over counts, both over the
    batch.  With global_counts (a data-parallel step over this rank's
    rows) the counts are summed over the ranks and this rank's sums are
    weighted by the world size, so the ranks' mean loss and mean gradient
    are those of the global batch."""
    bones = part_bones(kps_full)                        # [B, 17, 3]
    point_num = tx_nodummy.shape[1]
    sums, counts = fused_part_sums(tx_nodummy, rec_nodummy, bones, ptab,
                                   a_full=a_full, w_mode=w_mode,
                                   w_threshold=w_threshold, relat=relat,
                                   sums_fn=sums_fn)
    if global_counts:
        counts = all_reduce_sum(counts)
        sums = sums * float(process_count())
    li = sums / torch.clamp(counts, min=1.0)
    li_by_part = dict(zip(ptab.part_ids, li))
    total = 0.0
    for i in range(ptab.n_parts):
        total = total + _part_weight(i, ptab.sizes[i], point_num,
                                     w_part_mode, edited_mask,
                                     n_edited) * li_by_part[i]
    return total


def volume_loss(tx_nodummy, rec_nodummy, tables: LossTables, gt_vols=None):
    """mean over batch and non-leaf parts of | |rec_vol / gt_vol| - 1 |;
    gt_vols [B, P'] may be precomputed."""
    faces, mask = tables.faces, tables.face_part_mask
    rec_vol = signed_part_volumes(rec_nodummy, faces, mask)
    gt_vol = (signed_part_volumes(tx_nodummy, faces, mask)
              if gt_vols is None else gt_vols)
    ratio = torch.abs(rec_vol / gt_vol)
    return torch.mean(torch.abs(ratio - 1.0))
