"""Skeleton algebra (counterpart of `semantichuman_tpu/ops/skeleton.py`):
bone vectors from endpoint gathers, skeleton -> keypoint integration as
one matmul against the root-to-joint path matrix, the bone-length edit as
a subtree translation through a descendant mask, and the orientation
weights of the distance loss."""

from __future__ import annotations

import functools
import math

import torch

from ..constants import (CHILD_DICT, KPS_KEEP, N_KPS_FULL, NEWSKL_LIST,
                         PARENT_DICT, bone_endpoint_arrays, skl_path_matrix)
from ..utils.device import index_tensor

_A, _B1, _B2 = bone_endpoint_arrays(NEWSKL_LIST)
_PATH = skl_path_matrix(NEWSKL_LIST)          # [35, 31]


def expand_kps(kps: torch.Tensor) -> torch.Tensor:
    """[B, 32, 3] kept keypoints -> [B, 35, 3] with dropped joints zeroed."""
    if kps.shape[1] == N_KPS_FULL:
        return kps
    full = kps.new_zeros((kps.shape[0], N_KPS_FULL, 3))
    full[:, index_tensor(KPS_KEEP, kps.device)] = kps
    return full


def bone_vectors(kps_full: torch.Tensor, idx_a, idx_b1,
                 idx_b2) -> torch.Tensor:
    """[B, n_bones, 3] vec = kps[a] - midpoint(kps[b1], kps[b2])."""
    dev = kps_full.device
    a = kps_full.index_select(1, index_tensor(idx_a, dev))
    b = 0.5 * (kps_full.index_select(1, index_tensor(idx_b1, dev))
               + kps_full.index_select(1, index_tensor(idx_b2, dev)))
    return a - b


def kps2skl(kps: torch.Tensor, mode: str = "ori_m") -> torch.Tensor:
    """kps [B, 32|35, 3] -> skeleton representation.

    mode: 'ori_m'/'kps_ori_m' -> [B, 31, 4] (unit dir, length);
          'vec_m' -> [B, 31, 4] (raw vec, length);
          'vec'   -> [B, 31, 3]; 'm' -> [B, 31, 1].
    """
    vec = bone_vectors(expand_kps(kps), _A, _B1, _B2)
    length = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    if mode in ("ori_m", "kps_ori_m"):
        return torch.cat([vec / length, length], dim=-1)
    if mode == "vec_m":
        return torch.cat([vec, length], dim=-1)
    if mode == "vec":
        return vec
    if mode == "m":
        return length
    raise ValueError(f"unknown skl mode {mode!r}")


def skl2kps(skl: torch.Tensor, mode: str = "ori_m") -> torch.Tensor:
    """Inverse of kps2skl: re-integrate bone vectors from the root.
    Returns kept keypoints [B, 32, 3]; kps[j] = -(sum of the bone vectors
    on the root->j path), one [35, 31] matmul."""
    if mode in ("ori_m", "kps_ori_m"):
        vec = skl[..., :3] * skl[..., 3:4]
    elif mode in ("vec", "vec_m"):
        vec = skl[..., :3]
    else:
        raise ValueError(f"unknown skl mode {mode!r}")
    path = _path(vec.device, vec.dtype)
    kps_full = -torch.einsum("jk,bkd->bjd", path, vec)
    return kps_full.index_select(1, index_tensor(KPS_KEEP, vec.device))


@functools.cache
def _path(device, dtype) -> torch.Tensor:
    return torch.as_tensor(_PATH, dtype=dtype, device=device)


def bone_lengths(kps_full: torch.Tensor, skl_list) -> torch.Tensor:
    """[B, n] lengths for an arbitrary bone table (2- or 3-entry bones)."""
    a, b1, b2 = bone_endpoint_arrays(skl_list)
    return torch.linalg.vector_norm(bone_vectors(kps_full, a, b1, b2),
                                    dim=-1)


def _descendants(joint: int) -> list[int]:
    out = [joint]
    for c in CHILD_DICT.get(joint, []):
        out += _descendants(c)
    return out


def edit_skl(kps: torch.Tensor, kps_index: int, edit_length) -> torch.Tensor:
    """Bone-length edit: translate joint `kps_index`'s whole subtree along
    the bone direction by (edit_length - 1) * (kps[j] - kps[parent])
    (reference: utils_SH.py:412-440).  kps [B, 24+, 3] (full SMPL joint
    order), edit_length [B] or a scalar; returns a new tensor."""
    parent = PARENT_DICT[kps_index]
    dirc = kps[:, kps_index, :] - kps[:, parent, :]
    scale = (torch.as_tensor(edit_length, dtype=kps.dtype, device=kps.device)
             - 1.0).reshape(-1, 1)
    mask = torch.zeros(kps.shape[1], dtype=kps.dtype, device=kps.device)
    mask[_descendants(kps_index)] = 1.0
    return kps + dirc[:, None, :] * scale[:, None, :] * mask[None, :, None]


def angle_weights(verts: torch.Tensor, kps_full: torch.Tensor,
                  part_indices, skl_list) -> list:
    """Per part: [B, n, n] angles (degrees, folded to [0, 90]) between every
    intra-part vertex-pair direction and the part's bone direction.  NaNs
    from coincident vertices map to angle 0 (cos -> 1), as the reference's
    nan-guard does (utils_SH.py:461-463)."""
    a, b1, b2 = bone_endpoint_arrays(skl_list)
    bones = bone_vectors(kps_full, a, b1, b2)             # [B, n_parts, 3]
    bone_norm = torch.linalg.vector_norm(bones, dim=-1)   # [B, n_parts]
    out = []
    for p, idx in enumerate(part_indices):
        vp = verts.index_select(1, index_tensor(idx, verts.device))
        d = vp[:, :, None, :] - vp[:, None, :, :]         # [B, n, n, 3]
        d_norm = torch.linalg.vector_norm(d, dim=-1)      # [B, n, n]
        dot = torch.einsum("bijd,bd->bij", d, bones[:, p, :])
        cos = dot.abs() / (d_norm * bone_norm[:, p, None, None])
        cos = torch.where(torch.isnan(cos), torch.ones_like(cos), cos)
        cos = torch.clamp(cos, 0.0, 1.0)
        out.append(torch.arccos(cos) * (180.0 / math.pi))
    return out
