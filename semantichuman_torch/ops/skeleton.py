"""Skeleton algebra (counterpart of `semantichuman_tpu/ops/skeleton.py`):
bone vectors from endpoint gathers, and skeleton -> keypoint integration
as one matmul against the root-to-joint path matrix."""

from __future__ import annotations

import functools

import torch

from ..constants import (KPS_KEEP, N_KPS_FULL, NEWSKL_LIST,
                         bone_endpoint_arrays, skl_path_matrix)
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
