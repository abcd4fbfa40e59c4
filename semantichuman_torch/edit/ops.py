"""Latent and skeleton edit operations (counterpart of
`semantichuman_tpu/edit/ops.py`).

The four semantic edits of the reference demo (demo.py:75-93) and latent
interpolation, each a function over latent / skeleton tensors that returns
a new tensor and never writes into its input:

  * transplant_orientation: bone directions from a donor skeleton;
  * scale_bone_length:      per-bone length scaling;
  * scale_girth:            per-part shape-latent magnitude scaling;
  * style_transfer_z:       the donor latent's direction at the source's
                            norm;
  * interpolate_z:          linear latent interpolation.

Skeletons are the [B, 31, 4] (unit dir, length) representation of
ops.skeleton.kps2skl(mode='ori_m'); latents are [B, 17, nz] part latents.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NEWSKL_LIST, PART_LIST


def _part_idx(parts) -> np.ndarray:
    """Part names or indices -> int index array."""
    out = []
    for p in np.atleast_1d(parts):
        if isinstance(p, (str, np.str_)):
            if p not in PART_LIST:
                raise ValueError(
                    f"unknown part {p!r}; choose from {PART_LIST}")
            out.append(PART_LIST.index(p))
        else:
            q = int(p)
            if not 0 <= q < len(PART_LIST):
                raise ValueError(
                    f"part index {q} out of range [0, {len(PART_LIST)})")
            out.append(q)
    return np.asarray(out, dtype=np.int32)


def _bone_idx(bones) -> np.ndarray:
    idx = np.asarray(bones, dtype=np.int32).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= len(NEWSKL_LIST)):
        raise ValueError(f"bone index out of range [0, {len(NEWSKL_LIST)})")
    return idx


def _factor(factor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(factor, dtype=like.dtype, device=like.device)


def transplant_orientation(skl: torch.Tensor, donor_skl: torch.Tensor,
                           bones) -> torch.Tensor:
    """skl, donor_skl [B, 31, 4] -> skl with the chosen bones' unit
    directions replaced by the donor's (lengths kept: demo.py:77-79)."""
    idx = torch.as_tensor(_bone_idx(bones), dtype=torch.long,
                          device=skl.device)
    out = skl.clone()
    out[:, idx, :3] = donor_skl[:, idx, :3]
    return out


def scale_bone_length(skl: torch.Tensor, bones, factor) -> torch.Tensor:
    """Multiply the chosen bones' lengths by `factor` (scalar, per-bone
    [len(bones)], or per-sample [B, len(bones)]: demo.py:81-84)."""
    idx = torch.as_tensor(_bone_idx(bones), dtype=torch.long,
                          device=skl.device)
    out = skl.clone()
    out[:, idx, 3] = skl[:, idx, 3] * _factor(factor, skl)
    return out


def scale_girth(z: torch.Tensor, parts, factor) -> torch.Tensor:
    """Scale the chosen parts' shape latents: z_part <- factor * z_part.
    The latent-norm <-> measure correspondence trained by zpartreg makes
    this a physical girth edit (demo.py:86)."""
    idx = torch.as_tensor(_part_idx(parts), dtype=torch.long,
                          device=z.device)
    out = z.clone()
    out[:, idx, :] = z[:, idx, :] * _factor(factor, z)
    return out


def style_transfer_z(z: torch.Tensor, donor_z: torch.Tensor,
                     parts=None, eps: float = 1e-12) -> torch.Tensor:
    """Keep each part latent's norm (the body measure) but take its
    direction (the style) from the donor (demo.py:88-93)."""
    norm = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    donor_dir = donor_z / (torch.linalg.vector_norm(donor_z, dim=-1,
                                                    keepdim=True) + eps)
    styled = norm * donor_dir
    if parts is None:
        return styled
    idx = torch.as_tensor(_part_idx(parts), dtype=torch.long,
                          device=z.device)
    out = z.clone()
    out[:, idx, :] = styled[:, idx, :]
    return out


def interpolate_z(z_a: torch.Tensor, z_b: torch.Tensor, t) -> torch.Tensor:
    """Linear interpolation (1-t)*z_a + t*z_b; t scalar or broadcastable."""
    t = _factor(t, z_a)
    return (1.0 - t) * z_a + t * z_b
