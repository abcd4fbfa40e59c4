"""Semantic latent editing (counterpart of `semantichuman_tpu/edit`)."""

from .editor import Editor, run_demo
from .ops import (interpolate_z, scale_bone_length, scale_girth,
                  style_transfer_z, transplant_orientation)

__all__ = [
    "Editor", "run_demo", "interpolate_z", "scale_bone_length",
    "scale_girth", "style_transfer_z", "transplant_orientation",
]
