"""Model factory: config + mesh hierarchy (+ part assets) -> model
(counterpart of `semantichuman_tpu/models/factory.py`)."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..constants import KPS_INDEX_LIST
from .part_ae import PartAE
from .spiral_ae import SpiralAE
from .tables import device_tables

TRUNK_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_model(cfg: ModelConfig, hier, part_dict: dict | None = None,
                device="cuda"):
    """A PartAE ('multiz+partkps', which needs `part_dict`, part names to
    fine vertex indices) or a SpiralAE ('neural3DMM') over the
    MeshHierarchy `hier`, its tables on `device`."""
    if cfg.model_type not in ("multiz+partkps", "neural3DMM"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if cfg.model_type == "multiz+partkps" and part_dict is None:
        raise ValueError("multiz+partkps needs a part dict")
    tables = device_tables(hier, device, banded=cfg.banded_conv)
    dtype = TRUNK_DTYPES[cfg.trunk_dtype]
    if cfg.model_type == "neural3DMM":
        return SpiralAE(tables, cfg.filter_sizes_enc, cfg.filter_sizes_dec,
                        latent_size=cfg.nz, vae=cfg.vae, compute_dtype=dtype)
    coarse_parts = hier.downsample_part_indices(part_dict)
    return PartAE(tables, coarse_parts, KPS_INDEX_LIST,
                  cfg.filter_sizes_enc, cfg.filter_sizes_dec,
                  latent_size=cfg.part_shape_latent_size,
                  part_kps_latent_size=cfg.part_kps_latent_size,
                  compute_dtype=dtype)
