"""Model factory: config + mesh hierarchy (+ part assets) -> model
(counterpart of `semantichuman_tpu/models/factory.py`)."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..constants import KPS_INDEX_LIST
from .part_ae import PartAE
from .tables import device_tables

TRUNK_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_model(cfg: ModelConfig, hier, part_dict: dict,
                device="cuda") -> PartAE:
    """`hier` is a MeshHierarchy, `part_dict` maps part names to fine vertex
    indices.  The model's tables live on `device`."""
    if cfg.model_type != "multiz+partkps":
        raise ValueError(f"model_type {cfg.model_type!r} is not ported; "
                         "the port builds 'multiz+partkps'")
    tables = device_tables(hier, device, banded=cfg.banded_conv)
    coarse_parts = hier.downsample_part_indices(part_dict)
    return PartAE(tables, coarse_parts, KPS_INDEX_LIST,
                  cfg.filter_sizes_enc, cfg.filter_sizes_dec,
                  latent_size=cfg.part_shape_latent_size,
                  part_kps_latent_size=cfg.part_kps_latent_size,
                  compute_dtype=TRUNK_DTYPES[cfg.trunk_dtype])
