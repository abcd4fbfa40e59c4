"""Model configuration (the port's copy of `semantichuman_tpu/config.py`
ModelConfig, same defaults).

Only the fields the port reads are kept.  The TPU dispatch switches
(`use_pallas`, `banded_conv`) select XLA/Pallas forms with no counterpart
here.  The topology compile parameters (`ds_factors`, `step_sizes`,
`dilation`) belong to the compiler, which the port does not have: it loads
a compiled hierarchy.  The neural3DMM fields (`nz`, `vae`, `activation`)
arrive with that model.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    # 'multiz+partkps' (paper flagship); 'neural3DMM' is not ported yet
    model_type: str = "multiz+partkps"
    # [per-level main filters, per-level optional extra filters]
    filter_sizes_enc: list = field(
        default_factory=lambda: [[3, 16, 32, 64, 128], [[], [], [], [], []]])
    filter_sizes_dec: list = field(
        default_factory=lambda: [[128, 64, 32, 32, 16], [[], [], [], [], 3]])
    part_shape_latent_size: int = 8
    part_kps_latent_size: int = 8
    # numeric policy: 'float32' or 'bfloat16' for the conv trunk
    trunk_dtype: str = "float32"
