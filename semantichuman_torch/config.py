"""Model and training configuration (the port's copy of
`semantichuman_tpu/config.py` ModelConfig and TrainConfig, same defaults).

Only the fields the port reads are kept.  The TPU dispatch switches
(`use_pallas`, `banded_conv`) select XLA/Pallas forms with no counterpart
here.  The topology compile parameters (`ds_factors`, `step_sizes`,
`dilation`) belong to the compiler, which the port does not have: it loads
a compiled hierarchy.  The neural3DMM fields (`nz`, `vae`, `activation`)
arrive with that model.  TrainConfig keeps the fields that the train
step, the edit sampler and the optimizer read; the trainer's fields
(checkpoints, logging, epochs of a run) arrive with the trainer.
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


@dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 5e-5        # torch-style coupled L2 inside Adam
    lr_decay: float = 0.99            # per-epoch exponential (StepLR gamma)
    lr_warmup_epochs: int = 0         # linear lr ramp over the first N epochs
    lr_schedule: str = "exp"          # 'exp' | 'cosine' (needs n_epochs)
    n_epochs: int = 300
    grad_clip: float = 0.0            # global-norm clip, 0 = off
    adam_b2: float = 0.999
    skip_nonfinite: int = 0           # >0: skip steps with NaN/Inf grads
    seed: int = 2
    # loss switches / weights (epoch thresholds gate when a term turns on)
    edgereg_epoch: int = 0
    edgereg_w: float = 1e-2
    zpartreg_epoch: int = 0
    zpartreg_w: float = 1e-2
    vol_epoch: int = 0
    vol_w: float = 1e-2
    interp_epoch: int = 0
    interp_kps_w: float = 1.0
    interp_euc_w: float = 1e-2
    exc_epoch: int = 0
    exc_kps_w: float = 1.0
    exc_euc_w: float = 1e-2
    # weighted-distance-loss shaping
    w_mode: str = "threshold"         # all_one | linear | sin | threshold
    w_threshold: float = 0.8
    w_part_mode: str = "1/K"          # n/N | 1/K | 1/rand_num
    relat_flag: bool = True
    # latent-edit branch
    edit_mode: str = "equal"          # equal | rand | exc
    rand_mode: str = "rand"           # rand | warm_up
    exc_mode: str = "ori_or_m"        # m | ori_m | ori | ori_or_m
    editskl_flag: bool = False
    noleaf_flag: bool = True
    leafkeep_flag: bool = True
    factor: list = field(default_factory=lambda: [0.4, 0.8])
