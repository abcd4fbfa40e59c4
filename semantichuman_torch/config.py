"""Configuration (the port's copy of `semantichuman_tpu/config.py`: the same
dataclass tree, fields and defaults, and the same YAML overrides, so every
file in `configs/` loads into either package).

    cfg = Config.from_yaml("configs/train_dfaust.yaml")
    cfg = Config()          # code defaults: the paper recipe

`model.use_pallas` selects a mechanism of the JAX package's TPU runtime;
it loads and has no effect in the port, whose kernels are its only
implementation.

`train.data_parallel` (on by default) trains data-parallel when the
process has joined a process group (`parallel/distributed.py`, `cli/train.py
--distributed`): one process a card, each on its rows of every global
batch.  `train.profile_start` < `profile_stop` records global steps
[start, stop) with torch.profiler into <workdir>/profile
(`utils/profiling.py:TraceWindow`).

`train.epoch_scan` (on by default) and `train.scan_epochs` mean what they
mean in the JAX package: the Trainer runs chunks of up to scan_epochs
epochs over device-resident data with no per-step host work, on the card
as replays of one captured CUDA graph a step (`train/loop.py`).

`model.banded_conv` (on by default, as in the JAX package) builds band
tables for the fine spiral levels and the large unpool transitions; the
spiral conv and unpool take the banded routes where the card's batch
gates let them (`ops/spiral_conv.py:_BANDED_MAX_B`,
`ops/sampling.py:_UNPOOL_BAND_MAX_B`; both closed, since the banded routes
measured slower on the card at every batch).  The topology fields
(`ds_factors`, `step_sizes`, `dilation`) are the compile parameters of the
hierarchy the trainer compiles (`topology/compiler.py`).  The
neural3DMM fields (`nz`, `vae`) shape the baseline SpiralAE; `activation`
loads and has no effect, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ModelConfig:
    model_name: str = "dfaust_multiz8_partkps8"
    # 'multiz+partkps' (paper flagship) | 'neural3DMM' (baseline)
    model_type: str = "multiz+partkps"
    ds_factors: list = field(default_factory=lambda: [2, 2, 2, 2])
    step_sizes: list = field(default_factory=lambda: [2, 2, 1, 1, 1])
    dilation: list = field(default_factory=lambda: [2, 2, 1, 1, 1])
    # [per-level main filters, per-level optional extra filters]
    filter_sizes_enc: list = field(
        default_factory=lambda: [[3, 16, 32, 64, 128], [[], [], [], [], []]])
    filter_sizes_dec: list = field(
        default_factory=lambda: [[128, 64, 32, 32, 16], [[], [], [], [], 3]])
    part_shape_latent_size: int = 8
    part_kps_latent_size: int = 8
    nz: int = 256             # latent size for the neural3DMM baseline
    activation: str = "elu"
    vae: bool = False
    # numeric policy: 'float32' or 'bfloat16' for the conv trunk
    trunk_dtype: str = "float32"
    use_pallas: bool = True   # no effect in the port
    banded_conv: bool = True


@dataclass
class DataConfig:
    root_dir: str = "data/DFAUST"
    dataset: str = "DFAUST"
    n_val: int = 0
    normalization: str = "zeroroot"  # substring-matched modes, data.dataset
    measure: bool = True
    shuffle: bool = True
    from_stacked: bool = True
    reference_hierarchy: Optional[str] = None
    prefetch: int = 2
    # stage array splits on the device (data.device_data): True / False /
    # 'auto' (on when everything fits device_resident_max_gb)
    device_resident: Any = "auto"
    device_resident_max_gb: float = 6.0
    asset_dir: str = "data/asset"
    # synthetic data (no DFAUST needed)
    synthetic: bool = False
    synthetic_train: int = 256
    synthetic_test: int = 64
    # synthetic mesh resolution (None = SMPL scale, 6892 vertices)
    synthetic_n_theta: Optional[int] = None
    synthetic_n_phi: Optional[int] = None


@dataclass
class TrainConfig:
    n_epochs: int = 300
    batch_train: int = 4
    batch_test: int = 16
    batch_interp: int = 4
    lr: float = 1e-3
    weight_decay: float = 5e-5        # torch-style coupled L2 inside Adam
    lr_decay: float = 0.99            # per-epoch exponential (StepLR gamma)
    lr_warmup_epochs: int = 0         # linear lr ramp over the first N epochs
    lr_schedule: str = "exp"          # 'exp' | 'cosine' (needs n_epochs)
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
    # checkpointing
    ck_frequency: int = 100
    ck_keep: Optional[int] = None     # keep only the newest N checkpoints
    ck_name: str = "checkpoint"
    resume: Optional[str] = None      # checkpoint dir to resume from
    resume_torch: Optional[str] = None  # reference .pth.tar to resume
    finetune: bool = False            # load weights only, restart schedule
    eval_flag: bool = True
    val_every: int = 1                # val pass every N epochs
    save_recons: bool = True
    data_parallel: bool = True        # under a process group: DP
    epoch_scan: bool = True           # the epoch path (a CUDA graph a step)
    scan_epochs: int = 1              # epochs per chunk of the epoch path
    log_every: int = 0                # extra step-level logging (0 = off)
    profile_start: int = 0
    profile_stop: int = 0             # > profile_start: a trace window


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    out_dir: str = "results"

    @staticmethod
    def from_yaml(path: str) -> "Config":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return Config.from_dict(raw)

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        return _merge(Config(), raw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _merge(node: Any, raw: dict) -> Any:
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot merge into non-dataclass {node!r}")
    updates = {}
    valid = {f.name: f for f in dataclasses.fields(node)}
    for key, val in raw.items():
        if key not in valid:
            raise KeyError(
                f"unknown config key {key!r} for {type(node).__name__}; "
                f"valid keys: {sorted(valid)}")
        cur = getattr(node, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = _merge(cur, val)
        else:
            updates[key] = val
    return dataclasses.replace(node, **updates)
