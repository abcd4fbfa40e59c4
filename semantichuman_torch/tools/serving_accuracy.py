"""What the bf16 trunk costs in accuracy on a trained checkpoint (the
port's counterpart of `tools/serving_accuracy.py`): the full test-set eval
(`Trainer.evaluate`, the reference's test_funcs.py:61-110 metrics) of the
same restored parameters at model.trunk_dtype float32 and at bfloat16.

    python -m semantichuman_torch.tools.serving_accuracy \\
        --resume results/run/checkpoints [--config C.yaml] [--device cpu]

prints one line per arm and, last, one JSON line
{"f32_mm": .., "bf16_mm": .., "delta_mm": .., "f32_l1": .., "bf16_l1": ..}.

Each arm builds its own Trainer, and with it its own test data and the
input tensors it evaluates: the two arms share no input tensor (an A/B that
fed both arms one tensor read a delta of exactly 0.0).  The run's config
comes back from the train_params.txt beside the checkpoints, since the
synthetic test split is seeded by train.seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile


def _run_config(resume: str, config: str | None):
    """The trained run's Config: from `config` (YAML) if given, else the
    first JSON object of train_params.txt in `resume` or its parent (a
    resumed run appends more dumps after it)."""
    from ..config import Config

    if config:
        return Config.from_yaml(config)
    for d in (resume, os.path.dirname(resume.rstrip("/"))):
        p = os.path.join(d, "train_params.txt")
        if os.path.exists(p):
            with open(p) as f:
                obj, _end = json.JSONDecoder().raw_decode(f.read())
            return Config.from_dict(obj["config"])
    raise FileNotFoundError(
        f"no train_params.txt next to {resume}; pass --config explicitly")


def _eval_at(cfg, resume: str, trunk_dtype: str, device: str):
    """(mean L1, mean mm) of the checkpoint at `trunk_dtype`, from a
    Trainer of its own (its own data and inputs)."""
    from ..train.loop import Trainer

    cfg = dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, trunk_dtype=trunk_dtype),
        train=dataclasses.replace(cfg.train, resume=resume,
                                  resume_torch=None))
    with tempfile.TemporaryDirectory() as wd:
        trainer = Trainer(cfg, wd, device=device)
        _p, _z, _zk, _tx, l1, mm = trainer.evaluate()
    return l1, mm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="bf16-trunk serving accuracy of a trained checkpoint")
    ap.add_argument("--resume", required=True,
                    help="checkpoint dir of a trained run")
    ap.add_argument("--config", default=None,
                    help="YAML config the run was trained with (default: "
                         "read from the run's train_params.txt)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = _run_config(args.resume, args.config)
    out = {}
    for dt, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        l1, mm = _eval_at(cfg, args.resume, dt, args.device)
        out[f"{tag}_l1"] = l1
        out[f"{tag}_mm"] = mm
        print(f"{dt}: l1 {l1:.6f}  mm {mm:.4f}", flush=True)
    out["delta_mm"] = out["bf16_mm"] - out["f32_mm"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
