"""Run a recipe to convergence on synthetic data and record its test-error
curve (the port's counterpart of `tools/convergence_run.py`).

Trains in segments of --eval_every epochs; after each segment runs the full
test eval and appends one JSON line {"epoch", "l1", "mm", "sec_per_epoch"}
to <workdir>/curve.jsonl (`train/segments.py:run_segments`).  Finishes
with the prediction export.  Runs on the card unless --device says
otherwise; with Config() defaults (the paper recipe: 300 epochs, batch 4)
the Trainer takes the epoch path, a CUDA graph a step.

  python -m semantichuman_torch.cli.convergence_run \
      --workdir results/torch_convergence300 --banded 1

A run split over several processes resumes from the newest checkpoint
(train.ck_frequency, every 100 epochs by default) and appends to the same
curve:

  python -m semantichuman_torch.cli.convergence_run \
      --workdir results/torch_convergence300 --banded 1 \
      --resume results/torch_convergence300/checkpoints
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train to convergence on synthetic data, recording the "
        "test-error curve.")
    ap.add_argument("--workdir", default="results/torch_convergence300")
    ap.add_argument("--config", default=None,
                    help="YAML config (default: the paper recipe)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override cfg.train.n_epochs (default: the "
                         "config's budget; a cosine schedule anneals over "
                         "it)")
    ap.add_argument("--eval_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=None,
                    help="override cfg.train.seed (init and data order)")
    ap.add_argument("--banded", type=int, choices=(0, 1), default=None,
                    help="override cfg.model.banded_conv")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from (cfg.train.resume)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..train.loop import Trainer
    from ..train.segments import run_segments

    cfg = Config.from_yaml(args.config) if args.config else Config()
    n_epochs = args.epochs or cfg.train.n_epochs
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, synthetic=True),
        model=dataclasses.replace(
            cfg.model,
            **({"banded_conv": bool(args.banded)}
               if args.banded is not None else {})),
        train=dataclasses.replace(
            cfg.train, n_epochs=n_epochs, save_recons=True,
            **({"seed": args.seed} if args.seed is not None else {}),
            **({"resume": args.resume} if args.resume else {})))
    os.makedirs(args.workdir, exist_ok=True)
    curve_path = os.path.join(args.workdir, "curve.jsonl")

    trainer = Trainer(cfg, args.workdir, device=args.device)
    run_segments(trainer, n_epochs, args.eval_every, curve_path)
    trainer.export_predictions()
    print("done:", curve_path, flush=True)


if __name__ == "__main__":
    main()
