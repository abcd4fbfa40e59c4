"""Training entry point (the port's counterpart of
`semantichuman_tpu/cli/train.py`).

  python -m semantichuman_torch.cli.train --config configs/train_dfaust.yaml \
      --workdir results/run1 [--epochs N] [--synthetic] \
      [--resume DIR | --resume_torch FILE.pth.tar] [--finetune] [--device cpu]

Runs the Trainer on the card (on the CPU only with --device cpu): the
topology compile (cached in the workdir), the epoch loop with checkpoints,
then, with train.eval_flag, the final eval and prediction export.  The
dataset is the config's data.root_dir and data.asset_dir, as the
preprocessing CLIs write them (make_synthetic -> obj2npy ->
data_generation), or the synthetic generator with --synthetic.
`--config configs/train_neural3dmm.yaml` trains the neural3DMM baseline.
--resume_torch continues from a reference `.pth.tar` (weights, Adam
moments and the schedule's position; with --finetune the weights alone).
The JAX CLI's --distributed is not ported (ROADMAP.md section 1, 'DDP and
the trace window').
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train a SemanticHuman model with the PyTorch port.")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults: the paper recipe)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=None,
                    help="override cfg.train.n_epochs")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to resume from")
    ap.add_argument("--resume_torch", default=None,
                    help="reference .pth.tar to resume from (weights + "
                         "Adam moments + schedule position)")
    ap.add_argument("--finetune", action="store_true",
                    help="with --resume/--resume_torch: load weights only "
                         "and restart the schedule from epoch 1")
    ap.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (no DFAUST needed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..train.loop import Trainer

    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.synthetic:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, synthetic=True))
    if args.epochs is not None:
        # on the config, not just fit(): the lr schedule reads n_epochs
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, n_epochs=args.epochs))
    if args.resume or args.resume_torch or args.finetune:
        # a resume flag replaces the config's resume pair whole: a yaml
        # with train.resume set would else trip the resume-xor-resume_torch
        # check with no CLI way to clear it
        if args.resume or args.resume_torch:
            resume, resume_torch = args.resume, args.resume_torch
        else:
            resume, resume_torch = cfg.train.resume, cfg.train.resume_torch
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, resume=resume, resume_torch=resume_torch,
                finetune=args.finetune or cfg.train.finetune))

    trainer = Trainer(cfg, args.workdir, device=args.device)
    trainer.fit()
    if cfg.train.eval_flag:
        _p, _z, _zk, _tx, l1, l2mm = trainer.export_predictions()
        print(f"test L1: {l1:.6f}")
        print(f"test per-vertex euclidean (mm): {l2mm:.4f}")
    return trainer


if __name__ == "__main__":
    main()
