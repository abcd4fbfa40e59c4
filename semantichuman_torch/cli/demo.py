"""Latent editing demo entry point (the port's counterpart of
`semantichuman_tpu/cli/demo.py`; reference demo.py).

  python -m semantichuman_torch.cli.demo --config configs/test_dfaust.yaml \
      --workdir results/run1 [--resume results/run1/checkpoints | \
      --checkpoint_torch P.pth.tar] [--out results/run1/edits] \
      [--n_samples 4] [--skip_eval] [--synthetic] [--device cpu]

Loads a trained checkpoint (the port's own, or a reference `.pth.tar`
through the Trainer's resume_torch with finetune), runs the test-set eval
(saving predictions and latents) unless --skip_eval, then applies the four
semantic edits (bone-orientation transplant, bone-length scaling, per-part
girth scaling, shape style transfer) to the first test batch and writes
OBJs with part colours and skeleton strips.  On the card unless --device
cpu.  The JAX CLI's `enable_cache()` turns on JAX's compilation cache,
which has no counterpart here: the port compiles its kernels once per
source into `semantichuman_torch/_build/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run the latent editing demo.")
    ap.add_argument("--config", default=None)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir (default: <workdir>/checkpoints)")
    ap.add_argument("--checkpoint_torch", default=None,
                    help="run the demo directly off a reference .pth.tar "
                         "instead of a checkpoint dir")
    ap.add_argument("--out", default=None,
                    help="edit output dir (default: <workdir>/edits)")
    ap.add_argument("--n_samples", type=int, default=4)
    ap.add_argument("--skip_eval", action="store_true",
                    help="skip the full test-set eval/export pass")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..edit import Editor, run_demo
    from ..train.loop import Trainer

    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.checkpoint_torch:
        if args.resume:
            raise ValueError(
                "--resume and --checkpoint_torch are mutually exclusive "
                "(cli.train rejects the same conflict)")
        repl = {"resume": None, "resume_torch": args.checkpoint_torch,
                "finetune": True}
    else:
        resume = args.resume or os.path.join(args.workdir, "checkpoints")
        repl = {"resume": resume, "resume_torch": None, "finetune": True}
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **repl))
    if args.synthetic:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, synthetic=True))

    trainer = Trainer(cfg, args.workdir, device=args.device)
    if not args.skip_eval:
        _p, _z, _zk, _tx, l1, l2mm = trainer.export_predictions()
        print(f"test L1: {l1:.6f}")
        print(f"test per-vertex euclidean (mm): {l2mm:.4f}")

    # first test batch, normalized like training, dummy row stripped
    v = next(iter(trainer.test_loader))["verts"]
    v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    verts = v[:args.n_samples, :-1]

    editor = Editor.from_trainer(trainer)
    out_dir = args.out or os.path.join(args.workdir, "edits")
    results = run_demo(editor, verts, out_dir)
    print(f"edits written to {out_dir}")
    return results


if __name__ == "__main__":
    main()
