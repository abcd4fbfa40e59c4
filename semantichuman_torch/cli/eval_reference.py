"""One-command reference-checkpoint eval (the port's counterpart of
`semantichuman_tpu/cli/eval_reference.py`): the DFAUST north-star harness.

Reproduces the reference's final eval (test_funcs.py:61-110 via
main.py:325-341, testcfg.yaml) on a torch `.pth.tar` checkpoint:

  python -m semantichuman_torch.cli.eval_reference \\
      --data_root data/DFAUST --asset_dir data/asset \\
      --checkpoint checkpoints/checkpoint300.pth.tar \\
      --reference_hierarchy data/downsampling_matrices2222.pkl \\
      --workdir results/ref_eval \\
      [--torch_l1 L1 --torch_mm MM] [--device cpu]

Rebuilds the reference hierarchy from its downsampling-matrices pickle
(QSLIM tie-breaking is machine-dependent, so the pickle, not a recompile,
is the source of truth for trained checkpoints), imports the weights
through `utils/import_torch.py`, runs the test split through
`Trainer.evaluate` on the card (unless --device cpu), and prints ONE JSON
line with mean L1 and mean per-vertex mm error.  When the torch run's own
numbers are supplied (--torch_l1/--torch_mm), it also prints the relative
delta (the <= 0.5 % north-star check) and exits 1 if the mm delta exceeds
--max_delta_pct.  Under torchrun (or --coordinator/--num_processes/
--process_id) with --distributed, each process evaluates its rows of every
test batch and the sums are taken over the processes, as the JAX CLI's
mesh branch shards the batch: the imported parameters are broadcast from
rank 0 and rank 0 prints the line.  The JAX CLI's `enable_cache()` (JAX's
compilation cache) has no counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Evaluate an imported reference .pth.tar on DFAUST.")
    ap.add_argument("--config", default=None,
                    help="YAML config (defaults mirror the reference recipe)")
    ap.add_argument("--data_root", default=None,
                    help="dataset root with preprocessed/{train,test}.npy + "
                         "template/template.obj (overrides cfg.data.root_dir)")
    ap.add_argument("--asset_dir", default=None,
                    help="asset dir with J_regressor.npy etc. "
                         "(overrides cfg.data.asset_dir)")
    ap.add_argument("--checkpoint", required=True,
                    help="reference .pth.tar checkpoint to import")
    ap.add_argument("--reference_hierarchy", default=None,
                    help="reference downsampling_matrices pickle; REQUIRED "
                         "for real reference checkpoints (exact hierarchy)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--batch_test", type=int, default=None)
    ap.add_argument("--mm_constant", type=float, default=1000.0)
    ap.add_argument("--normalized_metrics", action="store_true",
                    help="compute metrics in normalized coordinates even "
                         "under gass/normal (the reference's own behavior: "
                         "its unnormal_flag is dead code)")
    ap.add_argument("--torch_l1", type=float, default=None,
                    help="reference torch run's mean L1 (for the delta)")
    ap.add_argument("--torch_mm", type=float, default=None,
                    help="reference torch run's mean per-vertex mm error")
    ap.add_argument("--max_delta_pct", type=float, default=0.5,
                    help="fail (exit 1) if |mm delta| exceeds this percent")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group first (torchrun's "
                         "environment, or the three flags below)")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's address, tcp://host:port")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    args = ap.parse_args(argv)

    if args.distributed or args.coordinator:
        from ..parallel.distributed import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)

    from ..config import Config
    from ..train.loop import Trainer
    from ..utils.import_torch import load_reference_checkpoint

    cfg = Config.from_yaml(args.config) if args.config else Config()
    data_over = {}
    if args.data_root:
        data_over["root_dir"] = args.data_root
    if args.asset_dir:
        data_over["asset_dir"] = args.asset_dir
    if args.reference_hierarchy:
        data_over["reference_hierarchy"] = args.reference_hierarchy
    # measurements are a train-only input; eval must not require them
    data_over["measure"] = False
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, **data_over))
    if args.batch_test:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           batch_test=args.batch_test))

    trainer = Trainer(cfg, args.workdir, device=args.device)
    params, epoch = load_reference_checkpoint(args.checkpoint, trainer.model)
    if trainer.data_parallel:
        from ..parallel.mesh import put_replicated
        put_replicated(params)
    trainer.params = params

    unnormalize = False if args.normalized_metrics else None
    _p, _z, _zk, _tx, l1, mm = trainer.evaluate(
        mm_constant=args.mm_constant, unnormalize=unnormalize)

    out = {"checkpoint": args.checkpoint, "epoch": epoch,
           "n_test": int(len(trainer.data["test"])),
           "l1": l1, "mm": mm}
    fail = False
    if args.torch_l1 is not None:
        out["l1_delta_pct"] = 100.0 * (l1 - args.torch_l1) / args.torch_l1
    if args.torch_mm is not None:
        out["mm_delta_pct"] = 100.0 * (mm - args.torch_mm) / args.torch_mm
        fail = abs(out["mm_delta_pct"]) > args.max_delta_pct
    if trainer._is_main:
        print(json.dumps(out))
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
