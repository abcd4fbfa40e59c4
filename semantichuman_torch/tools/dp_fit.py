"""One process of a data-parallel training run through `cli.train`, with
its result written out for a check.

    python -m semantichuman_torch.tools.dp_fit --out DIR -- \\
        --config C.yaml --workdir W --distributed \\
        --coordinator tcp://localhost:PORT --num_processes 2 --process_id R \\
        [--device cpu] [--backend gloo]

Everything after `--` goes to `cli.train.main` unchanged (without
--distributed: one process, no group).  After the fit this process
validates and evaluates (both collective) and writes DIR/rank<R>.npz (its
final parameters by key path, `param:<path>`; the evaluated predictions,
`preds`) and DIR/rank<R>.json (rank, world, start epoch, the per-epoch
history, the val loss, evaluate's L1 and mm, and the process's kernel
launches, `ops/launches.py`, counted from its start).  Two ranks' files
hold each other's parameters bit for bit when the gradient all-reduce ran.
With --save_grads K the npz also holds the gradient of the first K steps
as the optimizer receives it (after the all-reduce), `grad<i>:<path>`
for step i = 1..K of this process (`recording_grads`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch


@contextlib.contextmanager
def recording_grads(k: int):
    """For the block, record the gradient of the first k train steps as
    the optimizer receives it (the leaves `train/step.py` passes to
    global_norm, after the all-reduce under data parallelism), as numpy
    leaves; yields the list they are appended to."""
    from ..train import step as S

    norm, seen = S.global_norm, []

    def global_norm(leaves):
        if len(seen) < k:
            seen.append([t.detach().cpu().numpy() for t in leaves])
        return norm(leaves)

    S.global_norm = global_norm
    try:
        yield seen
    finally:
        S.global_norm = norm


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" not in argv:
        raise SystemExit("usage: dp_fit --out DIR -- <cli.train arguments>")
    cut = argv.index("--")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--save_grads", type=int, default=0,
                    help="save the gradients of the first K steps")
    args = ap.parse_args(argv[:cut])

    from ..cli.train import main as train_main
    from ..ops import launches
    from ..utils.params import tree_leaves, tree_paths

    with recording_grads(args.save_grads) as grads:
        trainer = train_main(argv[cut + 1:])
    val = trainer.validate()
    preds, _z, _zk, _tx, l1, mm = trainer.evaluate()
    rank = trainer.process_index
    os.makedirs(args.out, exist_ok=True)
    paths = ["/".join(map(str, p)) for p in tree_paths(trainer.params)]
    arrays = {"param:" + p: t.detach().cpu().numpy()
              for p, t in zip(paths, tree_leaves(trainer.params))}
    for i, leaves in enumerate(grads, start=1):
        arrays.update({f"grad{i}:{p}": g for p, g in zip(paths, leaves)})
    np.savez(os.path.join(args.out, f"rank{rank}.npz"), preds=preds,
             **arrays)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": trainer.n_processes,
                   "start_epoch": trainer.start_epoch,
                   "device": str(trainer.device),
                   "data_parallel": trainer.data_parallel,
                   "history": trainer.history, "val": val, "l1": l1,
                   "mm": mm, "launches": launches.read()}, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
