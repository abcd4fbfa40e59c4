"""Time the port's host-bound paths on the card, to compare two checkouts
of the repo in turns:

    python3 semantichuman_torch/tools/host_paths.py [--root DIR] [--reps N]

imports `semantichuman_torch` from the checkout DIR (default: the one that
holds this file; a checkout without this script works as well) and prints
one JSON line with the card, its power limit and three host-clock times,
each the median of its runs:

  * serve_b1_ms: one forward of the live full-width PartAE (the default
    ModelConfig, PartAE.init(0), the bundled topology) at B = 1 under
    inference_mode, input on the card: 50 forwards after 5, a synchronize
    at the end, N runs;
  * trainer_loop_ms: the paper recipe's loop (Config() defaults,
    epoch_scan off: eager steps at B = 4) on 64 synthetic meshes, each
    step followed by a synchronize, over epochs 2-3;
  * n3dmm_loop_ms: configs/train_neural3dmm.yaml (B = 16, the loop) on 48
    synthetic meshes instead of DFAUST, each step followed by a
    synchronize, over epochs 2-3.

These paths launch every kernel from the host one op at a time, so their
time moves with the host's cost per launch (a custom op's dispatch, say);
the card's busy time per step does not.  Kernels are built at first use
into DIR's `semantichuman_torch/_build/`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _steps_ms(trainer, epochs: int) -> list:
    """Host ms of each step of the last epochs-1 epochs of a fit, each
    step followed by a synchronize."""
    import torch

    times, last, epoch = [], [None], [0]
    get = trainer._get_step

    def get_step(ep, variant):
        step = get(ep, variant)

        def run(*args):
            out = step(*args)
            torch.cuda.synchronize()
            now = time.perf_counter()
            if last[0] is not None and ep > 1:
                times.append((now - last[0]) * 1e3)
            last[0] = now
            epoch[0] = ep
            return out
        return run

    trainer._get_step = get_step
    trainer.fit(epochs)
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    from semantichuman_torch.config import Config, ModelConfig
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": str(root), "card": card}

    human = SyntheticHuman()
    hier = MeshHierarchy.load(str(root / "assets"
                                  / "topology_synth_full_2222.npz"))
    model = build_model(ModelConfig(), hier, human.part_dict, device="cuda")
    params = model.init(0)
    m = human.sample_meshes(1, seed=0).astype(np.float32)
    x = torch.from_numpy(np.concatenate([m, np.zeros((1, 1, 3), np.float32)],
                                        1)).cuda()
    jreg = torch.as_tensor(human.J_regressor, dtype=torch.float32,
                           device="cuda")
    kps = torch.einsum("jv,bvc->bjc", jreg, x[:, :-1])[:, KPS_KEEP]
    runs = []
    with torch.inference_mode():
        for _ in range(args.reps):
            for _ in range(5):
                model(params, x, kps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                model(params, x, kps)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / 50)
    out["serve_b1_runs"] = runs
    out["serve_b1_ms"] = float(np.median(runs))
    del model, params

    cases = {
        "trainer_loop": Config.from_dict({
            "data": {"synthetic": True, "synthetic_train": 64,
                     "synthetic_test": 16},
            "train": {"epoch_scan": False}}),
        "n3dmm_loop": Config.from_dict({
            **{k: v for k, v in Config.from_yaml(str(
                root / "configs" / "train_neural3dmm.yaml")).to_dict()
               .items() if k != "data"},
            "data": {"synthetic": True, "synthetic_train": 48,
                     "synthetic_test": 16, "normalization": "zeroroot",
                     "measure": False},
        }),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg in cases.items():
            cfg = Config.from_dict({**cfg.to_dict(), "train": {
                **cfg.to_dict()["train"], "n_epochs": 3,
                "ck_frequency": 100, "save_recons": False,
                "eval_flag": False}})
            wd = os.path.join(tmp, name)
            os.makedirs(wd)
            tr = Trainer(cfg, wd, device="cuda")
            times = _steps_ms(tr, 3)
            out[f"{name}_steps"] = len(times)
            out[f"{name}_ms"] = float(np.median(times))
            del tr
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
