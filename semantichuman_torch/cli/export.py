"""Export a trained workdir as a serving bundle (the port's counterpart of
`semantichuman_tpu/cli/export.py`).

  python -m semantichuman_torch.cli.export --config cfg.yaml \
      --workdir results/run1 [--resume DIR] [--out results/run1/bundle] \
      [--batch_size 64] [--fixed_batch] [--trunk_dtype bfloat16] \
      [--synthetic] [--device cpu]

Writes the forward/encode/decode `torch.export` programs, the payload and
manifest.json (see semantichuman_torch.serving), traced on the card unless
--device cpu; a bundle serves on the device type it was exported on.
Needs only the assets, the topology (the reference pickle, the bundled
hierarchy or the workdir's compile cache) and a checkpoint, not the
training dataset, so it runs on a serving host that never saw the data.
The JAX CLI's `enable_cache()` (JAX's compilation cache) has no
counterpart here.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export a serving bundle.")
    ap.add_argument("--config", default=None)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir (default: <workdir>/checkpoints)")
    ap.add_argument("--out", default=None,
                    help="bundle dir (default: <workdir>/bundle)")
    ap.add_argument("--batch_size", type=int, default=64,
                    help="fallback fixed batch (programs are "
                         "batch-polymorphic unless --fixed_batch)")
    ap.add_argument("--fixed_batch", action="store_true",
                    help="export fixed-batch programs instead of "
                         "symbolic-batch ones")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--trunk_dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="serving numeric policy override (default: the "
                         "config's trunk_dtype).  Checkpoints are "
                         "dtype-independent (params stay f32, the bf16 "
                         "trunk is a cast traced into the program), so an "
                         "f32-trained checkpoint exports to a bf16 bundle "
                         "directly")
    ap.add_argument("--device", default="cuda",
                    help="torch device to trace on and serve from "
                         "(default: the card)")
    args = ap.parse_args(argv)

    from ..config import Config
    from ..data.assets import BodyAssets
    from ..models import build_model
    from ..serving import export_inference
    from ..train.loop import load_topology
    from ..utils.checkpoint import restore_checkpoint

    cfg = Config.from_yaml(args.config) if args.config else Config()
    if args.trunk_dtype:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           trunk_dtype=args.trunk_dtype))
    if args.synthetic or cfg.data.synthetic:
        assets, _sh = BodyAssets.synthetic(
            n_theta=cfg.data.synthetic_n_theta,
            n_phi=cfg.data.synthetic_n_phi)
    else:
        assets = BodyAssets.load(
            cfg.data.asset_dir,
            os.path.join(cfg.data.root_dir, "template", "template.obj"))

    # the reference pickle (it MUST be the hierarchy the checkpoint was
    # trained against) or the template's compiled hierarchy, as the
    # Trainer loads it
    os.makedirs(args.workdir, exist_ok=True)
    hier = load_topology(cfg, assets, args.workdir)
    model = build_model(cfg.model, hier, assets.part_dict,
                        device=args.device)

    resume = args.resume or os.path.join(args.workdir, "checkpoints")
    state, step = restore_checkpoint(resume, device=args.device)
    print(f"restored checkpoint at epoch {state.get('epoch', step)}")

    out = args.out or os.path.join(args.workdir, "bundle")
    manifest = export_inference(model, state["params"],
                                assets.j_regressor, out,
                                batch_size=args.batch_size,
                                symbolic_batch=not args.fixed_batch)
    for name, meta in manifest["artifacts"].items():
        print(f"{name}: {meta['file']} (platforms {meta['platforms']})")
    print(f"bundle written to {out}")
    return manifest


if __name__ == "__main__":
    main()
