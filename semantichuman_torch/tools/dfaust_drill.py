"""DFAUST first-contact drill: the command sequence for the day real data
lands, as one script (the port's counterpart of `tools/dfaust_drill.py`,
with the same flags and --device).

Given the real artifacts --

  --asset_dir    dir with J_regressor.npy, vert_part_index_dict.npy,
                 factor_list.npy, edge_point_index_list.npy
                 (+ optionally edge_verts_index.npy)
                 (the reference asset contract, configure/cfgs.py:55-59)
  --template     template.obj (the registered template mesh)
  --checkpoint   a reference .pth.tar (train_funcs.py:450-455 layout)
  --data_root    (optional) DFAUST root with preprocessed/{train,test}.npy
                 -- enables the eval, demo and resume stages

-- runs, in order, stopping at the first failure with the failing stage
named:

  1. assets    : BodyAssets.load with full shape/dtype validation
                 (hostile-dtype coercion: sparse J_regressor, object
                 arrays -- data/assets.py)
  2. topology  : compile_topology on the template with the config's
                 ds_factors, step_sizes and dilation (cached)
  3. import    : checkpoint import (utils/import_torch.py) and one forward
                 of the template on --device
  4. eval      : cli.eval_reference full test-set metrics   [needs data]
  5. demo      : cli.demo edits off the imported checkpoint [needs data]
  6. resume    : cli.train --resume_torch for 1 epoch       [needs data]

  python -m semantichuman_torch.tools.dfaust_drill \\
      --asset_dir data/DFAUST/asset \\
      --template data/DFAUST/template/template.obj \\
      --checkpoint checkpoint300.pth.tar --data_root data/DFAUST \\
      --workdir results/dfaust_drill [--device cpu]

The last line printed is one JSON object, {"drill": "ok" | "failed",
"stages": {stage: summary or "FAILED"}}, and the exit code 0 or 1.
<workdir>/drill_stages.json records each stage that ran: its summary,
host seconds and kernel launches (`ops/launches.py`), and for resume the
Trainer's route (`epoch_scan`), its steps, evaluation batches and epoch
loss.  The data stages' Trainers start from the topology stage's compile
(a copy of its cache, which they trust only where its key is theirs).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
import traceback

import numpy as np
import torch

STAGES = ("assets", "topology", "import", "eval", "demo", "resume")
RECORD = "drill_stages.json"


def import_forward(cfg, assets, hier, checkpoint: str, device) -> tuple:
    """The import stage's work: the checkpoint's parameters in the model
    that the config's knobs build over `hier`, and one forward of the
    template (dummy row last) on `device`.  -> (epoch, rec [1, V+1, 3] as
    numpy)."""
    from ..constants import KPS_KEEP
    from ..models import build_model
    from ..utils.import_torch import load_reference_checkpoint

    model = build_model(cfg.model, hier, assets.part_dict, device=device)
    params, epoch = load_reference_checkpoint(checkpoint, model)
    x = np.zeros((1, len(assets.template_verts) + 1, 3), np.float32)
    x[0, :-1] = assets.template_verts
    kps = np.einsum("jv,bvd->bjd", assets.j_regressor.astype(np.float32),
                    x[:, :-1])[:, KPS_KEEP]
    with torch.no_grad():
        rec = model(params, torch.from_numpy(x).to(device),
                    torch.from_numpy(kps).to(device))[0]
    return epoch, rec.cpu().numpy()


def _read_config(path: str, default: str):
    """The port's Config of the checkpoint's model knobs: `path`, or the
    library defaults where the cwd-relative default does not exist."""
    from ..config import Config

    if os.path.exists(path):
        return Config.from_yaml(path)
    if path == default:
        print(f"note: default config {path!r} not found -> compiling with "
              "library-default topology knobs", flush=True)
        return Config()
    raise FileNotFoundError(
        f"--config {path!r} does not exist (the topology must be compiled "
        "with the checkpoint's own model knobs)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DFAUST first-contact drill.")
    ap.add_argument("--asset_dir", required=True)
    ap.add_argument("--template", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--workdir", default="results/dfaust_drill")
    config_default = "configs/train_dfaust.yaml"
    ap.add_argument("--config", default=config_default,
                    help="model config matching the checkpoint layout")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)

    from ..ops import launches

    results, record, state = {}, {}, {}

    def stage(name, fn):
        print(f"=== stage: {name} ===", flush=True)
        before = launches.read()
        t0 = time.perf_counter()
        try:
            out = fn() or "ok"
        except Exception:
            traceback.print_exc()
            out = "FAILED"
        if args.device.startswith("cuda") and torch.cuda.is_available():
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = launches.read()
        results[name] = out
        record[name] = {"summary": out, "seconds": secs,
                        "launches": {k: after[k] - before[k]
                                     for k in after},
                        **state.pop("extra", {})}
        if out == "FAILED":
            print(f"!!! drill FAILED at stage {name!r}", flush=True)
            return False
        print(f"    {name}: OK ({secs:.2f} s)", flush=True)
        return True

    def s_assets():
        from ..data.assets import BodyAssets
        a = BodyAssets.load(args.asset_dir, args.template)
        state["assets"] = a
        return (f"V={len(a.template_verts)} joints={a.j_regressor.shape[0]} "
                f"parts={len(a.part_dict)} girths={len(a.girth_edges)}")

    def s_topology():
        from ..topology import compile_topology
        # the checkpoint's layout is defined by the config's topology knobs
        # (ds_factors/step_sizes/dilation): compile with them, as the
        # Trainer does (train/loop.py:load_topology)
        cfg = _read_config(args.config, config_default)
        state["cfg"] = cfg
        a = state["assets"]
        h = compile_topology(
            a.template_verts, a.template_faces,
            ds_factors=cfg.model.ds_factors,
            step_sizes=cfg.model.step_sizes,
            dilation=cfg.model.dilation,
            reference_vertex=min(414, len(a.template_verts) - 1),
            cache_path=os.path.join(args.workdir, "topology.npz"))
        state["hier"] = h
        return f"sizes={list(h.sizes)}"

    def s_import():
        epoch, rec = import_forward(state["cfg"], state["assets"],
                                    state["hier"], args.checkpoint,
                                    args.device)
        assert np.all(np.isfinite(rec))
        return f"epoch={epoch} forward finite"

    ok = (stage("assets", s_assets) and stage("topology", s_topology)
          and stage("import", s_import))

    if ok and args.data_root:
        import yaml

        cfg_path = os.path.join(args.workdir, "drill_cfg.yaml")
        raw = {}
        if os.path.exists(args.config):
            with open(args.config) as f:
                raw = yaml.safe_load(f) or {}
        raw.setdefault("data", {})
        raw["data"]["root_dir"] = args.data_root
        raw["data"]["asset_dir"] = args.asset_dir
        raw["data"]["synthetic"] = False
        with open(cfg_path, "w") as f:
            yaml.safe_dump(raw, f)
        tag = "".join(str(f) for f in state["cfg"].model.ds_factors)

        def workdir(name):
            """A data stage's workdir, holding the topology stage's
            compile where the Trainer looks for its cache."""
            wd = os.path.join(args.workdir, name)
            os.makedirs(wd, exist_ok=True)
            for suffix in ("", ".meta"):
                shutil.copy(os.path.join(args.workdir, "topology.npz")
                            + suffix,
                            os.path.join(wd, f"topology_{tag}.npz" + suffix))
            return wd

        def s_eval():
            from ..cli import eval_reference
            rc = eval_reference.main([
                "--config", cfg_path, "--checkpoint", args.checkpoint,
                "--workdir", workdir("eval"), "--device", args.device])
            assert rc == 0
        ok = stage("eval", s_eval)

        def s_demo():
            from ..cli import demo
            demo.main(["--config", cfg_path, "--workdir", workdir("demo"),
                       "--checkpoint_torch", args.checkpoint,
                       "--skip_eval", "--n_samples", "1",
                       "--device", args.device])
        ok = ok and stage("demo", s_demo)

        def s_resume():
            from ..cli import train as train_cli
            epoch = int(torch.load(args.checkpoint, map_location="cpu",
                                   weights_only=False).get("epoch", 0))
            tr = train_cli.main(["--config", cfg_path,
                                 "--workdir", workdir("resume"),
                                 "--resume_torch", args.checkpoint,
                                 "--epochs", str(epoch + 1),
                                 "--device", args.device])
            loss = tr.history[-1]["train"]
            state["extra"] = {
                "epoch_scan": tr._epoch_scan_ok(),
                "steps": len(tr.train_loader),
                "eval_batches": len(tr.val_loader) + (
                    len(tr.test_loader) if tr.cfg.train.eval_flag else 0),
                "epoch": tr.history[-1]["epoch"], "loss": loss}
            assert np.isfinite(loss), f"resumed epoch loss {loss}"
        ok = ok and stage("resume", s_resume)
    elif ok:
        print("(no --data_root: eval/demo/resume stages skipped)")

    with open(os.path.join(args.workdir, RECORD), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"drill": "ok" if ok else "failed",
                      "stages": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
