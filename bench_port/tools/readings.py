"""The readings that the limits of `correct` are set from, at a cell's own
size, many seeds in one process (no measured window: a training cell's
readings are its first three steps, a serving cell's the sampled
requests of a short window at the cell's load).

    python3 -m bench_port.tools.readings --workload <cell> \
        --mode sound|control|half --seeds 11 12 13 ...

  sound    the program as the configuration states, against the reference
  control  the program's own lower-precision path (the bfloat16 trunk)
           against the float32 reference
  half     training: the reference with half of every batch left out (the
           mean over the rest: the first half twice) in the program's place

One JSON line a seed: {"seed", "mode", numbers...}.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from bench_port import checks, manifest
from bench_port.drivers import common as C
from bench_port.drivers import serve as S
from bench_port.drivers import train as T

BF16 = {"trunk_dtype": "bfloat16"}


def _half(idx):
    """Half of a batch left out, the mean taken over the rest: the first
    half twice, at the batch's shape."""
    h = idx[:len(idx) // 2]
    return np.concatenate([h, h])


def train_reading(name, spec, seed, mode, device) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    if mode == "half":
        h = C.human(config)
        verts = h.meshes(traffic["n_train"], seed, device)
        meas = (h.measures(verts) if traffic["data"].get("measure", True)
                else None)
        from bench_port.synth import make_params
        trainer, _ = T._trainer(config, traffic, seed, device, name)
        params = make_params(trainer.params, seed, device)
        del trainer
        C.free(device)
        inputs = {"human": h, "verts": verts, "measures": meas,
                  "params": params, "seed": seed}
        prog = T.reference_readings(config, traffic, inputs, device,
                                    rows=_half)
    else:
        trainer, inputs = T._trainer(config, traffic, seed, device, name,
                                     BF16 if mode == "control" else None)
        inputs["seed"] = seed
        first = T.first_epoch(trainer)
        prog = T.program_readings(first, C.leaves(inputs["params"]))
        del trainer, first
        C.free(device)
    ref = T.reference_readings(config, traffic, inputs, device)
    return checks.train_numbers(prog, ref)


def serve_reading(name, spec, seed, mode, device, seconds) -> dict:
    if mode != "control":
        out = S.run(name, spec["config"], spec["traffic"], seed, seconds,
                    False, device, spec["limits"])
        return {k: c["value"] for k, c in out["checks"].items()}
    config = spec["config"]
    h = C.human(config)
    wd = C.workdir(name)
    _d, params = S.export(config, h, seed, device, wd)
    low, _ = S.export(config, h, seed, device, C.workdir(name + ".bf16"),
                      BF16)
    from semantichuman_torch.serving import ServingBundle
    bundle = ServingBundle(low, device=device)
    traffic = spec["traffic"]
    pool = S.inputs(config, traffic, seed, h, device)
    got, eager = [], []
    for e in traffic["edits"]:
        for b in traffic["batches"]:
            got.append((b, 0, e, S.run_edit(
                lambda art, *a: S._host(bundle.call(art, *a)), traffic,
                pool, b, 0, e)))
            eager.append((b, 0, e, S.run_edit(
                lambda art, *a: S._host(bundle.call(art, *a, graph=False)),
                traffic, pool, b, 0, e)))
    del bundle
    C.free(device)
    ref = S.Reference(config, h, params, device)
    return {"serve_gap": S.gap([d for *_x, d in got],
                               S.reference_edits(ref, traffic, pool, got)),
            "eager_gap": S.gap([d for *_x, d in eager],
                               S.reference_edits(ref, traffic, pool, eager))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control", "half"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.cell(manifest.load(Path.cwd()), Path.cwd(),
                         args.workload)
    for seed in args.seeds:
        if spec["traffic"]["kind"] == "train":
            nums = train_reading(args.workload, spec, seed, args.mode, "cuda")
        else:
            nums = serve_reading(args.workload, spec, seed, args.mode, "cuda",
                                 args.seconds)
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "mode": args.mode, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
