"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It drives `semantichuman_torch` on the card (never the JAX package), makes
its inputs and weights from the seed, warms every shape the cell uses
(set-up), measures for `--seconds`, checks what the timed path produced
against the plain reference (`bench_port/reference/`), and prints one JSON
line last: with `--trace 0` the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics from a profiled stretch of the window.  Without a
card, or with fewer cards than the cell asks for, it exits 2 and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# transformers, where installed, would load JAX through Flax
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import checks, manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "semantichuman_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def end_to_end(name: str, out: dict, t0: float) -> float:
    """An end-to-end metric of the run; a name's part after the first dot
    names the cells it is bounded over, not another quantity."""
    import numpy as np
    base = name.split(".")[0]
    if base == "setup_s":
        return out["window_start"] - t0
    if base in ("train_meshes_per_s", "serve_meshes_per_s"):
        return out["meshes"] / out["window_s"]
    if base == "serve_p95_ms":
        return float(np.percentile(np.asarray(out["latencies"]), 95)) * 1e3
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float) -> dict:
    """One run: -> the result object (without the check on modules)."""
    import importlib

    import torch

    kind = spec["traffic"]["kind"]
    driver = importlib.import_module(f"bench_port.drivers.{kind}")
    out = driver.run(name, spec["config"], spec["traffic"], seed, seconds,
                     trace, device, spec["limits"])
    res = {"correct": checks.correct(out["checks"]),
           "attempted": 1, "failed": 0, "metrics": {}}
    dev = torch.device(device)
    res["device"] = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace:
        from bench_port.drivers.common import model_shape
        from bench_port.trace import read
        tr = read(out["traced"])
        ctx = SimpleNamespace(kind=kind, traced=tr, out=out,
                              shape=model_shape(spec["config"]),
                              config=spec["config"], traffic=spec["traffic"])
        for m in spec["per_layer"]:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                res["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        res["device"]["busy_s"] = tr.busy_s
        res["device"]["window_s"] = tr.window_s
        res["breakdown"] = tr.breakdown()
    else:
        for m in spec["end_to_end"]:
            res["metrics"][m["name"]] = {
                "value": end_to_end(m["name"], out, t0), "unit": m["unit"]}
    res["checks"] = out["checks"]
    res["setup"] = {k: round(t - t0, 3) for k, t in out.get("marks", [])}
    res["readings"] = out.get("readings")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load(Path.cwd())
    spec = manifest.cell(bench, Path.cwd(), args.workload)

    import torch
    need = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench_port: the cell {args.workload} needs {need} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    card = power_limit()
    res = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}", file=sys.stderr)
        return 3
    res["power"] = card
    print(f"setup (s since start): {res.pop('setup')}", file=sys.stderr)
    print(f"readings: {res.pop('readings')}", file=sys.stderr)
    checks_ = res.pop("checks")
    res["checks"] = checks_
    for k, c in checks_.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(res)))
    return 0


def _finite(x):
    """The result with every number a JSON number: a value that is not
    finite (a check that could not be read) as its name."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


if __name__ == "__main__":
    sys.exit(main())
