"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs[].file`), its traffic (`bench_port/workloads/
<traffic>.json`), its limits (`bench_port/limits/<cell>.json`) and each
per-layer metric's reader (`bench_port/metrics/<metric>.py`, a function
`read(ctx)`).  A cell, traffic mix, configuration or metric is added with
files and entries alone."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def traffic_names(here: Path = HERE) -> list:
    """Every traffic mix the harness can run: one file each."""
    return sorted(p.stem for p in (here / "workloads").glob("*.json"))


def metric_reader(name: str, here: Path = HERE):
    """The `read(ctx)` of per-layer metric `name`."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, root: Path, name: str, here: Path = HERE) -> dict:
    """Everything one cell runs from: its entry, configuration, traffic,
    limits and metrics (end-to-end and per-layer, those that apply)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(here / "workloads" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    lim = here / "limits" / f"{name}.json"
    limits = json.loads(lim.read_text()) if lim.exists() else {}

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and applies(m)]
    return {"entry": entry, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": layer}
