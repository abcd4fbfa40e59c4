"""Fixtures of the benchmark's CPU tests: a small synthetic body (12 x 24
rings, 290 vertices) with its hierarchy compiled once, slim filters, and
each cell's entry from BENCHMARK.json cut to that size."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from bench_port import manifest

ROOT = Path(__file__).resolve().parents[2]
SMALL_FILTERS = {"filter_sizes_enc": [[3, 8, 8, 16, 16], [[], [], [], [], []]],
                 "filter_sizes_dec": [[16, 16, 8, 8, 8], [[], [], [], [], 3]]}


@pytest.fixture(scope="session")
def small_topology(tmp_path_factory):
    from semantichuman_torch.topology import compile_topology
    from bench_port.synth import Human
    h = Human(12, 24)
    path = tmp_path_factory.mktemp("topo") / "topology.npz"
    compile_topology(h.template_verts, h.template_faces,
                     ds_factors=[2, 2, 2, 2], step_sizes=[2, 2, 1, 1, 1],
                     dilation=[2, 2, 1, 1, 1],
                     reference_vertex=min(414, len(h.template_verts) - 1),
                     cache_path=str(path))
    return str(path)


@pytest.fixture
def small_cell(small_topology):
    """cell name -> its spec at the small size (the cell's traffic, limits
    and metrics; 64 train meshes, batch_test 4; 50 traced requests).  A
    cell that BENCHMARK.json does not hold is built from the files named
    `<config>.<traffic>`."""
    bench = manifest.load(ROOT)

    def make(name: str) -> dict:
        if any(w["name"] == name for w in bench["workloads"]):
            spec = copy.deepcopy(manifest.cell(bench, ROOT, name))
        else:
            conf, traffic = name.split(".")
            here = ROOT / "bench_port"
            spec = {"config": load_json(here / "configs" / f"{conf}.json"),
                    "traffic": load_json(here / "workloads"
                                         / f"{traffic}.json"),
                    "limits": load_json(here / "limits" / f"{name}.json"),
                    "end_to_end": [], "per_layer": []}
        cfg = spec["config"]
        cfg["template"] = {"n_theta": 12, "n_phi": 24}
        cfg["topology"] = small_topology
        cfg["model"].update(SMALL_FILTERS)
        if cfg["model"]["model_type"] == "neural3DMM":
            cfg["model"]["nz"] = 16
        t = spec["traffic"]
        if t["kind"] == "train":
            t["n_train"], t["n_test"] = 64, 8
            t["train"]["batch_test"] = 4
            if t["train"]["batch_train"] > 16:
                t["train"].update(batch_train=8, batch_interp=4)
        else:
            t["traced_requests"] = 50
        return spec

    return make


def load_json(path):
    with open(path) as f:
        return json.load(f)
