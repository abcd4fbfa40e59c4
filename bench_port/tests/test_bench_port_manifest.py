"""BENCHMARK.json against the benchmark's contract, its files found by
name, a cell added with files alone, and no fall-back to the CPU."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load(ROOT)


def _line(text) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names(bench):
    assert set(bench) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATHS.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_resolves(bench):
    """Each cell's configuration, traffic, limits and per-layer readers
    are found by name; each reports setup_s, another end-to-end metric and
    a per-layer metric; each configuration has a cell."""
    for w in bench["workloads"]:
        spec = manifest.cell(bench, ROOT, w["name"])
        assert spec["config"]["model"]["model_type"]
        assert spec["traffic"]["kind"] in ("train", "serve")
        assert spec["limits"], w["name"]
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(manifest.metric_reader(m["name"]))
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("bench_port/") for f in files)


def test_a_cell_added_with_files_alone(tmp_path, bench):
    """A traffic mix, its limits and a cell entry dropped into a copy are
    found without a code edit."""
    here = tmp_path / "bench_port"
    shutil.copytree(ROOT / "bench_port", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((here / "workloads" / "serve_edit.json").read_text())
    mix["batches"] = [64]
    (here / "workloads" / "serve_bulk.json").write_text(json.dumps(mix))
    (here / "limits" / "partae.serve_bulk.json").write_text(
        json.dumps({"serve_gap": 1e-5}))
    assert "serve_bulk" in manifest.traffic_names(here)
    added = dict(bench)
    added["workloads"] = bench["workloads"] + [{
        "name": "partae.serve_bulk", "config": "partae",
        "traffic": "serve_bulk", "chips": 1, "why": "bulk"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    shutil.copytree(ROOT / "assets", tmp_path / "assets")
    spec = manifest.cell(manifest.load(tmp_path), tmp_path,
                         "partae.serve_bulk", here=here)
    assert spec["traffic"]["batches"] == [64]
    assert spec["limits"] == {"serve_gap": 1e-5}


def test_no_card_no_result(tmp_path):
    """A measurement run that finds no card exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "partae.train_b4", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
