"""The benchmark loads neither JAX nor the JAX package, and its plain
reference nothing of the program it judges.  Top-level module names are
compared whole: the port's own name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "semantichuman_tpu"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh process holds after `code`."""
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = "\n".join(
        ["import bench_port.run, bench_port.drivers.train",
         "import bench_port.drivers.serve, bench_port.tools.readings",
         "import semantichuman_torch.train.loop, semantichuman_torch.serving",
         "from bench_port import manifest"]
        + [f"manifest.metric_reader({m['name']!r})"
           for m in bench["per_layer"]])
    assert not (_loaded(code) & JAX)


def test_reference_loads_nothing_of_the_program():
    code = ("import bench_port.reference.model, bench_port.reference.train,"
            " bench_port.reference.constants")
    assert not (_loaded(code) & (JAX | {"semantichuman_torch"}))


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "bench_port" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in JAX | {"semantichuman_torch",
                                                     "bench_port"}, (path, n)
