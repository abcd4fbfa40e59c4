"""The port stands alone: no module of semantichuman_torch, and not
chip_smoke.py, imports JAX, the JAX package or the repo's root `tools` and
`benchmarks` packages, and importing the port on a host without a card,
nvcc or triton loads none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "semantichuman_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
# the JAX package, and the repo's root `tools` and `benchmarks` packages,
# whose modules import it
FORBIDDEN = ("jax", "jaxlib", "semantichuman_tpu", "tools", "benchmarks")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES)
def test_no_jax_imports(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax():
    code = ("import sys, semantichuman_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
