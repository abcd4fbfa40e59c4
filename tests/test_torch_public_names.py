"""The port's completeness as a check: every public name of the JAX package
has its counterpart in the port, or stands in one of two tables here.

For each module `semantichuman_tpu/<path>.py` an `ast` walk lists its
public top-level functions and classes, the public methods of those
classes and its upper-case module constants; each must be defined in
`semantichuman_torch/<path>.py` (a method in the class of the same name).
A name passes otherwise only through `RENAMED` (the port's counterpart
under another name or in another module, which must exist) or `JAX_ONLY`
(a TPU mechanism the port does not carry, with the reason).  A table
entry that names something the JAX package no longer has, or a JAX_ONLY
name the port now has, fails as stale.  Every name a JAX `__init__.py`
exports (its imports and `_LAZY`) must resolve on the port's package of
the same path.

The walk imports nothing; only the export check imports the port.  Adding
a public name to the JAX package therefore needs its port counterpart or
an entry here.
"""

import ast
import importlib
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "semantichuman_tpu"
PORT = ROOT / "semantichuman_torch"

# "jax path:name" -> ("port path:name", reason).  A renamed class brings
# its methods: each must exist in the port's class.
RENAMED = {
    "ops/spiral_conv.py:spiral_conv_take": (
        "ops/spiral_conv.py:spiral_conv_plain",
        "the reference math is the plain PyTorch version of row 1"),
    "ops/sampling.py:pool_take": (
        "ops/sampling.py:pool",
        "pool is the take route over a GatherTable; no other route is "
        "ported"),
    "topology/compiler.py:MeshHierarchy": (
        "topology/hierarchy.py:MeshHierarchy",
        "the artifact class has its own module, beside the compiler"),
}

# "jax path" (the whole module) or "jax path:name" -> reason
JAX_ONLY = {
    "ops/pallas/spiral_conv_pallas.py":
        "row 1: csrc/spiral_conv_fwd.cu and csrc/spiral_conv_bwd.cu",
    "ops/pallas/part_dist_pallas.py":
        "rows 2-4: csrc/part_dist.cu",
    "ops/pallas/banded_gather_pallas.py":
        "rows 5-6: csrc/banded_gather.cu",
    "ops/spiral_conv.py:spiral_conv_onehot":
        "a TPU gather-engine workaround with the take route's values",
    "ops/spiral_conv.py:spiral_conv_banded_pallas":
        "the Pallas banded conv; the port's is spiral_conv_banded",
    "ops/sampling.py:pool_dense":
        "a one-hot form for the TPU's gather engine",
    "ops/sampling.py:unpool_dense":
        "a one-hot form for the TPU's gather engine",
    "ops/sampling.py:pool_banded":
        "pool bands: the JAX gate _pool_band_ok is always False",
    "ops/sampling.py:unpool_banded_pallas":
        "the Pallas banded unpool; the port's banded unpool is row 5",
    "ops/banding.py:banded_apply":
        "the port's banded route is ops/banded_gather.py",
    "models/tables.py:DeviceTables.pool_band_for":
        "pool bands: the JAX gate _pool_band_ok is always False",
    "parallel/mesh.py:make_mesh":
        "a jax.sharding Mesh; the port runs one process per card",
    "parallel/mesh.py:batch_sharding":
        "a jax.sharding NamedSharding; the port's is shard_batch",
    "parallel/mesh.py:replicated_sharding":
        "a jax.sharding NamedSharding; the port's is put_replicated",
    "parallel/mesh.py:shard_params":
        "jax.device_put over a Mesh; the port's is put_replicated",
    "parallel/distributed.py:global_batch_mesh":
        "a jax.sharding Mesh over every process's devices",
    "utils/compilation_cache.py:enable_cache":
        "JAX's compile cache; the port caches its builds in "
        "ops/kernels/build.py",
}

_CONST = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _targets(node) -> list:
    if isinstance(node, ast.Assign):
        return [n.id for t in node.targets for n in ast.walk(t)
                if isinstance(n, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                      ast.Name):
        return [node.target.id]
    return []


def public_names(path: Path) -> list:
    """Public functions and classes, `Class.method` for their public
    methods, and upper-case constants defined at a module's top level."""
    out = []
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            out.append(node.name)
            out += [f"{node.name}.{b.name}" for b in node.body
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not b.name.startswith("_")]
        else:
            out += [n for n in _targets(node) if _CONST.match(n)]
    return out


def defined(path: Path) -> set:
    """Every name a module defines at its top level (functions, classes,
    assignments) and `Class.attr` for each function or assignment in a
    class body; imports do not count."""
    if not path.exists():
        return set()
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{b.name}")
                out.update(f"{node.name}.{n}" for n in _targets(b))
        else:
            out.update(_targets(node))
    return out


def _split(key: str) -> tuple:
    path, _, name = key.partition(":")
    return path, name


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                     if public_names(p))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_port_counterpart(rel):
    """Each public name of semantichuman_tpu/<rel> is defined in
    semantichuman_torch/<rel>, renamed, or JAX-only."""
    if rel in JAX_ONLY:
        assert not (PORT / rel).exists(), (
            f"{rel} is JAX_ONLY as a whole, but the port has the module")
        return
    have = defined(PORT / rel)
    renamed = {_split(k)[1]: v for k, v in RENAMED.items()
               if _split(k)[0] == rel}
    missing = []
    for name in public_names(JAX / rel):
        cls = name.partition(".")[0]
        if f"{rel}:{name}" in JAX_ONLY:
            continue
        if name in renamed or cls in renamed:
            target = renamed.get(name, renamed.get(cls))[0]
            tpath, tname = _split(target)
            tname = tname + name[len(cls):] if name not in renamed else tname
            if tname not in defined(PORT / tpath):
                missing.append(f"{name} (renamed to {tpath}:{tname})")
        elif name not in have:
            missing.append(name)
    assert not missing, (
        f"semantichuman_torch/{rel} lacks the counterparts of {missing}: "
        "port them, or list them in RENAMED or JAX_ONLY with the reason")


def test_no_stale_table_entry():
    """Every RENAMED and JAX_ONLY entry names something the JAX package
    still has; no JAX_ONLY name is in the port; every reason is given."""
    stale = []
    for key in list(RENAMED) + list(JAX_ONLY):
        path, name = _split(key)
        if not (JAX / path).exists() or (
                name and name not in public_names(JAX / path)):
            stale.append(key)
    for key in JAX_ONLY:
        path, name = _split(key)
        if name and name in defined(PORT / path):
            stale.append(f"{key} (the port has it)")
    assert not stale, f"stale table entries: {stale}"
    assert all(isinstance(v, str) and v for v in JAX_ONLY.values())
    assert all(len(v) == 2 and v[1] for v in RENAMED.values())


def _module_path(module: str) -> str:
    """'semantichuman_tpu.a.b' -> the path of its file under the package
    root: 'a/b.py' or 'a/b/__init__.py'."""
    rel = Path(*module.split(".")[1:])
    return str(rel / "__init__.py") if (JAX / rel).is_dir() \
        else f"{rel}.py"


def exports(init: Path) -> dict:
    """{name: the JAX module path it comes from} for the names a package's
    `__init__.py` imports from its modules and lists in `_LAZY`."""
    pkg = ".".join(("semantichuman_tpu",) + init.parent.relative_to(
        JAX).parts)
    out = {}
    for node in _tree(init).body:
        if isinstance(node, ast.ImportFrom) and node.level and node.module:
            base = pkg.rsplit(".", node.level - 1)[0] if node.level > 1 \
                else pkg
            src = _module_path(f"{base}.{node.module}")
            out.update({a.asname or a.name: src for a in node.names})
        elif "_LAZY" in _targets(node):
            for k, v in zip(node.value.keys, node.value.values):
                module, _attr = (e.value for e in v.elts)
                out[k.value] = _module_path(module)
    return out


JAX_PACKAGES = sorted(str(p.parent.relative_to(JAX)) for p in
                      JAX.rglob("__init__.py") if exports(p))


@pytest.mark.parametrize("pkg", JAX_PACKAGES)
def test_package_exports_resolve_on_the_port(pkg):
    """Each name a JAX package exports resolves, through getattr, on the
    port's package of the same path to an object, not a module (JAX-only
    names excepted, renamed ones under the port's name)."""
    init = JAX / pkg / "__init__.py"
    port = importlib.import_module(
        "semantichuman_torch" + ("" if pkg == "." else "." + pkg.replace(
            "/", ".")))
    unresolved = []
    for name, src in exports(init).items():
        if f"{src}:{name}" in JAX_ONLY or src in JAX_ONLY:
            continue
        target = _split(RENAMED.get(f"{src}:{name}", (f":{name}",))[0])[1]
        obj = getattr(port, target, None)
        if obj is None or isinstance(obj, types.ModuleType) \
                or target not in dir(port):
            unresolved.append(name)
    assert not unresolved, (
        f"{port.__name__} does not export {unresolved}")


def test_top_level_names_are_the_port_objects():
    """The lazy top-level names resolve to the port's objects; the names
    the package exported before stay importable."""
    import semantichuman_torch as T
    from semantichuman_torch import (MeshHierarchy, ModelConfig,  # noqa: F401
                                     PartAE, ServingBundle, build_model,
                                     export_inference)
    from semantichuman_torch.config import Config
    from semantichuman_torch.edit.editor import Editor
    from semantichuman_torch.topology.compiler import compile_topology
    from semantichuman_torch.train.loop import Trainer

    assert T.Config is Config and T.Trainer is Trainer
    assert T.Editor is Editor and T.compile_topology is compile_topology
    assert {"Config", "Trainer", "Editor", "compile_topology"} <= set(dir(T))
    with pytest.raises(AttributeError):
        T.no_such_name  # noqa: B018


# the port's modules that load only on first access, not at import
_LAZY_MODULES = ("semantichuman_torch.train", "semantichuman_torch.edit",
                 "semantichuman_torch.parallel", "semantichuman_torch.data",
                 "semantichuman_torch.ops.skeleton",
                 "semantichuman_torch.ops.distance",
                 "semantichuman_torch.ops.geometry",
                 "semantichuman_torch.ops.measure")


def test_import_builds_and_loads_nothing():
    """`import semantichuman_torch` in a fresh process imports no JAX, no
    JAX package, no Trainer and none of the lazily loaded modules; neither
    it nor resolving every exported name of the package, `ops` and
    `parallel` builds or loads a kernel library."""
    code = (
        "import json, sys\n"
        "import semantichuman_torch as T\n"
        "mods = sorted(sys.modules)\n"
        "from semantichuman_torch import ops, parallel\n"
        "from semantichuman_torch.ops.kernels import build\n"
        "for pkg in (T, ops, parallel):\n"
        "    [getattr(pkg, n) for n in dir(pkg) if not n.startswith('_')]\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'modules': mods, "
        "'loaded': build.load.cache_info().currsize, "
        "'mapped': '_build/' in maps}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    mods = got["modules"]
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                        "semantichuman_tpu")]
    assert "semantichuman_torch.train.loop" not in mods
    assert not [m for m in mods if m.startswith(_LAZY_MODULES)]
    assert got["loaded"] == 0 and not got["mapped"]
