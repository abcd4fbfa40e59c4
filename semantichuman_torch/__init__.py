"""semantichuman_torch — the PyTorch/CUDA port of semantichuman_tpu.

It mirrors the JAX package's module layout and names, imports neither JAX
nor the JAX package, and runs on an NVIDIA Hopper card (H100):

  * `topology` — the host-side topology compiler (QEM hierarchy, spiral
                 orderings, pool/unpool tables; the C++ AABB tree for its
                 nearest-point queries) and the cached MeshHierarchy (.npz).
  * `ops`      — spiral conv, pool/unpool, the row gather and CSR reduce,
                 the distance loss's sums, skeleton algebra, geometry and
                 measures; hand-written CUDA kernels in `csrc/`, built on
                 first use, each beside its plain PyTorch version.
  * `models`   — PartAE and SpiralAE with explicit parameter dicts, their
                 device tables and the spiral-conv trunk.
  * `train`    — the loss stack, the step, Adam, the Trainer (loop and
                 captured epoch path) and checkpoints.
  * `data`     — synthetic assets, the DFAUST files, loaders and the
                 device-resident data.
  * `edit`     — the Editor and run_demo: semantic edits on a trained model.
  * `serving`  — export_inference / ServingBundle: `torch.export` programs
                 with a captured forward at small batch on the card, one
                 copy per listed device.
  * `parallel` — data parallelism over torch.distributed.
  * `cli`      — make_synthetic / obj2npy / data_generation / train / demo
                 / export / eval_reference / convergence_run.
  * `tools`    — the DFAUST drill, data-parallel fits, the serving A/B and
                 the host-path timings.

Entry points take `device=` and default to "cuda"; on a host without a card
they raise unless the caller passes device="cpu".  Importing the package
builds and loads nothing; Config, Trainer, Editor and compile_topology
import on first access.
"""

from .config import ModelConfig  # noqa: F401
from .models import PartAE, build_model  # noqa: F401
from .serving import ServingBundle, export_inference  # noqa: F401
from .topology import MeshHierarchy  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "Config": ("semantichuman_torch.config", "Config"),
    "Trainer": ("semantichuman_torch.train.loop", "Trainer"),
    "Editor": ("semantichuman_torch.edit", "Editor"),
    "compile_topology": ("semantichuman_torch.topology", "compile_topology"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
