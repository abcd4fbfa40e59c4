"""semantichuman_torch — the PyTorch/CUDA port of semantichuman_tpu.

It mirrors the JAX package's module layout and names, imports neither JAX
nor the JAX package, and runs on an NVIDIA Hopper card (H100):

  * `topology` — loads a compiled MeshHierarchy (.npz).
  * `models`   — PartAE with explicit parameter dicts, its device tables and
                 the spiral-conv trunk.
  * `ops`      — spiral conv (hand-written CUDA kernel in `csrc/`, built on
                 first use, beside its plain PyTorch version), pool/unpool.
  * `edit`     — the Editor and run_demo: semantic edits on a trained model.
  * `serving`  — export_inference / ServingBundle: `torch.export` programs
                 with a captured forward at small batch on the card.

Entry points take `device=` and default to "cuda"; on a host without a card
they raise unless the caller passes device="cpu".  Importing the package
builds and loads nothing.
"""

from .config import ModelConfig  # noqa: F401
from .models import PartAE, build_model  # noqa: F401
from .serving import ServingBundle, export_inference  # noqa: F401
from .topology import MeshHierarchy  # noqa: F401

__version__ = "0.1.0"
