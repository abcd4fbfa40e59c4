"""Device ops: spiral convolution (a hand-written CUDA kernel beside its
plain PyTorch version), mesh pool/unpool, skeleton algebra, the distance
loss's sums, geometry operators and body measures; the kernels themselves
live in `ops.kernels` and build on first use.

The names below are those of `semantichuman_tpu/ops`.  `spiral_conv`,
`spiral_gather`, `pool` and `unpool` come from modules the models import
anyway; the rest load on first access, so that importing the package
loads no more than the models need."""

from .sampling import pool, unpool  # noqa: F401
from .spiral_conv import spiral_conv, spiral_gather  # noqa: F401

_LAZY = {
    "edit_skl": "skeleton", "kps2skl": "skeleton", "skl2kps": "skeleton",
    "pairwise_dist": "distance", "signed_part_volumes": "distance",
    "geodesics_in_heat": "geometry", "laplacian_apply": "geometry",
    "lumped_mass": "geometry", "mesh_volume": "geometry",
    "measure_body": "measure", "pack_girth_tables": "measure",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
