"""Parameters between the two packages.

Both keep PartAE parameters as a nested dict with the same keys
(`conv`/`dconv` lists of {"w", "b"}, `enc_heads`/`dec_heads`/`kps_heads`
{"w", "b"}) and the same shapes, so moving them is a leaf-wise copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(np_params, device="cuda") -> dict:
    """The JAX parameter tree with numpy leaves (e.g. `jax.tree.map(
    np.asarray, params)`) -> the port's tree of float32 tensors on
    `device`."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=dev),
        np_params)


def params_to_numpy(params) -> dict:
    """Inverse of params_from_jax: float32 numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
