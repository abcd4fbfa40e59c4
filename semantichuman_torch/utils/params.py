"""Parameters between the two packages.

Both keep a model's parameters as a nested dict with the same keys
(`conv`/`dconv` lists of {"w", "b"}, then PartAE's `enc_heads`/
`dec_heads`/`kps_heads` or SpiralAE's `fc_enc`/`fc_dec`, each {"w", "b"})
and the same shapes, so moving them is a leaf-wise copy.
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
    np.asarray, params)`) -> the port's tree of contiguous float32 tensors
    on `device` (torch.tensor keeps a transposed array's strides, and a
    matmul over other strides rounds otherwise)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                               device=dev),
        np_params)


def params_to_numpy(params) -> dict:
    """Inverse of params_from_jax: float32 numpy leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in tree_map's order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: tuple = ()) -> list:
    """The key path (dict keys and list positions) of every leaf, in
    tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, prefix
                                                              + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, prefix + (i,))]
    return [prefix]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like `like` holding `leaves` (tree_leaves' order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
