"""Replication, reduction and row gathers over the process group
(counterpart of `semantichuman_tpu/parallel/mesh.py`'s `put_replicated`,
`fully_replicate` and `shard_batch`).

Every function here is a collective: each rank of the group calls it in
the same order.  Only `broadcast`, `all_reduce` and `barrier` are used,
the collectives gloo also runs on CUDA tensors, so two ranks can share one
card under gloo as they share a host's CPU.  Without a process group each
function returns its input as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.params import tree_leaves
from .distributed import process_count, process_index


def put_replicated(tree):
    """Broadcast every tensor leaf of `tree` from rank 0 in place; returns
    the tree."""
    if dist.is_initialized():
        for leaf in tree_leaves(tree):
            dist.broadcast(leaf, src=0)
    return tree


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of t (a new tensor, outside autograd): counts and
    eval sums."""
    out = t.detach().clone()
    if dist.is_initialized():
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of t: the sum, then a division by the world
    size as a float32 tensor (exact over one rank)."""
    out = all_reduce_sum(t)
    return out / torch.tensor(float(process_count()), dtype=out.dtype,
                              device=out.device)


def all_reduce_grads(grads: list) -> list:
    """The mean over ranks of each gradient tensor, reduced as one flat
    buffer per dtype: SUM, then a division by the world size as a float32
    tensor.  Returns new tensors in the order of `grads`."""
    if not dist.is_initialized():
        return list(grads)
    out = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        pos = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in pos])
        flat = all_reduce_mean(flat)
        for i, part in zip(pos, flat.split([grads[i].numel() for i in pos])):
            out[i] = part.view(grads[i].shape)
    return out


def fully_replicate(t: torch.Tensor) -> torch.Tensor:
    """The global rows of a batch-major tensor whose rank r holds rows
    [r*b, (r+1)*b): [world*b, ...] on every rank, outside autograd.  An
    all-reduce of a zero-filled buffer in which each rank writes its own
    rows (x + 0 = x, so exact), which gloo runs on CUDA tensors too."""
    world = process_count()
    if world == 1:
        return t.detach()
    b = t.shape[0]
    buf = t.new_zeros((world * b,) + tuple(t.shape[1:]))
    buf[process_index() * b:(process_index() + 1) * b] = t.detach()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def local_rows(t, rank: int | None = None, world: int | None = None):
    """This rank's contiguous rows of a global batch-major array or tensor
    (rows [r*per, (r+1)*per))."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if t.shape[0] % world:
        raise ValueError(f"a batch of {t.shape[0]} rows is not divisible by "
                         f"{world} processes")
    per = t.shape[0] // world
    return t[rank * per:(rank + 1) * per]


def shard_batch(batch: dict, rank: int | None = None,
                world: int | None = None) -> dict:
    """This rank's rows of a global batch held whole: every array or
    tensor with a leading axis is cut.  The data loaders slice their own
    batches (`BatchLoader(process_slice=...)`)."""
    return {k: local_rows(v, rank, world)
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


# the edit spec's batch-major entries, by name (as the JAX Trainer's
# put_stacked decides by name, never by matching a dimension's size)
BATCH_MAJOR_SPEC = ("a_full",)


def shard_spec(spec: dict, rank: int | None = None,
               world: int | None = None) -> dict:
    """This rank's view of an edit spec drawn over the global batch: the
    rows of `a_full` [B, 17]; `edited_mask`, `n_edited` and the rest stay
    whole (every rank draws the same spec from the same seed)."""
    return {k: local_rows(v, rank, world) if k in BATCH_MAJOR_SPEC else v
            for k, v in spec.items()}


def barrier() -> None:
    """Wait for every rank (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()
