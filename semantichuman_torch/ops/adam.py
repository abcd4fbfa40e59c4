"""The training step's optimizer on the card (`csrc/adam.cu`): the
gradients' global norm and one Adam step over a table of every leaf.

`train/optim.py` calls these for CUDA tensors; CPU tensors take its plain
version, the chain of PyTorch calls that the kernels replace.  Three
kernels, each counted in its function's `launches`:

  * `adam_sumsq`  the sum of g^2 of each chunk of every leaf and a flag,
                  set where an entry of the chunk is NaN or Inf;
  * `adam_norm`   one block: the chunks' sums added in a fixed order and
                  the square root, the flags or-ed (`grad_norm` runs both);
  * `adam_update` one Adam step, the clip, the coupled decay and, in place,
                  the skip rule's `keep` flag, per entry as the plain
                  version computes it (the kernel's note).

The leaf table (`leaf_plan`), built once per list of leaf sizes: each leaf
cut into chunks of `CHUNK` entries (the last one the rest), a block a
chunk, so that a leaf of 14 M entries and one of 16 fill the card in one
launch; at most `MAX_LEAVES` leaves a launch, which take their pointers
as the kernel's parameters (a captured graph records them), and a longer
list more than one launch.  Chunks are numbered over every launch in leaf
order: chunk k's sum lands in row k of the partial sums, which the norm's
one block adds in order.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .kernels import build

CHUNK = 4096          # entries a block
MAX_LEAVES = 32       # leaves a launch: the kernel's table (kMaxLeaves)


@dataclass(frozen=True)
class Launch:
    """Leaves lo .. hi - 1 in one launch; `first` [hi - lo + 1] int32: the
    launch's first chunk of each leaf (a prefix of ceil(n / CHUNK)), and
    `base` its first chunk's row among every launch's partial sums."""
    lo: int
    hi: int
    first: np.ndarray
    base: int


@dataclass(frozen=True)
class LeafPlan:
    sizes: tuple
    chunk: int
    launches: tuple
    n_chunks: int


@functools.lru_cache(maxsize=64)
def leaf_plan(sizes: tuple) -> LeafPlan:
    """The launches over leaves of `sizes` entries: at most MAX_LEAVES
    leaves a launch, in order, every leaf cut into ceil(n / CHUNK) chunks
    (none for an empty leaf)."""
    launches, base = [], 0
    for lo in range(0, len(sizes), MAX_LEAVES):
        hi = min(lo + MAX_LEAVES, len(sizes))
        per = [-(-int(n) // CHUNK) for n in sizes[lo:hi]]
        first = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
        launches.append(Launch(lo, hi, first, base))
        base += int(first[-1])
    return LeafPlan(tuple(int(n) for n in sizes), CHUNK, tuple(launches),
                    base)


def _check(tensors, device, name: str) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, the gradients on "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _pointers(rows) -> np.ndarray:
    return np.array([[0 if t is None else t.data_ptr() for t in row]
                     for row in rows], dtype=np.uint64)


def _vec(ptrs: np.ndarray) -> int:
    """Bit i set where every pointer of leaf i (column i) is 16-byte
    aligned, null pointers aside."""
    ok = np.all(ptrs % 16 == 0, axis=0)
    return sum(1 << i for i, good in enumerate(ok) if good)


def _leaves(grads):
    device = grads[0].device
    if device.type != "cuda":
        raise ValueError(f"the optimizer's kernels run on cuda, not {device}")
    grads = [g.contiguous() for g in grads]
    _check(grads, device, "gradients")
    return grads, device, leaf_plan(tuple(g.numel() for g in grads))


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def adam_sumsq(grads: list) -> torch.Tensor:
    """-> [n_chunks, 2] float32 on the card: each chunk's sum of g^2 and 1
    where an entry of it is NaN or Inf, else 0 (`leaf_plan`'s chunks)."""
    grads, device, plan = _leaves(grads)
    partial = torch.empty((max(plan.n_chunks, 1), 2), dtype=torch.float32,
                          device=device)
    lib = build.load("adam")
    stream = _stream(device)
    for ln in plan.launches:
        ptrs = _pointers([grads[ln.lo:ln.hi]])
        n = np.array(plan.sizes[ln.lo:ln.hi], dtype=np.int64)
        rc = lib.sh_adam_sumsq(
            ptrs.ctypes.data, n.ctypes.data, ln.first.ctypes.data,
            ln.hi - ln.lo, _vec(ptrs), plan.chunk,
            partial.data_ptr() + 8 * ln.base, stream)
        build.check(lib, rc, "adam_sumsq kernel launch")
        adam_sumsq.launches += 1
    return partial


def adam_norm(partial: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """-> [2] float32: sqrt of the sum of partial[:n_chunks, 0] and 1.0
    where any of partial[:n_chunks, 1] is set, else 0.0."""
    out = torch.empty(2, dtype=torch.float32, device=partial.device)
    lib = build.load("adam")
    rc = lib.sh_adam_norm(partial.data_ptr(), n_chunks, out.data_ptr(),
                          _stream(partial.device))
    build.check(lib, rc, "adam_norm kernel launch")
    adam_norm.launches += 1
    return out


def grad_norm(grads: list) -> torch.Tensor:
    """-> [2] float32 on the card: the global norm of the leaves (the sqrt
    of the sum of every entry's square) and 1.0 where an entry is NaN or
    Inf, else 0.0; two launches, in a fixed order of sums."""
    partial = adam_sumsq(grads)
    return adam_norm(partial, leaf_plan(
        tuple(g.numel() for g in grads)).n_chunks)


def adam_update(grads: list, params: list, mu: list, nu: list,
                scalars: torch.Tensor, *, clip: float, wd: float, b1: float,
                b2: float, eps: float, norm=None, keep=None,
                out: bool = False):
    """One Adam step over the leaves.  scalars [3] float32 on the card:
    (-lr, 1 - b1^t, 1 - b2^t); clip and wd 0 are off; norm: float32 on
    the card, the gradients' global norm first (`grad_norm`'s result),
    read where the clip is on; keep:
    a 0-d bool on the card or None, in place only.  In place (out False)
    params, mu and nu take their new values, and where keep is False params
    get + 0 and the moments stay; -> None.  out True: -> (updates, new mu,
    new nu), fresh tensors, the arguments unchanged."""
    grads, device, plan = _leaves(grads)
    _check(params, device, "parameters")
    _check(list(mu) + list(nu), device, "moments")
    if scalars.device != device or scalars.dtype != torch.float32 \
            or scalars.numel() != 3 or not scalars.is_contiguous():
        raise ValueError("scalars: [3] float32 on the gradients' device")
    for t in (params, mu, nu):
        if tuple(x.numel() for x in t) != plan.sizes:
            raise ValueError("parameters, moments and gradients differ in "
                             "their leaves' sizes")
    clip_on = clip > 0
    if clip_on and (norm is None or norm.device != device
                    or norm.dtype != torch.float32):
        raise ValueError("the clip needs the norm, float32 on the card")
    if keep is not None and (out or keep.dtype != torch.bool
                             or keep.device != device):
        raise ValueError("keep: a bool on the card, in place only")
    if out:
        m_out = [torch.empty_like(m) for m in mu]
        v_out = [torch.empty_like(v) for v in nu]
        u_out = [torch.empty_like(p) for p in params]
    else:
        m_out, v_out, u_out = list(mu), list(nu), [None] * len(params)
    rows = (grads, params, mu, nu, m_out, v_out, u_out)
    lib = build.load("adam")
    stream = _stream(device)
    c = ctypes.c_float
    for ln in plan.launches:
        ptrs = _pointers([r[ln.lo:ln.hi] for r in rows])
        n = np.array(plan.sizes[ln.lo:ln.hi], dtype=np.int64)
        rc = lib.sh_adam_update(
            ptrs.ctypes.data, n.ctypes.data, ln.first.ctypes.data,
            ln.hi - ln.lo, _vec(ptrs), plan.chunk, scalars.data_ptr(),
            norm.data_ptr() if clip_on else None,
            None if keep is None else keep.data_ptr(),
            c(clip), c(wd), c(b1), c(1.0 - b1), c(b2), c(1.0 - b2), c(eps),
            int(clip_on), int(wd != 0), stream)
        build.check(lib, rc, "adam_update kernel launch")
        adam_update.launches += 1
    return (u_out, m_out, v_out) if out else None


adam_sumsq.launches = 0
adam_norm.launches = 0
adam_update.launches = 0
