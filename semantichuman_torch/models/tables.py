"""Device-resident topology tables, derived once from a MeshHierarchy
(counterpart of `semantichuman_tpu/models/tables.py`, without the TPU-only
band specs), plus the inverse spiral tables that the spiral conv's
backward reduces over."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.csr_reduce import CSRTable
from ..utils.device import resolve_device


@dataclass(frozen=True)
class DeviceTables:
    spirals: tuple        # per level [V_l+1, S_l] int32, dummy-resolved
    pool_idx: tuple       # per transition [V_{l+1}+1] int64
    unpool_idx: tuple     # per transition [V_l+1, 3] int64
    unpool_w: tuple       # per transition [V_l+1, 3] float32
    sizes: tuple          # V_l
    spiral_sizes: tuple   # S_l
    spiral_csr: tuple     # per level CSRTable: inverse of spirals[l]

    @property
    def n_levels(self) -> int:
        return len(self.sizes)

    @property
    def device(self) -> torch.device:
        return self.spirals[0].device


def _checked(idx, n_rows: int, what: str) -> np.ndarray:
    """The spiral kernel and the gathers trust their index tables, so every
    index is range-checked once here, on the host."""
    idx = np.asarray(idx)
    if idx.size and (idx.min() < 0 or idx.max() >= n_rows):
        raise ValueError(f"{what}: indices outside [0, {n_rows})")
    return idx


def inverse_spiral_csr(spiral: np.ndarray):
    """The transpose of a spiral gather as CSR: row u lists every flat
    index v*S + s with spiral[v, s] == u, in ascending order (a stable
    sort).  Returns (offs [V1+1], cols [V1*S]) int64."""
    flat = np.asarray(spiral).reshape(-1)
    cols = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=spiral.shape[0])
    offs = np.concatenate([[0], np.cumsum(counts)])
    return offs, cols


def device_tables(hier, device="cuda") -> DeviceTables:
    """`hier` is a MeshHierarchy; spirals stay int32 (the kernel's index
    type), sampling tables become int64 (torch.index_select's)."""
    dev = resolve_device(device)
    sizes = tuple(int(v) for v in hier.sizes)
    spirals = tuple(
        torch.as_tensor(_checked(s, sizes[l] + 1, f"spirals[{l}]"),
                        dtype=torch.int32, device=dev).contiguous()
        for l, s in enumerate(hier.spirals))
    pool_idx = tuple(
        torch.as_tensor(_checked(p, sizes[l] + 1, f"pool_idx[{l}]"),
                        dtype=torch.int64, device=dev)
        for l, p in enumerate(hier.pool_idx))
    unpool_idx = tuple(
        torch.as_tensor(_checked(u, sizes[l + 1] + 1, f"unpool_idx[{l}]"),
                        dtype=torch.int64, device=dev)
        for l, u in enumerate(hier.unpool_idx))
    unpool_w = tuple(torch.as_tensor(np.asarray(w, np.float32), device=dev)
                     for w in hier.unpool_w)
    # hier.spirals passed the range check above
    spiral_csr = tuple(
        CSRTable.build(*inverse_spiral_csr(s), n_src=np.asarray(s).size,
                       device=dev)
        for s in hier.spirals)
    return DeviceTables(spirals=spirals, pool_idx=pool_idx,
                        unpool_idx=unpool_idx, unpool_w=unpool_w,
                        sizes=sizes,
                        spiral_sizes=tuple(int(s.shape[1])
                                           for s in hier.spirals),
                        spiral_csr=spiral_csr)
