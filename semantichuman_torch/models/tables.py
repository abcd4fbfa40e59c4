"""Device-resident topology tables, derived once from a MeshHierarchy
(counterpart of `semantichuman_tpu/models/tables.py`), plus the inverse
spiral tables that the spiral conv's backward reduces over and the gather
tables of pool and unpool (`ops/row_gather.py:GatherTable`: the index, the
unpool weights and the inverse their backward reduces over).

With `banded=True` (ModelConfig.banded_conv, on by default as in the JAX
package) the fine spiral levels and the large unpool transitions also carry
a band (`ops/banded_gather.py:BandTable`), which the banded routes of
`spiral_conv` and `unpool` read.  The JAX package's pool bands are not
built: its own gate never routes to them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import banding
from ..ops.banded_gather import BandTable
from ..ops.csr_reduce import CSRTable, inverse_csr
from ..ops.row_gather import GatherTable
from ..utils.device import resolve_device

# conv bands only at the fine levels (V1 above the JAX one-hot form's upper
# bound, where the JAX package bands); unpool bands at transitions with at
# least this many fine rows.  Read at call time, so tests can lower them.
BAND_MIN_V1 = 2049
BAND_MIN_ROWS = 512


@dataclass(frozen=True)
class DeviceTables:
    spirals: tuple        # per level [V_l+1, S_l] int32, dummy-resolved
    pool_idx: tuple       # per transition [V_{l+1}+1] int64
    unpool_idx: tuple     # per transition [V_l+1, 3] int64
    unpool_w: tuple       # per transition [V_l+1, 3] float32
    sizes: tuple          # V_l
    spiral_sizes: tuple   # S_l
    spiral_csr: tuple     # per level CSRTable: inverse of spirals[l]
    pool_gather: tuple    # per transition GatherTable of pool_idx (T = 1)
    unpool_gather: tuple  # per transition GatherTable of unpool_idx/_w (T = 3)
    # per level / transition: a BandTable, or None -> the take route
    bands: tuple = ()
    unpool_bands: tuple = ()
    banded_conv: bool = False     # the flag the bands were built under

    @property
    def n_levels(self) -> int:
        return len(self.sizes)

    def band_for(self, level: int):
        return self.bands[level] if level < len(self.bands) else None

    def unpool_band_for(self, level: int):
        return (self.unpool_bands[level]
                if level < len(self.unpool_bands) else None)

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
    return inverse_csr(spiral, np.asarray(spiral).shape[0])


def _bands(hier, dev):
    """(conv bands per level, unpool bands per transition), as the JAX
    package's device_tables picks them."""
    sizes = [int(v) for v in hier.sizes]

    def band(table, presets, dummy, weights=None):
        spec = banding.pick_band_spec(np.asarray(table), presets=presets,
                                      dummy=dummy)
        return None if spec is None else BandTable.build(spec, dev, weights)

    bands = tuple(
        band(s, banding.BAND_PRESETS, None)
        if np.asarray(s).shape[0] >= BAND_MIN_V1 else None
        for s in hier.spirals)
    # the unpool source is the next-coarser level: its zero dummy row is
    # passed explicitly; the gate keys on the fine row count
    unpool_bands = tuple(
        band(u, banding.UNPOOL_BAND_PRESETS, sizes[l + 1],
             np.asarray(w, np.float32).reshape(-1))
        if np.asarray(u).shape[0] >= BAND_MIN_ROWS else None
        for l, (u, w) in enumerate(zip(hier.unpool_idx, hier.unpool_w)))
    return bands, unpool_bands


def device_tables(hier, device="cuda", banded: bool = False) -> DeviceTables:
    """`hier` is a MeshHierarchy; spirals stay int32 (the kernel's index
    type), sampling tables become int64 (torch.index_select's).  `banded`
    adds the band tables."""
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
    pool_gather = tuple(GatherTable.build(p, sizes[l] + 1, dev)
                        for l, p in enumerate(hier.pool_idx))
    unpool_gather = tuple(
        GatherTable.build(u, sizes[l + 1] + 1, dev, w=np.asarray(w))
        for l, (u, w) in enumerate(zip(hier.unpool_idx, hier.unpool_w)))
    bands, unpool_bands = _bands(hier, dev) if banded else ((), ())
    return DeviceTables(spirals=spirals, pool_idx=pool_idx,
                        unpool_idx=unpool_idx, unpool_w=unpool_w,
                        sizes=sizes,
                        spiral_sizes=tuple(int(s.shape[1])
                                           for s in hier.spirals),
                        spiral_csr=spiral_csr, pool_gather=pool_gather,
                        unpool_gather=unpool_gather, bands=bands,
                        unpool_bands=unpool_bands, banded_conv=banded)
