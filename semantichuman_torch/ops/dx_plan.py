"""The dx kernel's plan of short rows (`csrc/spiral_conv_bwd.cu:dx_short_kernel`).

    dx[b, u, c] = sum_{j = v*S + s in row u of the inverse table}
                    sum_n dy'[b, v, n] * W[s*C + c, n]

A block of the short-row kernel owns a slice of CP input channels and keeps
that slice of W, every slot and every output channel, resident in shared
memory; its warps each stream a run of units, a unit being one short row
(at most `LONG_ROW` entries; the long ones take the long-row kernels) at
one batch tile of BT elements, and stage one entry's dy' rows at a time
for their tile.  The plan of one inverse table, built once on the host
(`dx_plan_of`: the tables build each level's with the tables,
`models/tables.py:device_tables`, before any graph is captured):

  rows   [R] int32: the short rows u, ascending
  roffs  [R + 1] int32: short row r's entries are ents[roffs[r]:roffs[r+1]]
  keys   [R + 1] int32: roffs[r] + r, unit r's start within a batch tile
         (each unit weighs its entries and one for its output rows)
  ents   [E] int32: (v << 8) | s of each entry, in the table's order

Units run batch-tile-major, and each warp takes the units that start in its
equal share of the n_bt x (E + R) positions, so a warp's entries are
contiguous and no warp waits for another.  `launch_plan` picks the warp
tile and the warps a block from what a call shows (B, C, Co, S) and the
card's SMs: one algorithm adapting by shape; it is Python's, so that the
router (`spiral_conv._unfused_halves`, which sends a dx whose weight slice
cannot fit, `warp_tile` None, unfused) and the tests read it where no
kernel is built, and the C side refuses a launch whose shared memory
cannot hold the slice and the rings.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from .csr_reduce import LONG_ROW

SMS_NO_CARD = 132     # an H100 SXM's SMs, for a plan read off the card
SMEM_ONE = 232448     # the most a block may take
NB = 16               # output channels a stage: a staged dy' row is 64 B
ALIGN = 1024          # the rings start at the next 1024 bytes (swizzle)
STAGES = 2            # stages of dy' rows in a warp's ring
MAX_WARPS = 8         # warps a block, at most (the kernel's launch bounds)
MIN_WARPS = 4         # warps a block, at least, where the slice fits
NTCS = (8, 4, 2, 1)   # lanes along c a warp tile: the kernel's instances


def ntc_for(c: int) -> int:
    """Lanes along c of the widest warp tile for C input channels: the
    tile is 8 x 8 a lane, wide in c for wide convs, else in b."""
    return 8 if c > 32 else 4 if c > 16 else 2 if c > 8 else 1


def tile_of(ntc: int) -> tuple:
    """(BT batch elements, CP input channels) of the warp tile: 8 x 8 a
    lane, ntc lanes along c and 32 / ntc along b."""
    return 8 * (32 // ntc), 8 * ntc


def w_stride(co: int) -> int:
    """Floats a row of the resident weight slice: Co rounded up to NB,
    plus four against bank conflicts."""
    return -(-co // NB) * NB + 4


def smem_bytes(s: int, co: int, ntc: int, warps: int) -> int:
    """The kernel's dynamic shared memory: the weight slice (S x CP rows
    as f32), up to ALIGN bytes to align the rings, each warp's ring of
    STAGES stages of BT 64-byte dy' rows, its slots (4 bytes a stage, the
    block's rounded up to 8) and its barriers (8 bytes a stage)."""
    stages = warps * STAGES
    return 4 * s * tile_of(ntc)[1] * w_stride(co) + ALIGN \
        + stages * tile_of(ntc)[0] * NB * 4 + -(-stages // 2) * 8 \
        + stages * 8


def max_warps(s: int, co: int, ntc: int) -> int:
    """The most warps a block whose rings fit beside the weight slice, at
    most MAX_WARPS."""
    return max([w for w in range(MAX_WARPS + 1)
                if smem_bytes(s, co, ntc, w) <= SMEM_ONE], default=0)


def warp_tile(c: int, co: int, s: int) -> int | None:
    """Lanes along c of the widest warp tile for W [s*c, co] whose weight
    slice leaves room for MIN_WARPS warps' rings in one block, or None
    where no tile's does (the dispatch sends such a dx unfused)."""
    return next((t for t in NTCS if t <= ntc_for(c)
                 and max_warps(s, co, t) >= MIN_WARPS), None)


_SMS: dict = {}


def sms_of(device) -> int:
    """SMs of the card `device`, read once a device; SMS_NO_CARD for
    another device (a plan the CPU tests read)."""
    device = torch.device(device)
    if device.type != "cuda":
        return SMS_NO_CARD
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def launch_plan(b: int, c: int, co: int, s: int, sms: int) -> dict | None:
    """The short-row launch for dy [b, *, co] and W [s*c, co] on a card of
    `sms` SMs: the warp tile of `warp_tile`, with as many warps as fit up
    to MAX_WARPS (the registers allow one such block an SM); one wave of
    blocks, ceil(c / CP) slices of them.  None for Co <= 4 (the narrow
    kernel takes those) and where no weight slice fits."""
    ntc = warp_tile(c, co, s) if co > 4 else None
    if ntc is None:
        return None
    nw = max_warps(s, co, ntc)
    bt, cp = tile_of(ntc)
    ncs = -(-c // cp)
    return {"ntc": ntc, "warps": nw, "bt": bt, "cp": cp,
            "n_bt": -(-b // bt), "slices": ncs,
            "blocks": max(1, sms // ncs),
            "smem": smem_bytes(s, co, ntc, nw)}


@dataclass(frozen=True)
class DxPlan:
    """The short rows of one inverse spiral table (the module's
    docstring), on the table's device, with the host copies that the
    tests read."""
    spiral_shape: tuple
    rows: torch.Tensor
    roffs: torch.Tensor
    keys: torch.Tensor
    ents: torch.Tensor
    host_rows: np.ndarray
    host_roffs: np.ndarray
    host_ents: np.ndarray
    # (B, C, Co) -> launch plan, filled on first use
    _launch: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_rows(self) -> int:
        return len(self.host_rows)

    @property
    def n_entries(self) -> int:
        return len(self.host_ents)

    @staticmethod
    def build(offs, cols, s: int, device) -> "DxPlan":
        """From an inverse spiral table (CSR offsets over V1 rows, columns
        v*S + s) of a [V1, S] spiral."""
        offs = np.asarray(offs, np.int64)
        cols = np.asarray(cols, np.int64)
        v1 = len(offs) - 1
        if v1 >= 2 ** 23 or s > 255:
            raise ValueError(f"V1 = {v1}, S = {s}: an entry packs v in 23 "
                             "bits and s in 8")
        deg = np.diff(offs)
        rows = np.nonzero(deg <= LONG_ROW)[0]
        lens = deg[rows]
        roffs = np.concatenate([[0], np.cumsum(lens)])
        pick = (np.repeat(offs[rows] - roffs[:-1], lens)
                + np.arange(roffs[-1])) if len(rows) else np.zeros(0, int)
        col = cols[pick]
        ents = ((col // s) << 8) | (col % s)

        def i32(a):
            return np.asarray(a, np.int64).astype(np.int32)

        host = (i32(rows), i32(roffs), i32(ents))
        return DxPlan(
            spiral_shape=(v1, s),
            rows=torch.as_tensor(host[0], device=device),
            roffs=torch.as_tensor(host[1], device=device),
            keys=torch.as_tensor(i32(roffs + np.arange(len(roffs))),
                                 device=device),
            ents=torch.as_tensor(host[2], device=device),
            host_rows=host[0], host_roffs=host[1], host_ents=host[2])

    def launch_plan(self, b: int, c: int, co: int) -> dict | None:
        key = (b, c, co)
        if key not in self._launch:
            self._launch[key] = launch_plan(b, c, co, self.spiral_shape[1],
                                            sms_of(self.rows.device))
        return self._launch[key]


# the plan of each inverse table: id(table) -> (weak reference, DxPlan)
_BUILT: dict = {}


def dx_plan_of(csr) -> DxPlan:
    """The short-row plan of an inverse spiral table (a CSRTable over V1
    rows of V1*S entries), on its device: built on first use (host work
    and a copy from the device, so not inside a captured graph: the
    tables build their levels' with the tables), then the same object for
    as long as the table lives."""
    key = id(csr)
    hit = _BUILT.get(key)
    if hit is not None and hit[0]() is csr:
        return hit[1]
    s = csr.n_src // max(csr.n_rows, 1)
    plan = DxPlan.build(csr.offs.cpu().numpy(), csr.cols.cpu().numpy(), s,
                        csr.offs.device)
    _BUILT[key] = (weakref.ref(csr, lambda _r: _BUILT.pop(key, None)), plan)
    return plan
