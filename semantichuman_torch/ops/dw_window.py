"""The dW kernel's window plan (`csrc/spiral_conv_bwd.cu:dw_partial_kernel`).

    dW[s*C + c, n] = sum_{b, v} x[b, spiral[v, s], c] * dy'[b, v, n]

gathers S rows of x for every vertex, and neighbouring vertices name many
of the same rows.  A block of the kernel takes a tile of T consecutive
vertices of one batch element, copies the distinct x rows the tile's
spirals name into shared memory once (the tile's window), and reads every
spiral entry from there through a tile-local index.  The plan of one
spiral table holds, for each tile size T of `LADDER` whose indices fit in
int16:

  rows   [total] int32: each tile's distinct source rows in ascending
         order (the dummy row is an ordinary row), tile after tile
  offs   [n_tiles + 1] int32: tile t's rows are rows[offs[t]:offs[t+1]]
  masks  [total] int32: bit min(s, 31) set where slot s of some vertex of
         the tile names the row; a block whose k-tile holds slots
         s_lo..s_hi copies only the rows whose mask meets theirs
  lidx   [ceil(V1 / 16) * 16 + 128, SP] int16: entry (v, s)'s index in
         its tile's list; SP is S rounded up to 8 (16-byte rows), pads 0
         (a stage of up to 128 rows may run past the last vertex)

It is host work, done once a spiral tensor (`window_of`): the tables build
each level's when they are built (`models/tables.py:device_tables`), before
any graph is captured.  `launch_plan` picks T and the launch from
what a call shows (B, V1, S, C, Co, the dtype of x); it is Python's, so
that the counter and the tests read it where no kernel is built, and the
C side refuses a launch whose shared memory cannot hold the window and its
ring.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

LADDER = (16, 32, 64, 128, 256, 512, 1024)
LIDX_PAD = 128        # the longest stage, in vertices
SMS = 132             # H100 SXM
SMEM_SM = 233472      # shared memory of an SM
SMEM_ONE = 232448     # the most a block may take
# csrc/spiral_conv_bwd.cu:dw_dispatch: the kernel's tile shapes, id -> (BKT
# rows of K, BN columns of Co, TN columns a thread, RG row groups); a
# thread holds 8 rows of K
TILES = {0: (128, 128, 8, 1), 1: (256, 64, 8, 1), 2: (256, 32, 8, 2),
         3: (256, 16, 8, 2), 4: (256, 4, 4, 8), 5: (64, 16, 8, 8),
         6: (64, 4, 4, 16), 7: (192, 32, 8, 2), 8: (384, 32, 8, 1),
         9: (512, 16, 8, 2), 10: (512, 32, 8, 1)}


def tile_shape(k: int, co: int) -> int:
    """The tile id for K = S*C rows and Co columns: square tiles for wide
    outputs, one tile over the whole of K for narrow ones (Co <= 64) where
    it fits, so that a block copies each window row once for all its
    slots."""
    if co > 64:
        return 0
    if co > 32:
        return 1
    if co > 16:
        return 7 if k <= 192 else 2 if k <= 256 else 8 if k <= 384 else 10
    if k <= 64:
        return 5 if co > 4 else 6
    if co > 4:
        return 3 if k <= 256 else 9
    return 4


def threads(shape: int) -> int:
    bkt, bn, tn, rg = TILES[shape]
    return (bkt // 8) * (bn // tn) * rg


def min_blocks(shape: int) -> int:
    """Blocks an SM the kernel's registers are set for (`DwShape::MINB`):
    sixteen warps where the threads allow, at least two."""
    return max(2, 512 // threads(shape))


def budget(shape: int) -> int:
    """The shared memory a block may take so that `min_blocks` share an
    SM (each block keeps 1 KB besides)."""
    return SMEM_SM // min_blocks(shape) - 1024


def stage_rows(shape: int) -> int:
    """Vertices a stage (`DwShape::BR`): 16 rows for each thread between
    two barriers, 8 where more than two row groups share a stage."""
    rg = TILES[shape][3]
    return 8 * rg if rg > 2 else 16 * rg


def s_pad(s: int) -> int:
    return -(-s // 8) * 8


@dataclass(frozen=True)
class WindowPlan:
    """The plan of one spiral table at one tile size (the module's
    docstring); the host copies are what the launch plan and the counter
    read."""
    t: int
    rows: torch.Tensor
    offs: torch.Tensor
    masks: torch.Tensor
    lidx: torch.Tensor
    max_rows: int
    host_offs: np.ndarray
    host_masks: np.ndarray


def _plan(spiral: np.ndarray, t: int, device) -> WindowPlan | None:
    v1, s = spiral.shape
    tile = np.repeat(np.arange(v1, dtype=np.int64) // t, s)
    key = tile * v1 + spiral.reshape(-1)
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    n_tiles = -(-v1 // t)
    offs = np.searchsorted(uniq // v1, np.arange(n_tiles + 1))
    local = inv - offs[tile]
    counts = np.diff(offs)
    if counts.max() > np.iinfo(np.int16).max:
        return None
    bits = np.left_shift(1, np.minimum(np.tile(np.arange(s), v1), 31))
    masks = np.zeros(len(uniq), np.int64)
    np.bitwise_or.at(masks, inv, bits)
    lidx = np.zeros((-(-v1 // 16) * 16 + LIDX_PAD, s_pad(s)), np.int16)
    lidx[:v1, :s] = local.reshape(v1, s)
    masks32 = masks.astype(np.uint32).view(np.int32)
    return WindowPlan(
        t=t,
        rows=torch.as_tensor((uniq % v1).astype(np.int32), device=device),
        offs=torch.as_tensor(offs.astype(np.int32), device=device),
        masks=torch.as_tensor(masks32, device=device),
        lidx=torch.as_tensor(lidx, device=device),
        max_rows=int(counts.max()), host_offs=offs, host_masks=masks32)


@dataclass(frozen=True)
class DwWindow:
    """The window plans of one spiral table [V1, S], one per tile size."""
    spiral_shape: tuple
    plans: dict
    # (B, C, Co, es) -> launch plan, filled on first use
    _launch: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def build(spiral, device=None) -> "DwWindow":
        """From a spiral table (numpy or a tensor, range-checked by the
        caller), onto `device` (the tensor's own by default)."""
        if isinstance(spiral, torch.Tensor):
            device = spiral.device if device is None else device
            spiral = spiral.cpu().numpy()
        spiral = np.asarray(spiral, np.int64)
        plans = {}
        for t in LADDER:
            p = _plan(spiral, t, device)
            if p is not None:
                plans[t] = p
            if t >= spiral.shape[0]:
                break
        return DwWindow(spiral_shape=tuple(spiral.shape), plans=plans)

    def launch_plan(self, b: int, c: int, co: int,
                    dtype: torch.dtype) -> dict | None:
        es = 2 if dtype == torch.bfloat16 else 4
        key = (b, c, co, es)
        if key not in self._launch:
            self._launch[key] = launch_plan(b, c, co, es, self)
        return self._launch[key]


def stages(bn: int) -> int:
    """Stages of dy' rows and local indices in the kernel's ring: narrow
    tiles do little work a stage, so they keep more loads in flight."""
    return 2 if bn >= 64 else 3


def smem_bytes(max_rows: int, c: int, s: int, shape: int, es: int) -> int:
    """The kernel's dynamic shared memory: the window (rows C wide in x's
    type), then the ring of dy' rows and of local indices; the row groups'
    sums reuse it at the end."""
    bkt, bn, _tn, rg = TILES[shape]
    win = -(-max_rows * c * es // 16) * 16
    total = win + stages(bn) * stage_rows(shape) * (bn * 4 + s_pad(s) * 2)
    return max(total, bkt * bn * 4) if rg > 1 else total


def slot_range(k_tile: int, bkt: int, k: int, c: int) -> tuple:
    """The spiral slots (first, last) that k-tile `k_tile` reads."""
    return (k_tile * bkt) // c, (min(k, (k_tile + 1) * bkt) - 1) // c


def range_mask(lo: int, hi: int) -> int:
    m = 0
    for s in range(lo, hi + 1):
        m |= 1 << min(s, 31)
    return m


def launch_plan(b: int, c: int, co: int, es: int,
                window: DwWindow) -> dict | None:
    """T and the launch for one call: the largest T whose window fits the
    blocks an SM the kernel is set for (else one) and whose (batch
    element, tile) items, times the k- and n-tiles, still give four blocks
    an SM; else the smallest T that fits (None: not even 16 vertices fit).
    Items run batch-major (item = b * n_tiles + tile) and are cut into
    equal runs, one a block ("chunks"), about four blocks an SM.  Also the
    rows the kernel copies and the entries it reads, per call."""
    v1, s = window.spiral_shape
    k = s * c
    shape = tile_shape(k, co)
    bkt, bn, _tn, _rg = TILES[shape]
    kt, nt = -(-k // bkt), -(-co // bn)

    def smem(t):
        return smem_bytes(window.plans[t].max_rows, c, s, shape, es)

    fits = [t for t in window.plans if smem(t) <= budget(shape)] or \
        [t for t in window.plans if smem(t) <= SMEM_ONE]
    if not fits:
        return None
    full = [t for t in fits if -(-v1 // t) * b * kt * nt >= 4 * SMS]
    t = max(full) if full else min(fits)
    n_vt = -(-v1 // t)
    items = n_vt * b
    want = min(items, -(-4 * SMS // (kt * nt)))
    per = -(-items // want)
    plan = window.plans[t]
    rows = entries = 0
    for ky in range(kt):
        lo, hi = slot_range(ky, bkt, k, c)
        hit = (plan.host_masks.astype(np.int64) & range_mask(lo, hi)) != 0
        rows += int(hit.sum())
        entries += v1 * (hi - lo + 1)
    return {"t": t, "shape": shape, "bkt": bkt, "bn": bn, "kt": kt,
            "nt": nt, "smem": smem(t), "n_vt": n_vt, "items": items,
            "per_chunk": per,
            "chunks": -(-items // per), "rows": rows * b * nt,
            "entries": entries * b * nt}


# the plan of each spiral tensor: id(tensor) -> (weak reference, DwWindow)
_BUILT: dict = {}


def window_of(spiral: torch.Tensor) -> DwWindow:
    """The window plan of a spiral tensor, on its device: built on first
    use (host work and a copy from the device, so not inside a captured
    graph: the tables build their levels' with the tables), then the same
    object for as long as the tensor lives; another tensor gets its own,
    whatever its shape."""
    key = id(spiral)
    hit = _BUILT.get(key)
    if hit is not None and hit[0]() is spiral:
        return hit[1]
    win = DwWindow.build(spiral)
    _BUILT[key] = (weakref.ref(spiral, lambda _r: _BUILT.pop(key, None)),
                   win)
    return win


def walk_plain(x: torch.Tensor, dy: torch.Tensor, window: DwWindow,
               plan: dict) -> torch.Tensor:
    """dW as the kernel walks the plan, in plain PyTorch: per chunk its
    items in order, per k-tile the window holding only the rows that
    k-tile copies (the others NaN, so that a read of one shows), every
    entry read from it through the local index; the chunks' partial sums
    added in chunk order.  x [B, V1, C], dy [B, V1, Co] -> [S*C, Co]."""
    bsz, v1, c = x.shape
    s = window.spiral_shape[1]
    k = s * c
    p = window.plans[plan["t"]]
    offs, rows = p.host_offs, p.rows.cpu().long()
    masks = torch.from_numpy(p.host_masks.astype(np.int64))
    lidx = p.lidx.cpu().long()[:v1, :s]
    xf = x.float()
    total = torch.zeros((k, dy.shape[2]), dtype=torch.float32)
    for ch in range(plan["chunks"]):
        part = torch.zeros_like(total)
        for w in range(ch * plan["per_chunk"],
                       min(plan["items"], (ch + 1) * plan["per_chunk"])):
            b, vt = divmod(w, plan["n_vt"])
            v0, v_end = vt * p.t, min(v1, (vt + 1) * p.t)
            lst = rows[offs[vt]:offs[vt + 1]]
            for ky in range(plan["kt"]):
                lo, hi = slot_range(ky, plan["bkt"], k, c)
                k0, k1 = ky * plan["bkt"], min(k, (ky + 1) * plan["bkt"])
                hit = (masks[offs[vt]:offs[vt + 1]] & range_mask(lo, hi)) != 0
                win = torch.full((len(lst), c), float("nan"))
                win[hit] = xf[b, lst[hit]]
                g = win[lidx[v0:v_end]].reshape(v_end - v0, k)[:, k0:k1]
                part[k0:k1] += g.t() @ dy[b, v0:v_end]
        total += part
    return total
