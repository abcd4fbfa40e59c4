"""Weighted intra-part distance sums (counterpart of
`semantichuman_tpu/ops/pallas/part_dist_pallas.py`).

For each (part, batch element) tile the masked sum of
|w (de_r / de) - w| (or |w de_r - w de| without `relat`) over the part's
ordered vertex pairs, and the number of pairs in the mask; the weights w
come from the angle between each GT pair and the part's bone.  The exact
formulas are in the kernel's note, `csrc/part_dist.cu`, and in
`part_dist_plain`, which computes them with batched tensors.

`part_dist_sums` is an autograd Function around the three modes of one
kernel (`csrc/part_dist.cu`), which share one tile computation:
  * "fwd"       sums only (no gradient needed);
  * "fwd_grad"  sums and the unscaled gradient g0 = d(term sum)/d(rp): the
                one-pass VJP, the default, whose backward is g0 * ct;
  * "bwd"       drp for a cotangent ct, recomputing the tile (the
                two-kernel VJP, `one_pass=False`).
A CUDA tensor launches the kernel (counted in `part_dist_sums.launches`
per mode); a CPU tensor runs `part_dist_plain`.  Gradients flow to rp
only: GT vertices, bones and edit factors are data.  In threshold mode the
kernel skips acos past a guard band (`_acos_skip_cos`).  The plain
version is the kernel's reference.  `asymmetric_pairs` counts the pairs
whose two Gram orders round otherwise: the share that decided against
evaluating each unordered pair once (the kernel's note).

`fused_part_sums` groups parts into equal-n_pad buckets (`PartDistTables`)
and makes one call per bucket.  A tile never holds an n x n matrix, so any
part size takes the kernel up to the shared-memory limit `MAX_N`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import LEAF_PART_INDICES
from .kernels import build
from .row_gather import GatherTable, gather_rows

W_MODES = {"all_one": 0, "linear": 1, "sin": 2, "threshold": 3}
_MODES = {"fwd": 0, "fwd_grad": 1, "bwd": 2}
# both kernels stage 9 floats per vertex; 227 KB of shared memory a block
MAX_N = (232448 - 1024) // 36
# blocks of a call from which the kernel runs 4 warps a block, not 8: 16
# per SM of an H100 SXM (132)
_ROWS_WARPS_4_BLOCKS = 16 * 132
# the threshold's guard band: relative margin on the cut angle
_ACOS_BAND = 1e-4
# tiles per chunk of the plain version: ~10 [chunk, n, n] float32 buffers
_PLAIN_CHUNK_ELEMS = 1 << 24


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis (broadcasting), in the
    kernel's order of operations."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _gram_sums(x: torch.Tensor) -> torch.Tensor:
    """[g, n, 3] -> [g, n, n] Gram sums (r_j - 2<x_j, x_k>) + r_k, before
    the relu, rounded as the CUDA kernel rounds them (no matmul, no FMA).
    Entry [j, k] and [k, j] differ in the last bit for a few pairs."""
    r = _dot3(x, x)
    inner = _dot3(x[:, :, None, :], x[:, None, :, :])
    return r[:, :, None] - 2.0 * inner + r[:, None, :]


def _pair_dist(x: torch.Tensor) -> torch.Tensor:
    """[g, n, 3] -> [g, n, n] squared distances, the Gram form
    relu(r_j - 2<x_j, x_k> + r_k) of the Pallas kernel's _pair_dists,
    rounded as the CUDA kernel rounds it, so that both versions put every
    pair on the same side of the threshold and of q = 0."""
    return torch.relu(_gram_sums(x))


def _weights(vp, bone, n_real, allone, w_mode: str,
             w_threshold: float) -> tuple:
    """(w, de0) of a chunk of tiles: vp [g, n, 3], bone [g, 3], n_real and
    allone [g] -> the weights [g, n, n] (0 on the diagonal and on padding)
    and the GT pair distances [g, n, n]."""
    g, n, _ = vp.shape
    de0 = torch.sqrt(_pair_dist(vp))
    if w_mode == "all_one":
        w = torch.ones_like(de0)
    else:
        s = _dot3(vp, bone[:, None, :])
        dot = s[:, :, None] - s[:, None, :]
        bn = torch.sqrt(_dot3(bone, bone))[:, None, None]
        denom = de0 * bn
        pos = denom > 0.0
        cos = torch.where(pos, dot.abs() / torch.where(pos, denom, 1.0), 1.0)
        cos = torch.clamp(cos, 0.0, 1.0)
        if w_mode == "sin":
            w = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
        elif w_mode in ("linear", "threshold"):
            w = torch.acos(cos) * (2.0 / math.pi)
            if w_mode == "threshold":
                w = torch.where(w < w_threshold, 0.0, w)
        else:
            raise ValueError(f"unknown w_mode {w_mode!r}")
        w = torch.where(allone[:, None, None] > 0, 1.0, w)
    idx = torch.arange(n, device=vp.device)
    real = idx[None, :] < n_real[:, None]
    valid = (idx[:, None] != idx[None, :])[None] & real[:, :, None] \
        & real[:, None, :]
    return torch.where(valid, w, 0.0), de0


def _expand(a, n_real, allone, g: int):
    """Per-tile a [G] and per-part n_real/allone [P] expanded to [G]."""
    batch = g // n_real.shape[0]
    return (a.reshape(-1).float(), n_real.repeat_interleave(batch),
            allone.repeat_interleave(batch))


def _chunks(g: int, n: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n * n, 1))
    return [(i, min(i + step, g)) for i in range(0, g, step)]


def part_dist_plain(vp, rp, bone, a, n_real, allone, w_mode: str,
                    w_threshold: float, relat: bool, mode: str = "fwd",
                    ct=None):
    """The plain PyTorch version of the three kernels, tile math as in the
    Pallas kernels with batched tensors, chunked over tiles.

    vp, rp [G, n_pad, 3] float32, bone [G, 3], a [P, B] (or [G]), n_real
    and allone [P] int.  mode "fwd" -> sums [G, 2]; "fwd_grad" -> (sums,
    g0 [G, n_pad, 3]); "bwd" (with ct [G]) -> drp [G, n_pad, 3].  Not for
    autograd: `part_dist_sums_plain` is the differentiable form."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    g_all, n, _ = vp.shape
    a_e, n_real_e, allone_e = _expand(a, n_real, allone, g_all)
    sums = vp.new_zeros((g_all, 2))
    grad = vp.new_zeros((g_all, n, 3)) if mode != "fwd" else None
    for lo, hi in _chunks(g_all, n):
        w, de0 = _weights(vp[lo:hi], bone[lo:hi], n_real_e[lo:hi],
                          allone_e[lo:hi], w_mode, w_threshold)
        de = de0 * a_e[lo:hi, None, None]
        mask = (w * de) != 0.0
        r = rp[lo:hi]
        de_r = torch.sqrt(_pair_dist(r))
        if relat:
            de_safe = torch.where(mask, de, 1.0)
            q = w * (de_r / de_safe) - w
            gm = (w / de_safe) * torch.sign(q)
        else:
            q = w * de_r - w * de
            gm = w * torch.sign(q)
        sums[lo:hi, 0] = torch.where(mask, q.abs(), 0.0).sum(dim=(1, 2))
        sums[lo:hi, 1] = mask.float().sum(dim=(1, 2))
        if mode == "fwd":
            continue
        if mode == "bwd":
            gm = gm * ct[lo:hi, None, None]
        gm = torch.where(mask, gm, 0.0)
        pos = de_r > 0.0
        coef = torch.where(pos, gm / torch.where(pos, de_r, 1.0), 0.0)
        rowsum = coef.sum(dim=2, keepdim=True)
        grad[lo:hi] = 2.0 * (r * rowsum - torch.matmul(coef, r))
    return {"fwd": sums, "fwd_grad": (sums, grad), "bwd": grad}[mode]


def part_dist_sums_plain(vp, rp, bone, a, n_real, allone, w_mode: str,
                         w_threshold: float, relat: bool) -> torch.Tensor:
    """The sums of `part_dist_plain`, written so that autograd gives rp its
    gradient: the reconstruction's pair distances take the double-where
    (0 gradient outside the mask and where de_r = 0, PARITY #19).  The
    plain route of the training step uses it."""
    g_all, n, _ = vp.shape
    a_e, n_real_e, allone_e = _expand(a, n_real, allone, g_all)
    out = []
    for lo, hi in _chunks(g_all, n):
        with torch.no_grad():
            w, de0 = _weights(vp[lo:hi], bone[lo:hi], n_real_e[lo:hi],
                              allone_e[lo:hi], w_mode, w_threshold)
            de = de0 * a_e[lo:hi, None, None]
            mask = (w * de) != 0.0
        d2 = _pair_dist(rp[lo:hi])
        live = mask & (d2 > 0.0)
        de_r = torch.where(live, torch.sqrt(torch.where(live, d2, 1.0)), 0.0)
        if relat:
            de_safe = torch.where(mask, de, 1.0)
            term = (w * (de_r / de_safe) - w).abs()
        else:
            term = (w * de_r - w * de).abs()
        term = torch.where(mask, term, 0.0)
        out.append(torch.stack([term.sum(dim=(1, 2)),
                                mask.float().sum(dim=(1, 2))], dim=1))
    return torch.cat(out, dim=0)


def _check(vp, rp, bone, a, n_real, allone, w_mode, ct) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if w_mode not in W_MODES:
        raise ValueError(f"unknown w_mode {w_mode!r}")
    g, n_pad, three = vp.shape
    if three != 3 or rp.shape != vp.shape or bone.shape != (g, 3) \
            or a.numel() != g or n_real.dim() != 1 or not n_real.numel() \
            or allone.shape != n_real.shape or g % n_real.shape[0]:
        raise ValueError(
            f"part_dist expects vp, rp [G, n_pad, 3], bone [G, 3], a with G "
            f"elements, n_real and allone [P] with P | G; got vp "
            f"{tuple(vp.shape)}, rp {tuple(rp.shape)}, bone "
            f"{tuple(bone.shape)}, a {tuple(a.shape)}, n_real "
            f"{tuple(n_real.shape)}, allone {tuple(allone.shape)}")
    floats = [("vp", vp), ("rp", rp), ("bone", bone), ("a", a)]
    if ct is not None:
        if ct.shape != (g,):
            raise ValueError(f"ct must be [{g}], got {tuple(ct.shape)}")
        floats.append(("ct", ct))
    for name, t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != vp.device:
            raise ValueError(f"{name} must be contiguous float32 on "
                             f"{vp.device}")
    for name, t in (("n_real", n_real), ("allone", allone)):
        if t.dtype != torch.int32 or t.device != vp.device:
            raise ValueError(f"{name} must be int32 on {vp.device}")
    if g > 65535:
        raise ValueError(f"{g} tiles exceed the kernel's grid limit 65535")


def _acos_skip_cos(w_threshold: float) -> float:
    """The cosine above which threshold mode zeroes a weight without acos:
    cos((pi/2) t (1 - _ACOS_BAND)) in double, rounded up to float32.  Any
    c above it has acos(c) 2/pi below t by far more than acosf's 2 ulp and
    the product's two roundings (the kernel's note), so the kernel and the
    plain version agree that its weight is 0.  2 (never) where no weight
    can fall below t; -1 (always) where every weight does."""
    t = float(w_threshold)
    if not t > 0.0:                    # t <= 0 or NaN: w < t never holds
        return 2.0
    angle = 0.5 * math.pi * t * (1.0 - _ACOS_BAND)
    if angle >= 0.5 * math.pi:         # w <= 1 (1 + 4.2e-7) < t everywhere
        return -1.0
    c = np.float32(math.cos(angle))
    if float(c) < math.cos(angle):
        c = np.nextafter(c, np.float32(2.0))
    return float(c)


def asymmetric_pairs(vp, rp, bone, a, n_real, allone, w_mode: str,
                     w_threshold: float) -> torch.Tensor:
    """Per tile, the unordered pairs whose two orders round otherwise: the
    Gram sums of vp differ, or the pair is in the mask and those of rp
    differ.  [G] float32.  One evaluation cannot serve both orders of such
    a pair; chip_smoke.py reports their share."""
    g_all, n, _ = vp.shape
    a_e, n_real_e, allone_e = _expand(a, n_real, allone, g_all)
    out = vp.new_zeros(g_all)
    idx = torch.arange(n, device=vp.device)
    upper = idx[:, None] < idx[None, :]
    for lo, hi in _chunks(g_all, n):
        w, de0 = _weights(vp[lo:hi], bone[lo:hi], n_real_e[lo:hi],
                          allone_e[lo:hi], w_mode, w_threshold)
        mask = (w * (de0 * a_e[lo:hi, None, None])) != 0.0
        sv, sr = _gram_sums(vp[lo:hi]), _gram_sums(rp[lo:hi])
        apart = (sv != sv.transpose(1, 2)) \
            | (mask & (sr != sr.transpose(1, 2)))
        real = idx[None, :] < n_real_e[lo:hi, None]
        live = upper[None] & real[:, :, None] & real[:, None, :]
        out[lo:hi] = (apart & live).sum(dim=(1, 2)).float()
    return out


def _rows_warps(g: int, n_pad: int) -> int:
    """Warps a block of the kernel (32 rows a block): 4 where the grid has
    blocks enough to refill the card many times (the step's 17 x 128
    tiles: more, smaller blocks share the SMs better), else 8 (the
    Trainer's 17 x 4: fewer blocks, each finished sooner)."""
    return 4 if g * -(-n_pad // 32) >= _ROWS_WARPS_4_BLOCKS else 8


def _launch(mode: str, vp, rp, bone, a, n_real, allone, w_mode: str,
            w_threshold: float, relat: bool, ct=None):
    """One call of the kernel `csrc/part_dist.cu`, counted in
    `part_dist_sums.launches[mode]`; arguments and results as
    part_dist_plain's."""
    if (ct is None) != (mode != "bwd"):
        raise ValueError("mode 'bwd' and only it takes the cotangent ct")
    _check(vp, rp, bone, a, n_real, allone, w_mode, ct)
    g, n_pad, _ = vp.shape
    if n_pad > MAX_N:
        raise ValueError(f"tiles of {n_pad} rows exceed the kernel's "
                         f"shared-memory tile ({MAX_N})")
    dev = vp.device
    partial = torch.empty((g, -(-n_pad // 32), 2), dtype=torch.float32,
                          device=dev)
    sums = torch.empty((g, 2), dtype=torch.float32, device=dev)
    grad = (torch.empty((g, n_pad, 3), dtype=torch.float32, device=dev)
            if mode != "fwd" else sums)
    result = {"fwd": sums, "fwd_grad": (sums, grad), "bwd": grad}[mode]
    if ct is None:
        ct = sums                          # not read outside mode "bwd"
    if partial.numel() == 0:               # no tiles or no rows: no pairs
        sums.zero_()
        grad.zero_()
        return result
    lib = build.load("part_dist")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_part_dist(
            vp.data_ptr(), rp.data_ptr(), bone.data_ptr(), a.data_ptr(),
            n_real.data_ptr(), allone.data_ptr(), ct.data_ptr(),
            partial.data_ptr(), sums.data_ptr(), grad.data_ptr(), g,
            g // n_real.shape[0], n_pad, W_MODES[w_mode],
            float(w_threshold), _acos_skip_cos(w_threshold), int(relat),
            _MODES[mode], _rows_warps(g, n_pad), stream)
    build.check(lib, rc, f"part_dist {mode} kernel launch")
    part_dist_sums.launches[mode] += 1
    return result


def part_dist_call(mode: str, *args, ct=None):
    """One call of the kernel of `mode` ("fwd", "fwd_grad", "bwd") for a
    CUDA tensor, of its plain version for a CPU one; the arguments and
    results are part_dist_plain's."""
    vp = args[0]
    if vp.device.type == "cpu":
        return part_dist_plain(*args, mode=mode, ct=ct)
    if vp.device.type != "cuda":
        raise ValueError(f"part_dist runs on cpu or cuda, not {vp.device}")
    return _launch(mode, *args, ct=ct)


class PartDistFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rp, vp, bone, a, n_real, allone, w_mode, w_threshold,
                relat, one_pass):
        args = (vp, rp, bone, a, n_real, allone, w_mode, w_threshold, relat)
        ctx.one_pass = one_pass
        if not ctx.needs_input_grad[0]:
            return part_dist_call("fwd", *args)
        if one_pass:
            sums, g0 = part_dist_call("fwd_grad", *args)
            ctx.save_for_backward(g0)
            return sums
        ctx.save_for_backward(vp, rp, bone, a, n_real, allone)
        ctx.consts = (w_mode, w_threshold, relat)
        return part_dist_call("fwd", *args)

    @staticmethod
    def backward(ctx, ct):
        ct_sum = ct[:, 0].contiguous()   # the count output has no gradient
        if ctx.one_pass:
            (g0,) = ctx.saved_tensors
            drp = g0 * ct_sum[:, None, None]
        else:
            vp, rp, bone, a, n_real, allone = ctx.saved_tensors
            drp = part_dist_call("bwd", vp, rp, bone, a, n_real, allone,
                                 *ctx.consts, ct=ct_sum)
        return (drp,) + (None,) * 9


def part_dist_sums(vp, rp, bone, a, n_real, allone, w_mode: str,
                   w_threshold: float, relat: bool,
                   one_pass: bool = True) -> torch.Tensor:
    """Per-tile (Σ masked term, Σ mask) [G, 2].  vp, rp [G, n_pad, 3]
    float32 with tile g = part * B + b (rows past a part's n_real are
    ignored), bone [G, 3], a [P, B], n_real and allone [P] int32.
    Gradients flow to rp only."""
    return PartDistFn.apply(rp, vp, bone, a, n_real, allone, w_mode,
                            w_threshold, relat, one_pass)


part_dist_sums.launches = {mode: 0 for mode in _MODES}


class PartDistTables:
    """Parts grouped into equal-n_pad buckets (one call per bucket), so
    ragged part sizes do not pay the largest part's padding."""

    def __init__(self, part_indices, leafkeep: bool, w_mode: str, device):
        sizes = [len(ix) for ix in part_indices]
        self.n_parts = len(part_indices)
        self.sizes = sizes
        allone = np.zeros(self.n_parts, np.int32)
        if w_mode == "all_one":
            allone[:] = 1
        elif leafkeep:
            allone[list(LEAF_PART_INDICES)] = 1
        # the gathers index vertex rows up to the largest part index; rows
        # past it get no gradient
        n_src = 1 + max((int(np.max(ix)) for ix in part_indices if len(ix)),
                        default=0)
        by_pad: dict = {}
        for k, n in enumerate(sizes):
            by_pad.setdefault(_round_up(max(n, 8), 8), []).append(k)
        self.buckets = []
        self.part_ids = []             # part ids in output order
        for n_pad in sorted(by_pad):
            ids = by_pad[n_pad]
            idx = np.zeros((len(ids), n_pad), np.int64)
            for row, k in enumerate(ids):
                idx[row, :sizes[k]] = np.asarray(part_indices[k])
            self.buckets.append({
                "n_pad": n_pad,
                "part_ids": torch.as_tensor(ids, device=device),
                # pads gather vertex 0; the kernels ignore rows past n_real
                "gather": GatherTable.build(idx.reshape(-1), n_src, device),
                "n_real": torch.as_tensor([sizes[k] for k in ids],
                                          dtype=torch.int32, device=device),
                "allone": torch.as_tensor(allone[ids], device=device),
            })
            self.part_ids.extend(ids)


def _stack_parts(verts, gather: GatherTable, n_parts: int, n_pad: int):
    """[B, V, 3] -> [P*B, n_pad, 3] float32, tile p*B + b; `gather` is a
    bucket's table (`PartDistTables`)."""
    b = verts.shape[0]
    g = gather_rows(verts, gather).reshape(b, n_parts, n_pad, 3)
    return g.transpose(0, 1).reshape(n_parts * b, n_pad, 3).float() \
        .contiguous()


def fused_part_sums(tx_nodummy, rec_nodummy, bones, tables: PartDistTables,
                    a_full=None, w_mode: str = "threshold",
                    w_threshold: float = 0.8, relat: bool = True,
                    sums_fn=part_dist_sums):
    """(term_sums, counts), each [n_parts] in `tables.part_ids` order.
    bones [B, P, 3] per-part orientation vectors, a_full [B, P] or None.
    `sums_fn` is part_dist_sums, or part_dist_sums_plain for the plain
    route."""
    b = tx_nodummy.shape[0]
    outs = []
    for bk in tables.buckets:
        ids = bk["part_ids"]
        pc = ids.shape[0]
        n_pad = bk["n_pad"]
        vp = _stack_parts(tx_nodummy, bk["gather"], pc, n_pad)
        rp = _stack_parts(rec_nodummy, bk["gather"], pc, n_pad)
        bone = bones.index_select(1, ids).transpose(0, 1) \
            .reshape(pc * b, 3).float().contiguous()
        if a_full is None:
            a = torch.ones((pc, b), dtype=torch.float32,
                           device=tx_nodummy.device)
        else:
            a = a_full.index_select(1, ids).t().float().contiguous()
        sums = sums_fn(vp, rp, bone, a, bk["n_real"], bk["allone"], w_mode,
                       w_threshold, relat)               # [pc*B, 2]
        outs.append(sums.reshape(pc, b, 2).sum(dim=1))
    sums = torch.cat(outs, dim=0)
    return sums[:, 0], sums[:, 1]
