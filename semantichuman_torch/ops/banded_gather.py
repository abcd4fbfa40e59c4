"""Block-diagonal banded gather (counterpart of the TPU kernels
`semantichuman_tpu/ops/pallas/banded_gather_pallas.py`, the custom-VJP
pair `_fwd_call` / `_bwd_call` behind `diag_banded_gather`).

From a `DiagBandSpec` (`ops/banding.py`) and an optional weight per flat
output row:

    forward   g[p, m]  = w[p] * xp[base[p // (R*S)]*R + rel[p] - K*R, m]
                         (0 where rel[p] = -1: the entry is out of band)
    backward  dx[u, m] = sum over in-band p with source u of w[p] * ct[p, m]

xp is the packed [n_src, B*C] source (vertex-major), g the flat
[N*S, B*C] gather before the out-of-band fix-up, which the banded routes
put in place through `ops/row_gather.py`.  `banded_gather_fwd` / `_bwd`
launch the hand-written kernels (`csrc/banded_gather.cu`) for CUDA tensors
and count them in `.launches`; for CPU tensors they run the plain
versions.
`BandedGatherFn` ties the two into an autograd Function; the weights get
no gradient, as in `diag_banded_gather`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .banding import BandSpec
from .csr_reduce import LONG_ROW, CSRTable, inverse_csr
from .kernels import build
from .row_gather import GatherTable, copy_unit


@dataclass(frozen=True)
class BandTable:
    """One banded table on the device: the DiagBandSpec arrays the kernels
    read, the backward's CSR table (each source row's in-band output rows
    in ascending order, weights in the same order), and the out-of-band
    fix-up lists.  Built once per table, on the host."""
    spec: BandSpec
    base: torch.Tensor            # [nblk] int32
    rel: torch.Tensor             # [nblk*R*S] int32, -1 out of band
    w: torch.Tensor | None        # [n_rows] float32, or None (unweighted)
    bwd: CSRTable                 # n_src rows over the n_rows output rows
    bwd_w: torch.Tensor | None    # [nnz] float32 in CSR order, or None
    fix: GatherTable | None       # fix_src and its inverse (None: no fix-ups)
    fix_pos: torch.Tensor | None  # [n_fix] int64 flat output rows, unique
    fix_w: torch.Tensor | None    # [n_fix] float32 (weighted tables)

    @property
    def diag(self):
        return self.spec.diag

    @property
    def n_rows(self) -> int:
        return self.diag.n_rows

    @property
    def n_src(self) -> int:
        return self.diag.n_src

    @property
    def weighted(self) -> bool:
        return self.w is not None

    @staticmethod
    def build(spec: BandSpec, device, weights=None) -> "BandTable":
        """`weights` (None, or one float32 per flat output row p = v*S + s)
        fold into the gather, as unpool's barycentric taps do."""
        d = spec.diag
        rs = d.R * d.S
        rel = np.asarray(d.rel, np.int64).reshape(-1)
        p = np.arange(d.n_rows)
        src = (np.asarray(d.base, np.int64)[p // rs] * d.R + rel[:d.n_rows]
               - d.K * d.R)
        inband = rel[:d.n_rows] >= 0
        if np.any(inband & ((src < 0) | (src >= d.n_src))):
            raise ValueError("band spec: an in-band entry's source row lies "
                             f"outside [0, {d.n_src})")
        src_in = np.where(inband, src, -1)
        offs, order = inverse_csr(src_in[inband], d.n_src)
        cols = p[inband][order]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        w = bwd_w = fix_w = None
        if weights is not None:
            weights = np.asarray(weights, np.float32).reshape(-1)
            if weights.shape[0] != d.n_rows:
                raise ValueError(f"{weights.shape[0]} weights for "
                                 f"{d.n_rows} output rows")
            w, bwd_w = f32(weights), f32(weights[cols])
        fix = fix_pos = None
        # the spec pads its fix-up lists to a multiple of 8 with (position
        # 0, the zero dummy row) for the TPU; a real fix-up never reads the
        # dummy, and the routes put the fix-ups in place, so the pads go
        real = np.asarray(d.fix_src) != d.n_src - 1
        if real.any():
            pos = np.asarray(d.fix_pos, np.int64)[real]
            fix = GatherTable.build(np.asarray(d.fix_src)[real], d.n_src,
                                    device)
            fix_pos = torch.as_tensor(pos, device=device)
            if weights is not None:
                fix_w = f32(weights[pos])
        return BandTable(
            spec=spec,
            base=torch.as_tensor(np.asarray(d.base, np.int32), device=device),
            rel=torch.as_tensor(np.asarray(d.rel, np.int32).reshape(-1),
                                device=device),
            w=w, bwd=CSRTable.build(offs, cols, n_src=d.n_rows,
                                    device=device),
            bwd_w=bwd_w, fix=fix, fix_pos=fix_pos, fix_w=fix_w)


def _sources(table: BandTable):
    """(source row of every output row, clamped to 0 out of band; in-band
    mask), from the spec's arrays as the kernel computes them."""
    d = table.diag
    p = torch.arange(d.n_rows, device=table.rel.device)
    rel = table.rel[:d.n_rows].long()
    src = table.base.long()[p // (d.R * d.S)] * d.R + rel - d.K * d.R
    inband = rel >= 0
    return torch.where(inband, src, torch.zeros_like(src)), inband


def banded_gather_fwd_plain(xp: torch.Tensor,
                            table: BandTable) -> torch.Tensor:
    """The plain PyTorch version of the forward: index_select of the source
    rows, zeroed out of band, times the weights."""
    src, inband = _sources(table)
    g = xp.index_select(0, src)
    g = torch.where(inband[:, None], g, torch.zeros_like(g))
    if table.weighted:
        g = g * table.w[:, None].to(g.dtype)
    return g


def banded_gather_bwd_plain(ct: torch.Tensor,
                            table: BandTable) -> torch.Tensor:
    """The plain PyTorch version of the backward: index_add_ of the in-band
    rows of ct (times their weights) into their sources.  -> float32."""
    src, inband = _sources(table)
    ct = ct.float()
    if table.weighted:
        ct = ct * table.w[:, None]
    dx = ct.new_zeros((table.n_src, ct.shape[1]))
    return dx.index_add_(0, src[inband], ct[inband])


def _check(x: torch.Tensor, n_rows: int, table: BandTable, what: str):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what} expects a contiguous 2-D tensor, got "
                         f"{tuple(x.shape)}")
    if x.shape[0] != n_rows:
        raise ValueError(f"{what}: {x.shape[0]} rows, the band table has "
                         f"{n_rows}")
    if table.rel.device != x.device:
        raise ValueError(f"band table on {table.rel.device}, tensor on "
                         f"{x.device}")
    if x.shape[1] * x.element_size() >= 2 ** 31 or table.n_rows >= 2 ** 31:
        raise ValueError(f"{what}: rows too large for the kernel")


def banded_gather_fwd(xp: torch.Tensor, table: BandTable) -> torch.Tensor:
    """xp [n_src, M] (float32 or bfloat16; float32 when weighted) ->
    g [n_rows, M] of xp's type.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if xp.device.type == "cpu":
        return banded_gather_fwd_plain(xp, table)
    if xp.device.type != "cuda":
        raise ValueError(f"banded_gather runs on cpu or cuda, not "
                         f"{xp.device}")
    _check(xp, table.n_src, table, "banded_gather_fwd")
    allowed = (torch.float32,) if table.weighted else (torch.float32,
                                                       torch.bfloat16)
    if xp.dtype not in allowed:
        raise TypeError(f"banded_gather_fwd takes {allowed}, got {xp.dtype}")
    d = table.diag
    out = torch.empty((d.n_rows, xp.shape[1]), dtype=xp.dtype,
                      device=xp.device)
    if out.numel() == 0:
        return out
    row_bytes = xp.shape[1] * xp.element_size()
    unit = copy_unit(row_bytes, xp, out)
    if table.weighted and unit != 16:
        unit = 4
    lib = build.load("banded_gather")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_banded_gather_fwd(
            xp.data_ptr(), table.base.data_ptr(), table.rel.data_ptr(),
            table.w.data_ptr() if table.weighted else None, out.data_ptr(),
            d.n_rows, row_bytes, unit, d.R * d.S, d.R, d.K * d.R, stream)
    build.check(lib, rc, "banded_gather forward kernel launch")
    banded_gather_fwd.launches += 1
    return out


banded_gather_fwd.launches = 0


def banded_gather_bwd(ct: torch.Tensor, table: BandTable) -> torch.Tensor:
    """ct [n_rows, M] -> dx [n_src, M] float32 (a bfloat16 ct is summed in
    float32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if ct.device.type == "cpu":
        return banded_gather_bwd_plain(ct, table)
    if ct.device.type != "cuda":
        raise ValueError(f"banded_gather runs on cpu or cuda, not "
                         f"{ct.device}")
    ct = ct.float().contiguous()
    _check(ct, table.n_rows, table, "banded_gather_bwd")
    m = ct.shape[1]
    csr = table.bwd
    dx = torch.empty((table.n_src, m), dtype=torch.float32, device=ct.device)
    if dx.numel() == 0:
        return dx
    n_chunks = csr.chunk_lo.shape[0]
    partial = torch.empty((max(n_chunks, 1), m), dtype=torch.float32,
                          device=ct.device)
    vec = 4 if m % 4 == 0 and copy_unit(m * 4, ct, dx) == 16 else 1
    lib = build.load("banded_gather")
    with torch.cuda.device(ct.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_banded_gather_bwd(
            ct.data_ptr(), csr.offs.data_ptr(), csr.cols.data_ptr(),
            table.bwd_w.data_ptr() if table.weighted else None,
            csr.chunk_lo.data_ptr(), csr.chunk_hi.data_ptr(),
            csr.long_rows.data_ptr(), csr.chunk_offs.data_ptr(),
            partial.data_ptr(), dx.data_ptr(), table.n_src, m, vec,
            LONG_ROW, csr.long_rows.shape[0], n_chunks, stream)
    build.check(lib, rc, "banded_gather backward kernel launch")
    banded_gather_bwd.launches += 1
    return dx


banded_gather_bwd.launches = 0


class BandedGatherFn(torch.autograd.Function):
    """g = banded_gather_fwd(xp), dxp = banded_gather_bwd(dg) in xp's
    type; the table (and its weights) get no gradient."""

    @staticmethod
    def forward(ctx, xp, table: BandTable):
        ctx.table = table
        ctx.dtype = xp.dtype
        return banded_gather_fwd(xp, table)

    @staticmethod
    def backward(ctx, dg):
        if not ctx.needs_input_grad[0]:
            return None, None
        return banded_gather_bwd(dg, ctx.table).to(ctx.dtype), None
