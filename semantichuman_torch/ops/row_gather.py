"""Batched, weighted row gather (counterpart of the TPU kernel
`benchmarks/pallas_dma_gather_probe.py:dma_gather`):

    out[b, r, :] = sum_{t<T} w[r, t] * x[b, idx[r, t], :]
        x [B, N, C], idx [R, T] int32 (T = 1 or 3), w [R, T] float32 or None

`gather_rows_fwd` launches the hand-written kernel (`csrc/row_gather.cu`)
for a CUDA tensor and counts the launch in `row_gather.launches`; for a CPU
tensor it runs `gather_rows_plain`.  `GatherRowsFn` reaches it through the
custom op `semantichuman::gather_rows` (`gather_rows_op`), so that
`torch.export` traces the gather as one node.  `row_gather(x [N, D],
idx [n])` is the case B = 1, T = 1, unweighted: the banded routes'
out-of-band fix-up gather (`ops/spiral_conv.py:spiral_conv_banded`,
`ops/sampling.py:unpool_banded`).

A `GatherTable` holds an index, its optional weights and the inverse as a
CSR table, built once, on the host.  `gather_rows(x, table)`
(`GatherRowsFn`) gives the gather its gradient: dx is the CSR reduce of the
output's cotangent over the inverse, weighted where the table is
(`ops/csr_reduce.py`, a kernel on CUDA), each row summed in ascending
order of the flat entry k = r*T + t.  No atomics, so a training run repeats
bit for bit.  Every gather of the training path whose input can need a
gradient goes through it: pool, unpool's take route, the part heads, the
face corners, the distance loss's part buckets and the small keypoint and
latent gathers of the losses.  `RowGatherFn` does the same for the banded
routes' 2-D fix-up gather.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .csr_reduce import CSRTable, csr_reduce, inverse_csr
from .kernels import LIB, build

_UNITS = (16, 8, 4, 2)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# threads that fill an H100 SXM once (132 SMs x 2048): the batch tile grows
# only while the grid keeps at least this many threads
_FILL_THREADS = 132 * 2048
_MAX_BATCH_TILE = 16


def copy_unit(row_bytes: int, *tensors, strides=()) -> int:
    """The widest piece (16, 8, 4 or 2 bytes) that divides a row, every
    stride in bytes and the address of every tensor: the kernels copy rows
    in such pieces."""
    for unit in _UNITS:
        if (row_bytes % unit == 0 and all(s % unit == 0 for s in strides)
                and all(t.data_ptr() % unit == 0 for t in tensors)):
            return unit
    raise ValueError(f"rows of {row_bytes} bytes: no 2-byte-aligned copy "
                     "unit (element types of 1 byte are not supported)")


@dataclass(frozen=True)
class GatherTable:
    """A row gather's index (int32 [R], or [R, T] for T taps), its optional
    weights, and the inverse as a CSR table over the n_src source rows
    (entry k = r*T + t of the flat index lists row r; `inv_w` holds the
    weights in that CSR order).  Built once, on the host."""
    idx: torch.Tensor                   # [R] or [R, T] int32
    inverse: CSRTable                   # n_src rows over the R output rows
    w: torch.Tensor | None = None       # idx's shape, float32
    inv_w: torch.Tensor | None = None   # [R*T] float32, in CSR order

    @property
    def n_src(self) -> int:
        return self.inverse.n_rows

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]

    @property
    def taps(self) -> int:
        return 1 if self.idx.dim() == 1 else self.idx.shape[1]

    @staticmethod
    def build(idx, n_src: int, device, w=None) -> "GatherTable":
        """idx [R] or [R, T] (T = 1 or 3) into n_src rows; w (idx's shape)
        or None."""
        idx = np.asarray(idx, np.int64)
        if idx.ndim not in (1, 2) or (idx.ndim == 2
                                      and idx.shape[1] not in (1, 3)):
            raise ValueError(f"gather index of shape {idx.shape}: expected "
                             "[R] or [R, T] with T = 1 or 3")
        if idx.size and (idx.min() < 0 or idx.max() >= n_src):
            raise ValueError(f"gather indices outside [0, {n_src})")
        taps = 1 if idx.ndim == 1 else idx.shape[1]
        offs, cols = inverse_csr(idx, n_src)

        def put(a):
            return torch.as_tensor(a, device=device)

        wt = inv_w = None
        if w is not None:
            w = np.asarray(w, np.float32).reshape(idx.shape)
            wt, inv_w = put(w), put(w.reshape(-1)[cols])
        return GatherTable(
            idx=put(idx.astype(np.int32)),
            inverse=CSRTable.build(offs, cols // taps, n_src=idx.shape[0],
                                   device=device),
            w=wt, inv_w=inv_w)


@functools.cache
def _constant_table(values: tuple, n_src: int, device: torch.device,
                    weights: tuple | None) -> GatherTable:
    return GatherTable.build(np.asarray(values), n_src, device,
                             None if weights is None else np.asarray(weights))


def constant_table(values, n_src: int, device, w=None) -> GatherTable:
    """The T = 1 gather table of a small constant index (and weights), built
    once per (values, n_src, device, weights), as `utils/device.py:
    index_tensor` makes constant index tensors: building it in every step
    would make the host wait for the card."""
    return _constant_table(
        tuple(int(v) for v in np.asarray(values).ravel()), int(n_src),
        torch.device(device),
        None if w is None else tuple(float(v) for v in np.asarray(w).ravel()))


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: index_select of the rows; with weights or
    T > 1, the taps times their weights summed in float32 in tap order.
    x [B, N, C], idx [R] or [R, T] -> [B, R, C] of x's type."""
    b, _, c = x.shape
    r = idx.shape[0]
    taps = 1 if idx.dim() == 1 else idx.shape[1]
    flat = idx.reshape(-1).long()
    if taps == 1 and w is None:
        return x.index_select(1, flat)
    g = x.float().index_select(1, flat).reshape(b, r, taps, c)
    w = None if w is None else w.reshape(r, taps)
    out = None
    for t in range(taps):
        term = g[:, :, t] if w is None else g[:, :, t] * w[None, :, t, None]
        out = term if out is None else out + term
    return out.to(x.dtype)


def _check(x, idx, w) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 3 or x.stride(2) != 1 or x.stride(1) != x.shape[2]:
        raise ValueError(f"gather_rows expects x [B, N, C] with packed rows, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if (idx.dim() not in (1, 2) or idx.dtype != torch.int32
            or not idx.is_contiguous()):
        raise TypeError("gather_rows expects a contiguous int32 idx [R] or "
                        "[R, T]")
    taps = 1 if idx.dim() == 1 else idx.shape[1]
    if taps not in (1, 3):
        raise ValueError(f"gather_rows takes 1 or 3 taps, got {taps}")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")
    if w is not None and (w.dtype != torch.float32 or w.shape != idx.shape
                          or not w.is_contiguous() or w.device != x.device):
        raise ValueError("gather_rows expects weights as a contiguous "
                         f"float32 tensor of idx's shape on {x.device}")
    if (w is not None or taps > 1) and x.dtype not in _DTYPES:
        raise TypeError(f"a weighted or multi-tap gather takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.shape[0] > 1 and x.stride(0) * x.element_size() >= 2 ** 31:
        raise ValueError("gather_rows: batch stride too large for the kernel")


def _batch_tile(b: int, n_units: int) -> int:
    """Batch elements a thread loops over: as many as keep the grid at one
    card's worth of threads or more, at most 16."""
    return max(1, min(_MAX_BATCH_TILE, b, b * n_units // _FILL_THREADS))


def gather_rows_fwd(x: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, N, C] (rows packed; any batch stride), idx [R] or [R, T] int32
    (checked against N when its table was built), w idx's shape float32 or
    None -> [B, R, C] of x's type.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, w)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {x.device}")
    _check(x, idx, w)
    b, _, c = x.shape
    r = idx.shape[0]
    out = torch.empty((b, r, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = c * x.element_size()
    batch_bytes = x.stride(0) * x.element_size() if b > 1 else 0
    unit = copy_unit(row_bytes, x, out, strides=(batch_bytes,))
    bt = _batch_tile(b, r * row_bytes // unit)
    if -(-b // bt) > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    lib = build.load("row_gather")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_gather_rows(
            x.data_ptr(), idx.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), b, r,
            1 if idx.dim() == 1 else idx.shape[1], row_bytes, batch_bytes,
            unit, bt, _DTYPES.get(x.dtype, -1), stream)
    build.check(lib, rc, "row_gather kernel launch")
    row_gather.launches += 1
    return out


# `gather_rows_fwd` as the custom op `semantichuman::gather_rows`, so that
# `torch.export` traces it as one node: the body reads the concrete batch
# and the pointers (the copy unit, the batch tile, the batch stride) and
# counts the launch; the fake gives the output's shape alone.
LIB.define("gather_rows(Tensor x, Tensor idx, Tensor? w) -> Tensor")
LIB.impl("gather_rows", lambda x, idx, w: gather_rows_fwd(x, idx, w),
         "CompositeExplicitAutograd")


@torch.library.register_fake("semantichuman::gather_rows", lib=LIB)
def _(x, idx, w):
    return x.new_empty((x.shape[0], idx.shape[0], x.shape[2]))


gather_rows_op = torch.ops.semantichuman.gather_rows.default


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the 2-D gather: index_select of the
    rows."""
    return x.index_select(0, idx.long())


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, D], idx [n] int32 (checked against N when its table was built)
    -> [n, D] of x's type: gather_rows_fwd at B = 1, T = 1.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"row_gather expects a contiguous x [N, D], got "
                         f"{tuple(x.shape)}")
    if idx.dim() != 1:
        raise TypeError("row_gather expects an idx [n]")
    return gather_rows_fwd(x[None], idx)[0]


row_gather.launches = 0


class GatherRowsFn(torch.autograd.Function):
    """out = gather_rows_fwd(x, table.idx, table.w) with dx the CSR reduce
    of dout over the table's inverse, weighted as the table is (rows of x
    past the table's n_src get 0); the table gets no gradient."""

    @staticmethod
    def forward(ctx, x, table: GatherTable):
        if x.shape[1] < table.n_src:
            raise ValueError(f"x has {x.shape[1]} rows, the gather table "
                             f"indexes {table.n_src}")
        ctx.table = table
        ctx.dtype = x.dtype
        ctx.n = x.shape[1]
        if x.stride(2) != 1 or x.stride(1) != x.shape[2]:
            x = x.contiguous()          # the kernel reads packed rows
        return gather_rows_op(x, table.idx, table.w)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None
        table = ctx.table
        dx = csr_reduce(dout.float().contiguous(), table.inverse,
                        table.inv_w)
        if ctx.n > table.n_src:
            dx = torch.cat([dx, dx.new_zeros((dx.shape[0], ctx.n - table.n_src,
                                              dx.shape[2]))], dim=1)
        return dx.to(ctx.dtype), None


def gather_rows(x: torch.Tensor, table: GatherTable) -> torch.Tensor:
    """x [B, N, C] -> [B, R, C]: the table's gather (weighted where it is),
    with the fixed-order CSR reduce as its gradient."""
    return GatherRowsFn.apply(x, table)


class RowGatherFn(torch.autograd.Function):
    """out = x[idx] for the 2-D fix-up gather, with dx = the CSR reduce of
    dout over idx's inverse (summed in ascending order of k, so results
    repeat bit for bit)."""

    @staticmethod
    def forward(ctx, x, table: GatherTable):
        ctx.table = table
        ctx.dtype = x.dtype
        return row_gather(x, table.idx)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return None, None
        g = dout.float().contiguous()
        dx = csr_reduce(g.view(1, *g.shape), ctx.table.inverse)[0]
        return dx.to(ctx.dtype), None
