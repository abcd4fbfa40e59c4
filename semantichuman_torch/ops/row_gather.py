"""Row gather on packed rows (counterpart of the TPU kernel
`benchmarks/pallas_dma_gather_probe.py:dma_gather`):

    out[k, :] = x[idx[k], :]        x [N, D], idx [n] int32

In the port it is the out-of-band fix-up gather `take(xp, fix_src)` of the
banded routes (`ops/spiral_conv.py:spiral_conv_banded`,
`ops/sampling.py:unpool_banded`).  `row_gather` launches the hand-written
kernel (`csrc/row_gather.cu`) for a CUDA tensor and counts the launch in
`row_gather.launches`; for a CPU tensor it runs `row_gather_plain`.

`RowGatherFn` gives it a gradient: the scatter-add of the gathered rows'
cotangent back into x, which runs through the deterministic CSR reduce
(`ops/csr_reduce.py`, a kernel on CUDA) over the inverse of `idx`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr_reduce import CSRTable, csr_reduce, inverse_csr
from .kernels import build

_UNITS = (16, 8, 4, 2)


def copy_unit(row_bytes: int, *tensors) -> int:
    """The widest piece (16, 8, 4 or 2 bytes) that divides a row and the
    address of every tensor: the kernels copy rows in such pieces."""
    for unit in _UNITS:
        if row_bytes % unit == 0 and all(t.data_ptr() % unit == 0
                                         for t in tensors):
            return unit
    raise ValueError(f"rows of {row_bytes} bytes: no 2-byte-aligned copy "
                     "unit (element types of 1 byte are not supported)")


@dataclass(frozen=True)
class GatherTable:
    """A row gather's index, int32 on the device, with its inverse as a
    CSR table for the backward.  Built once, on the host."""
    idx: torch.Tensor          # [n] int32
    inverse: CSRTable          # over the n_src source rows

    @property
    def n_src(self) -> int:
        return self.inverse.n_rows

    @staticmethod
    def build(idx, n_src: int, device) -> "GatherTable":
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= n_src):
            raise ValueError(f"gather indices outside [0, {n_src})")
        return GatherTable(
            idx=torch.as_tensor(idx.astype(np.int32), device=device),
            inverse=CSRTable.build(*inverse_csr(idx, n_src), n_src=len(idx),
                                   device=device))


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: index_select of the rows."""
    return x.index_select(0, idx.long())


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"row_gather expects a contiguous x [N, D], got "
                         f"{tuple(x.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError("row_gather expects a contiguous int32 idx [n]")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, D], idx [n] int32 (checked against N when its table was built)
    -> [n, D] of x's type.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return row_gather_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda, not {x.device}")
    _check(x, idx)
    n, d = idx.shape[0], x.shape[1]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    row_bytes = d * x.element_size()
    lib = build.load("row_gather")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_row_gather(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                               n, row_bytes, copy_unit(row_bytes, x, out),
                               stream)
    build.check(lib, rc, "row_gather kernel launch")
    row_gather.launches += 1
    return out


row_gather.launches = 0


class RowGatherFn(torch.autograd.Function):
    """out = x[idx] with dx = the CSR reduce of dout over idx's inverse
    (summed in ascending order of k, so results repeat bit for bit)."""

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
