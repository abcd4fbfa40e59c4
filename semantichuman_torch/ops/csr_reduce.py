"""Scatter-free CSR row reduce (counterpart of the TPU kernel
`benchmarks/pallas_dma_gather_probe.py:dma_csr_reduce`):

    out[b, u, :] = sum_{j in [offs[u], offs[u+1])} g[b, cols[j], :]

In the port it is the spiral conv's input gradient, the transpose of the
gather x[b, spiral[v, s]] over the inverse spiral table (`CSRTable`).
`csr_reduce` launches the hand-written kernel (`csrc/csr_reduce.cu`) for a
CUDA tensor and counts the launch in `csr_reduce.launches`; for a CPU
tensor it runs `csr_reduce_plain`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kernels import build

# rows with more entries than this take the kernel's split reduction; every
# real vertex of the bundled topology has at most 38, the dummy row 34,041
LONG_ROW = 64
# entries per chunk of a long row
CHUNK = 512


@dataclass(frozen=True)
class CSRTable:
    """An int32 CSR table over `n_rows` output rows, with the kernel's
    split of its long rows into chunks.  Built once, on the host."""
    offs: torch.Tensor         # [n_rows+1] int32
    cols: torch.Tensor         # [nnz] int32, source row of each entry
    rows: torch.Tensor         # [nnz] int64, output row of each entry
    long_rows: torch.Tensor    # [n_long] int32, rows longer than LONG_ROW
    chunk_lo: torch.Tensor     # [n_chunks] int32, first entry of a chunk
    chunk_hi: torch.Tensor     # [n_chunks] int32, one past its last entry
    chunk_offs: torch.Tensor   # [n_long+1] int32, chunks of each long row
    n_src: int                 # rows of the source g

    @property
    def n_rows(self) -> int:
        return self.offs.shape[0] - 1

    @staticmethod
    def build(offs: np.ndarray, cols: np.ndarray, n_src: int,
              device) -> "CSRTable":
        offs = np.asarray(offs, np.int64)
        cols = np.asarray(cols, np.int64)
        if offs[0] != 0 or offs[-1] != len(cols) or np.any(np.diff(offs) < 0):
            raise ValueError("CSR offsets must rise from 0 to nnz")
        if cols.size and (cols.min() < 0 or cols.max() >= n_src):
            raise ValueError(f"CSR columns outside [0, {n_src})")
        deg = np.diff(offs)
        long_rows = np.nonzero(deg > LONG_ROW)[0]
        lo, hi, chunk_offs = [], [], [0]
        for u in long_rows:
            starts = np.arange(offs[u], offs[u + 1], CHUNK)
            lo.extend(starts)
            hi.extend(np.minimum(starts + CHUNK, offs[u + 1]))
            chunk_offs.append(len(lo))
        rows = np.repeat(np.arange(len(deg)), deg)

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32),
                                   device=device)

        return CSRTable(offs=i32(offs), cols=i32(cols),
                        rows=torch.as_tensor(rows, device=device),
                        long_rows=i32(long_rows), chunk_lo=i32(lo),
                        chunk_hi=i32(hi), chunk_offs=i32(chunk_offs),
                        n_src=int(n_src))


def inverse_csr(flat_idx, n_rows: int):
    """The transpose of a gather by `flat_idx` as CSR: row u lists every
    position k with flat_idx[k] == u, in ascending order (a stable sort).
    Returns (offs [n_rows+1], cols [len(flat_idx)]) int64."""
    flat = np.asarray(flat_idx, np.int64).reshape(-1)
    cols = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_rows)
    offs = np.concatenate([[0], np.cumsum(counts)])
    return offs, cols


def csr_reduce_plain(g: torch.Tensor, table: CSRTable) -> torch.Tensor:
    """The plain PyTorch version: gather every entry's source row, then add
    each into its output row.  g [B, M, C] -> [B, n_rows, C]."""
    b, _, c = g.shape
    gathered = g.index_select(1, table.cols.long())
    out = g.new_zeros((b, table.n_rows, c))
    return out.index_add_(1, table.rows, gathered)


def _check(g: torch.Tensor, table: CSRTable) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if g.dim() != 3 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("csr_reduce expects a contiguous float32 g "
                         f"[B, M, C], got {tuple(g.shape)} {g.dtype}")
    if g.shape[1] != table.n_src:
        raise ValueError(f"g has {g.shape[1]} rows, the table indexes "
                         f"{table.n_src}")
    if table.offs.device != g.device:
        raise ValueError(f"table on {table.offs.device}, g on {g.device}")
    if g.shape[0] > 65535:
        raise ValueError(f"batch {g.shape[0]} exceeds the grid limit 65535")


def csr_reduce(g: torch.Tensor, table: CSRTable) -> torch.Tensor:
    """g [B, M, C] float32 -> [B, n_rows, C] float32.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if g.device.type == "cpu":
        return csr_reduce_plain(g, table)
    if g.device.type != "cuda":
        raise ValueError(f"csr_reduce runs on cpu or cuda, not {g.device}")
    _check(g, table)
    b, m, c = g.shape
    out = torch.empty((b, table.n_rows, c), dtype=torch.float32,
                      device=g.device)
    if out.numel() == 0:
        return out
    n_chunks = table.chunk_lo.shape[0]
    partial = torch.empty((max(n_chunks, 1), b, c), dtype=torch.float32,
                          device=g.device)
    lib = build.load("csr_reduce")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_csr_reduce(
            g.data_ptr(), table.offs.data_ptr(), table.cols.data_ptr(),
            table.chunk_lo.data_ptr(), table.chunk_hi.data_ptr(),
            table.long_rows.data_ptr(), table.chunk_offs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), b, m, table.n_rows, c,
            LONG_ROW, table.long_rows.shape[0], n_chunks, stream)
    build.check(lib, rc, "csr_reduce kernel launch")
    csr_reduce.launches += 1
    return out


csr_reduce.launches = 0
