"""Scatter-free CSR row reduce (counterpart of the TPU kernel
`benchmarks/pallas_dma_gather_probe.py:dma_csr_reduce`):

    out[b, u, :] = sum_{j in [offs[u], offs[u+1])} wt[j] * g[b, cols[j], :]

with `wt` a weight per entry in CSR order, or None (unweighted).  In the
port it is the spiral conv's input gradient, the transpose of the gather
x[b, spiral[v, s]] over the inverse spiral table (`CSRTable`), and the
backward of every row gather of the training path
(`ops/row_gather.py:GatherRowsFn`; weighted for unpool's barycentric
taps).  Each sum runs in ascending j, with no atomics.  `csr_reduce`
launches the hand-written kernel (`csrc/csr_reduce.cu`: one thread per
(row, 16-byte unit) over a tile of batch elements, `plan`) for a CUDA
tensor and counts the launch in `csr_reduce.launches`; for a CPU tensor
it runs `csr_reduce_plain`, the kernel's reference.
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
# threads a block of the short-row kernel; threads that fill an H100 SXM
# once (132 SMs x 2048): the batch tile grows only while the grid keeps at
# least this many threads, as row 7's (ops/row_gather.py:_batch_tile)
_THREADS = 256
_SMS = 132
_FILL_THREADS = _SMS * 2048
# the kernel's batch tiles, largest first: 8 and 16 measured slower at the
# training step's shapes (PERF.md, section 6)
_BATCH_TILES = (4, 2, 1)
# mean entries a row from which 4-byte units take a batch tile of 1
ROUND_ROW = 4


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


def csr_reduce_plain(g: torch.Tensor, table: CSRTable,
                     wt: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: gather every entry's source row, times
    its weight, then add each into its output row.  g [B, M, C] ->
    [B, n_rows, C]."""
    b, _, c = g.shape
    gathered = g.index_select(1, table.cols.long())
    if wt is not None:
        gathered = gathered * wt[:, None]
    out = g.new_zeros((b, table.n_rows, c))
    return out.index_add_(1, table.rows, gathered)


def _check(g: torch.Tensor, table: CSRTable, wt=None) -> None:
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
    if wt is not None and (wt.dtype != torch.float32 or wt.device != g.device
                           or wt.shape != table.cols.shape
                           or not wt.is_contiguous()):
        raise ValueError("csr_reduce expects weights as a contiguous "
                         f"float32 [nnz] on {g.device}")


def plan(b: int, n_rows: int, c: int, unit: int, n_chunks: int = 0,
         nnz: int = 0) -> dict:
    """The kernel's launch for g [b, *, c] float32 over n_rows output rows
    holding nnz entries, moved in pieces of `unit` bytes (16, 8 or 4;
    `row_gather.copy_unit`): units a row, the batch tile bt, the short-row
    grid (ceil(n_rows * units / 256), ceil(b / bt)) and the long-row grid
    (n_chunks, ceil(b / bpw), ceil(units / 32)), whose warps take upw =
    min(units, 32) units of bpw batch elements: 32 // upw, halved while
    the grid has fewer than two blocks an SM.  bt is the largest of
    _BATCH_TILES that keeps the grid at one card's worth of threads (else
    1), and 1 for 4-byte units over rows of ROUND_ROW entries or more on
    average: there a batch element's entries are better in flight
    together (PERF.md, section 6)."""
    if unit not in (16, 8, 4) or (4 * c) % unit:
        raise ValueError(f"no {unit}-byte unit divides a row of {c} floats")
    units = 4 * c // unit
    n_units = n_rows * units
    if n_units >= 2 ** 31:
        raise ValueError(f"{n_rows} rows of {units} units exceed the grid")
    want = max(1, min(b, b * n_units // _FILL_THREADS))
    if unit == 4 and nnz >= ROUND_ROW * n_rows:
        want = 1
    bt = next(t for t in _BATCH_TILES if t <= want)
    upw = min(units, 32)
    bpw = 32 // upw
    while bpw > 1 and n_chunks * -(-b // bpw) * -(-units // 32) < 2 * _SMS:
        bpw //= 2
    grid = (-(-n_units // _THREADS), -(-b // bt))
    long_grid = (n_chunks, -(-b // bpw), -(-units // 32))
    if max(grid[1], long_grid[1], long_grid[2]) > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid")
    return {"unit": unit, "units": units, "bt": bt, "grid": grid,
            "long_bpw": bpw, "long_grid": long_grid}


def _launch(g, table: CSRTable, wt):
    """Check, allocate and launch sh_csr_reduce with the unit and batch
    tile of `plan`; returns (output, whether a kernel was launched: not
    for an empty output)."""
    _check(g, table, wt)
    b, m, c = g.shape
    out = torch.empty((b, table.n_rows, c), dtype=torch.float32,
                      device=g.device)
    if out.numel() == 0:
        return out, False
    n_chunks = table.chunk_lo.shape[0]
    partial = torch.empty((max(n_chunks, 1), b, c), dtype=torch.float32,
                          device=g.device)
    from .row_gather import copy_unit
    p = plan(b, table.n_rows, c, copy_unit(4 * c, g, out, partial),
             n_chunks, table.cols.shape[0])
    lib = build.load("csr_reduce")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_csr_reduce(
            g.data_ptr(), table.offs.data_ptr(), table.cols.data_ptr(),
            None if wt is None else wt.data_ptr(),
            table.chunk_lo.data_ptr(), table.chunk_hi.data_ptr(),
            table.long_rows.data_ptr(), table.chunk_offs.data_ptr(),
            partial.data_ptr(), out.data_ptr(), b, m, table.n_rows, c,
            LONG_ROW, table.long_rows.shape[0], n_chunks, p["unit"],
            p["bt"], p["long_bpw"], stream)
    build.check(lib, rc, "csr_reduce kernel launch")
    return out, True


def csr_reduce(g: torch.Tensor, table: CSRTable,
               wt: torch.Tensor | None = None) -> torch.Tensor:
    """g [B, M, C] float32, wt [nnz] float32 in CSR order or None ->
    [B, n_rows, C] float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, counted in `csr_reduce.launches`, or
    raise."""
    if g.device.type == "cpu":
        return csr_reduce_plain(g, table, wt)
    if g.device.type != "cuda":
        raise ValueError(f"csr_reduce runs on cpu or cuda, not {g.device}")
    out, launched = _launch(g, table, wt)
    csr_reduce.launches += int(launched)
    return out


csr_reduce.launches = 0
