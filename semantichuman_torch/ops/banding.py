"""Block-banded gather tables (the port's copy of
`semantichuman_tpu/ops/banding.py`, NumPy only).

Spiral and unpool index tables are local: on the bundled topology 97%+ of
the real entries of a block of R output rows read source rows inside a
narrow window.  `BandSpec` records one window per block plus the exact
out-of-band fix-up lists; `DiagBandSpec` is its block-diagonal companion
(K aligned R-row source blocks from block `base[n]`), which the port's
banded-gather kernels (`ops/banded_gather.py`) read.  Which tables carry a
band is decided in `models/tables.py`.

The presets and the out-of-band budget are module constants read at call
time, so that tests can shrink them to a small topology.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

# (block rows R, window W) presets, tried in order; a table adopts the
# first whose out-of-band fraction is acceptable.  The window covers the
# block's source span: spiral rows read their own level (span ~R), unpool
# rows the next-coarser level (span ~R/2), pool rows the next-finer one.
BAND_PRESETS = ((256, 768), (512, 1024))
UNPOOL_BAND_PRESETS = ((256, 512), (512, 768))
POOL_BAND_PRESETS = ((128, 384), (256, 768))
MAX_OOB_FRAC = 0.05


@dataclass(frozen=True)
class DiagBandSpec:
    """Block-diagonal banding: output block n (R rows of S entries) reads
    the K source blocks base[n] .. base[n]+K-1, addressed in a source space
    front-padded by K blocks.

    rel[n, r*S+s] = sp[n*R+r, s] - base[n]*R + K*R in [0, K*R), or -1 (no
    source: dummy pads out of the window, out-of-band entries, rows past
    the table).  So an in-band entry's source row is base[n]*R + rel - K*R.
    bw_n/bw_k list, per padded source block q, the destination blocks n
    (and diagonal k) that read it, padded to width L with the sentinel
    block `nblk`; the port's backward does not need them (it reduces over
    a CSR table built from `rel`) but keeps them for parity.
    """
    base: np.ndarray      # [nblk] int32, block units, >= 0 (padded space)
    rel: np.ndarray       # [nblk, R*S] int32, -1 sentinel
    bw_n: np.ndarray      # [n_src_blocks, L] int32 (nblk = zero-pad block)
    bw_k: np.ndarray      # [n_src_blocks, L] int32
    fix_pos: np.ndarray   # flat v*S+s positions out of the diagonal window
    fix_src: np.ndarray
    R: int
    K: int
    S: int
    n_rows: int           # true output rows (N*S)
    n_src: int            # true source rows (dummy + 1)
    oob_frac: float

    @property
    def nblk(self) -> int:
        return len(self.base)

    @property
    def n_src_blocks(self) -> int:
        return self.bw_n.shape[0]


def _pad_fixups(fix_pos, fix_src, dummy: int):
    """Pad the fix-up lists to a multiple of 8 with (pos 0, src dummy): an
    exact no-op only because the dummy SOURCE row is zero."""
    pad = (-len(fix_pos)) % 8
    return (np.concatenate([fix_pos, np.zeros(pad, np.int32)]),
            np.concatenate([fix_src, np.full(pad, dummy, np.int32)]))


def build_diag_spec(index_table: np.ndarray, R: int, K: int,
                    dummy: int | None = None) -> DiagBandSpec:
    """[N, S] dummy-resolved index table -> DiagBandSpec for (R, K)."""
    sp = np.asarray(index_table)
    n, s = sp.shape
    if dummy is None:
        dummy = int(sp.max())
    nblk = (n + R - 1) // R
    base = np.empty(nblk, np.int64)
    for b in range(nblk):
        blk = sp[b * R:(b + 1) * R]
        real = blk[blk != dummy]
        center = int(np.median(real)) if real.size else b * R + R // 2
        base[b] = int(np.floor(center / R)) - K // 2
    # monotone (the backward's contiguous runs need it) + front-pad shift
    base = np.maximum.accumulate(base) + K
    sp_pad = np.full((nblk * R, s), -1, np.int64)
    sp_pad[:n] = sp
    rel = sp_pad.reshape(nblk, R, s) + K * R - base[:, None, None] * R
    hit = (rel >= 0) & (rel < K * R) & (sp_pad.reshape(nblk, R, s) >= 0)
    rel = np.where(hit, rel, -1).astype(np.int32).reshape(nblk, R * s)
    miss = ~hit.reshape(nblk * R, s)[:n] & (sp != dummy)
    miss_v, miss_s = np.nonzero(miss)
    fix_pos, fix_src = _pad_fixups((miss_v * s + miss_s).astype(np.int32),
                                   sp[miss_v, miss_s].astype(np.int32),
                                   dummy)
    # backward: source block q (in the padded space) <- destinations
    n_src = dummy + 1
    n_src_blocks = (n_src + R - 1) // R + 2 * K
    runs = [[] for _ in range(n_src_blocks)]
    for nb in range(nblk):
        for k in range(K):
            q = int(base[nb]) + k
            if 0 <= q < n_src_blocks:
                runs[q].append((nb, k))
    L = max(1, max(len(r) for r in runs))
    bw_n = np.full((n_src_blocks, L), nblk, np.int32)   # sentinel block
    bw_k = np.zeros((n_src_blocks, L), np.int32)
    for q, r in enumerate(runs):
        for j, (nb, k) in enumerate(r):
            bw_n[q, j] = nb
            bw_k[q, j] = k
    return DiagBandSpec(base=base.astype(np.int32), rel=rel, bw_n=bw_n,
                        bw_k=bw_k, fix_pos=fix_pos, fix_src=fix_src,
                        R=R, K=K, S=s, n_rows=n * s, n_src=n_src,
                        oob_frac=len(miss_v) / sp.size)


@dataclass(frozen=True)
class BandSpec:
    """Banding of one [N, S] index table (a spiral table, unpool_idx, or
    pool_idx[:, None]): a window start per block in the W-padded source,
    the out-of-band fix-up lists (padded to a multiple of 8 with
    (pos 0, src dummy)), and the block-diagonal companion `diag`, which the
    port's kernels use."""
    starts: tuple
    fix_pos: np.ndarray
    fix_src: np.ndarray
    R: int
    W: int
    oob_frac: float
    diag: DiagBandSpec | None = None

    @property
    def nblk(self) -> int:
        return len(self.starts)


def build_band_spec(index_table: np.ndarray, R: int, W: int,
                    dummy: int | None = None) -> BandSpec:
    """[N, S] dummy-resolved index table -> BandSpec for (R, W).  `dummy`
    is the zero dummy SOURCE row (the table's row count minus one for a
    spiral table, the coarse or fine dummy for unpool or pool)."""
    sp = np.asarray(index_table)
    v1, s = sp.shape
    if dummy is None:
        dummy = v1 - 1
    nblk = (v1 + R - 1) // R
    # window centred on the median of each block's real source indices;
    # +W because the source is padded by W zero rows on each side
    starts = []
    for n in range(nblk):
        blk = sp[n * R:(n + 1) * R]
        real = blk[blk != dummy]
        center = int(np.median(real)) if real.size else n * R + R // 2
        starts.append(center - W // 2 + W)
    starts = tuple(starts)
    rel = sp + W - np.asarray(starts, np.int64)[np.arange(v1) // R][:, None]
    hit = (rel >= 0) & (rel < W)
    miss_v, miss_s = np.nonzero(~hit & (sp != dummy))
    fix_pos, fix_src = _pad_fixups((miss_v * s + miss_s).astype(np.int32),
                                   sp[miss_v, miss_s].astype(np.int32),
                                   dummy)
    return BandSpec(starts=starts, fix_pos=fix_pos, fix_src=fix_src,
                    R=R, W=W, oob_frac=len(miss_v) / sp.size)


def pick_band_spec(index_table: np.ndarray, presets=None,
                   max_oob: float | None = None,
                   dummy: int | None = None) -> BandSpec | None:
    """The first preset whose out-of-band fraction is acceptable, with its
    block-diagonal companion (K = W // R + 1, so K*R >= W); None when no
    preset is (a table with no locality keeps the gather path).  A failure
    to build the companion raises: the port has no other banded form."""
    if presets is None:
        presets = BAND_PRESETS
    if max_oob is None:
        max_oob = MAX_OOB_FRAC
    for R, W in presets:
        spec = build_band_spec(index_table, R, W, dummy=dummy)
        if spec.oob_frac <= max_oob:
            diag = build_diag_spec(np.asarray(index_table), R, W // R + 1,
                                   dummy=dummy)
            return replace(spec, diag=diag)
    return None
