"""The CSR reduce (row 8, `ops/csr_reduce.py`) on the CPU, over the tables
of the bundled topology and the loss: the kernel's launch plan (unit,
batch tile, grids) and the split of long rows into chunks, which decide
that every entry of every row is summed once and in which order; the
plain version against a numpy sum over ascending entries with each
weighted product rounded to float32, bit for bit (the order both CUDA
kernels keep); the wrapper's CPU path; the build registering every CUDA
source; and the calls chip_smoke.py records from one training step.

The card's checks (the kernel within 1e-5 of the plain version's largest
entry, two runs bit-equal) are `tests/test_torch_kernels_cuda.py`'s."""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as CS
from semantichuman_torch.ops import csr_reduce as TR
from semantichuman_torch.ops.kernels import build

ROOT = Path(__file__).resolve().parents[1]
TOPOLOGY = ROOT / "assets" / "topology_synth_full_2222.npz"
# (table name, C) of the training path's reductions: the spiral inverses
# at their conv input widths, the pools', unpools' and part head's
# inverses, and the face gather's
TABLES = ([(f"spiral_{lvl}", c) for lvl, c in
           enumerate((3, 16, 32, 64, 128))]
          + [(f"pool_{lvl}", c) for lvl, c in enumerate((16, 32, 64, 128))]
          + [(f"unpool_{lvl}", c) for lvl, c in enumerate((32, 32, 64, 128))]
          + [("faces", 3), ("part_head", 128)])


@pytest.fixture(scope="module")
def tables():
    """name -> (CSRTable, weights in CSR order or None), on the CPU."""
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.ops import row_gather as RG
    from semantichuman_torch.ops.distance import face_table
    from semantichuman_torch.topology import MeshHierarchy

    t = device_tables(MeshHierarchy.load(str(TOPOLOGY)), "cpu")
    out = {f"spiral_{lvl}": (csr, None)
           for lvl, csr in enumerate(t.spiral_csr)}
    out.update({f"pool_{lvl}": (g.inverse, None)
                for lvl, g in enumerate(t.pool_gather)})
    out.update({f"unpool_{lvl}": (g.inverse, g.inv_w)
                for lvl, g in enumerate(t.unpool_gather)})
    human = SyntheticHuman()
    out["faces"] = (face_table(human.template_faces, len(
        human.template_verts), "cpu").inverse, None)
    coarse = t.sizes[-1]
    idx = np.full((4, 40), coarse)
    idx[:, :25] = np.arange(100).reshape(4, 25)
    out["part_head"] = (RG.GatherTable.build(idx.reshape(-1), coarse + 1,
                                             "cpu").inverse, None)
    return out


def _covered(table, p) -> None:
    """Every entry of every row is summed once, in ascending order, by the
    one path that writes the row: short rows by the flat map's groups of
    entries, long rows by their chunks, each chunk's entries split over
    the warps as csrc/csr_reduce.cu does."""
    offs = table.offs.numpy().astype(np.int64)
    deg = np.diff(offs)
    long_rows = table.long_rows.numpy()
    assert np.array_equal(long_rows, np.nonzero(deg > TR.LONG_ROW)[0])
    lo, hi = table.chunk_lo.numpy(), table.chunk_hi.numpy()
    coffs = table.chunk_offs.numpy()
    assert len(coffs) == len(long_rows) + 1 and coffs[0] == 0
    assert coffs[-1] == len(lo) == len(hi) == p["long_grid"][0]
    for i, u in enumerate(long_rows):
        ks = range(coffs[i], coffs[i + 1])
        assert [lo[k] for k in ks][0] == offs[u]
        assert [hi[k] for k in ks][-1] == offs[u + 1]
        for k in ks:
            assert 0 < hi[k] - lo[k] <= TR.CHUNK
            if k + 1 < coffs[i + 1]:
                assert hi[k] == lo[k + 1]
            # warp w takes the entries lo + w, lo + w + 8, ...
            seen = np.sort(np.concatenate(
                [np.arange(lo[k] + w, hi[k], 8) for w in range(8)]))
            assert np.array_equal(seen, np.arange(lo[k], hi[k]))
    # short rows: groups of E = 8 / bt entries from the row's start, added
    # below its end
    e = 8 // p["bt"]
    short = np.nonzero(deg <= TR.LONG_ROW)[0]
    for u in short[:: max(1, len(short) // 300)]:
        got = [j0 + i for j0 in range(offs[u], offs[u + 1], e)
               for i in range(e) if j0 + i < offs[u + 1]]
        assert got == list(range(offs[u], offs[u + 1]))


@pytest.mark.parametrize("b", [1, 3, 12, 128, 384])
@pytest.mark.parametrize("name,c", TABLES)
def test_plan_covers_every_row_and_entry(tables, name, c, b):
    """The plan's unit divides the row, its grids cover every (row, unit)
    and every batch element once, the tile is one of the kernel's and keeps
    the grid at a card's worth of threads, and the rows split into short
    rows and chunked long rows that cover every entry once."""
    table, _wt = tables[name]
    unit = 16 if c % 4 == 0 else 8 if c % 2 == 0 else 4
    p = TR.plan(b, table.n_rows, c, unit, table.chunk_lo.shape[0],
                table.cols.shape[0])
    units = 4 * c // unit
    n_units = table.n_rows * units
    assert p["unit"] == unit and p["units"] == units
    gx, gy = p["grid"]
    assert (gx - 1) * TR._THREADS < n_units <= gx * TR._THREADS
    bt = p["bt"]
    assert bt in TR._BATCH_TILES and (gy - 1) * bt < b <= gy * bt
    if bt > 1:
        assert b * n_units // TR._FILL_THREADS >= bt
    if unit == 4 and table.cols.shape[0] >= TR.ROUND_ROW * table.n_rows:
        assert bt == 1
    # every flat index maps to one (row, unit), every pair once
    k = np.arange(n_units)
    pairs = (k // units) * units + k % units
    assert np.array_equal(pairs, k) and (k // units).max() == \
        table.n_rows - 1
    upw, bpw = min(units, 32), p["long_bpw"]
    _n, gyl, gzl = p["long_grid"]
    assert bpw * upw <= 32 and any(bpw == (32 // upw) >> k for k in range(6))
    assert gyl * bpw >= b > (gyl - 1) * bpw
    assert gzl * 32 >= units > (gzl - 1) * 32
    if bpw < 32 // upw:        # fewer a warp only to fill the card
        assert _n * -(-b // (2 * bpw)) * gzl < 2 * TR._SMS
    _covered(table, p)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        TR.plan(2, 10, 3, 8)                # 8 bytes do not divide 12
    with pytest.raises(ValueError):
        TR.plan(2, 10, 4, 2)                # no 2-byte unit of float32
    with pytest.raises(ValueError):
        TR.plan(65536 * 4 + 1, 10, 4, 16)   # past the grid's 65535
    with pytest.raises(ValueError):
        TR.plan(1, 2 ** 30, 32, 16)         # rows x units past int32


def _ascending_sum(g, table, w):
    """out[b, u] = sum over j ascending of (w[j] * g[b, cols[j]]) in
    float32, each product rounded to float32, starting from 0."""
    offs = table.offs.numpy().astype(np.int64)
    cols = table.cols.numpy().astype(np.int64)
    out = np.zeros((g.shape[0], table.n_rows, g.shape[2]), np.float32)
    deg = np.diff(offs)
    for r in range(int(deg.max())):
        rows = np.nonzero(deg > r)[0]
        j = offs[rows] + r
        term = g[:, cols[j]]
        if w is not None:
            term = (w[j][None, :, None] * term).astype(np.float32)
        out[:, rows] = (out[:, rows] + term).astype(np.float32)
    return out


@pytest.mark.parametrize("name", ["unpool_0", "unpool_1", "unpool_2",
                                  "unpool_3", "pool_0", "spiral_3"])
def test_plain_sums_in_ascending_order(tables, name):
    """csr_reduce_plain equals the numpy sum over ascending entries, bit
    for bit: the CPU's index_add_ adds in index order, which is the order
    both CUDA kernels keep (and the card holds them bit-equal)."""
    table, wt = tables[name]
    rng = np.random.default_rng(len(name))
    g = rng.standard_normal((3, table.n_src, 5)).astype(np.float32)
    got = TR.csr_reduce_plain(torch.from_numpy(g), table, wt).numpy()
    want = _ascending_sum(g, table, None if wt is None else wt.numpy())
    assert np.array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_v1_runs_the_plain_version_on_the_cpu(tables, weighted):
    """csr_reduce takes the plain version for a CPU tensor and counts no
    launch."""
    table, wt = tables["unpool_1"]
    wt = wt if weighted else None
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, table.n_src, 8)).astype(np.float32))
    before = TR.csr_reduce.launches
    ref = TR.csr_reduce_plain(g, table, wt)
    assert torch.equal(TR.csr_reduce(g, table, wt), ref)
    assert TR.csr_reduce.launches == before


def test_build_covers_every_source():
    """build_all compiles every CUDA source of the port: six, each with
    its error-string entry point."""
    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    assert sorted(build.SIGNATURES) == sources and len(sources) == 6
    assert "csr_reduce" in sources
    for fns in build.SIGNATURES.values():
        assert "sh_cuda_error_string" in fns


def test_chip_smoke_records_a_step_s_calls(monkeypatch):
    """chip_smoke.py's phase 4 records the calls of one step at its
    shapes: on the CPU (take route, the conv's backward in autograd) the
    16 gathers' backwards by family, the unpools' weighted."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train.losses import build_loss_tables

    monkeypatch.setattr(CS, "DEVICE", "cpu")
    human = SyntheticHuman()
    model = build_model(ModelConfig(), MeshHierarchy.load(str(TOPOLOGY)),
                        human.part_dict, device="cpu")
    loss_tables = build_loss_tables(human.template_faces, human.J_regressor,
                                    human.part_dict, device="cpu")
    calls = CS.step_csr_calls(model, human, loss_tables, b=1)
    fams = [c["family"] for c in calls]
    assert len(calls) == CS.STEP_LAUNCHES["csr_reduce"] - 1
    assert {f: fams.count(f) for f in set(fams)} == {
        "pool": 4, "unpool": 4, "part head": 1, "loss": 7}
    assert all((c["wt"] is not None) == (c["family"] == "unpool")
               for c in calls)
    assert all(c["shape"][0] == 3 for c in calls
               if c["family"] in ("pool", "unpool", "part head"))
