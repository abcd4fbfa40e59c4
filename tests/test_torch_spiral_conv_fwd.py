"""The spiral conv's forward wrapper on the CPU: the checks of the forward
kernel (`csrc/spiral_conv_fwd.cu`), its tile plan at the default model's
nine convs, the wrapper's plain version, and the batch rule that sends dx
to the unfused route.  The kernels themselves run in
test_torch_kernels_cuda.py."""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

# the module: `semantichuman_torch.ops.spiral_conv` is the function
TC = importlib.import_module("semantichuman_torch.ops.spiral_conv")


torch.set_num_threads(1)

# (V1, S, C, Co) of the default model's nine convs on the bundled topology
MODEL_CONVS = [(6893, 15, 3, 16), (3447, 11, 16, 32), (1724, 8, 32, 64),
               (863, 8, 64, 128), (863, 8, 128, 64), (1724, 8, 64, 32),
               (3447, 11, 32, 32), (6893, 15, 32, 16), (6893, 15, 16, 3)]
BATCHES = (1, 12, 64, 384)
DTYPES = (torch.float32, torch.bfloat16)


def _case(b=2, v1=40, s=6, c=8, co=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0
    idx = rng.integers(0, v1, (v1, s)).astype(np.int32)
    idx[-1] = v1 - 1
    w = (rng.standard_normal((s * c, co)) / np.sqrt(s * c)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, idx, w, bias)]


def _kernel_smem(tile, s, dtype):
    """The shared memory csrc/spiral_conv_fwd.cu's Tile::smem computes:
    two stages of a [BM, 32 + 16 bytes] x tile and a [32, BN] W tile, then
    the [S, BM] offset table."""
    bm, bn, _nt, _mb = TC._FWD_TILES[tile]
    es = 2 if dtype == torch.bfloat16 else 4
    return 2 * (bm * (32 + 16 // es) + 32 * bn) * es + bm * s * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", BATCHES)
def test_plan_covers_every_row_once(b, dtype):
    """At the nine convs and every batch of the main paths: the grid's
    tiles cover the B*V1 rows and the Co outputs once, no tile lies wholly
    outside, the grid and the shared memory stay within the card's
    limits, and the shared memory is what the kernel computes."""
    for v1, s, c, co in MODEL_CONVS:
        plan = TC._fwd_plan(b, v1, c, s, co, dtype)
        m = b * v1
        gx, gy = plan["grid"]
        bm, bn = plan["bm"], plan["bn"]
        starts = np.arange(gx) * bm
        covered = np.zeros(m, np.int64)
        for lo in starts:
            covered[lo:lo + bm] += 1
        assert (covered == 1).all() and starts[-1] < m
        assert (gy - 1) * bn < co <= gy * bn
        assert gx <= TC._GRID_X_MAX and gy <= TC._GRID_Y_MAX
        assert plan["smem"] <= TC._FWD_MAX_SMEM
        if plan["tile"] in TC._FWD_NARROW:
            assert bn == TC._FWD_NARROW[plan["tile"]] >= co
            assert plan["smem"] == s * c * 4 * bn
        else:
            assert (bm, bn) == TC._FWD_TILES[plan["tile"]][:2]
            assert plan["smem"] == _kernel_smem(plan["tile"], s, dtype)


def test_plan_picks_by_width_and_grid():
    """Co <= 4 and the 3-channel input take the narrow kernel; the large
    tiles at the step's batch; smaller tiles where B = 1 would leave the
    card's resident blocks mostly empty."""
    f32 = torch.float32
    tiles = {b: [TC._fwd_plan(b, v1, c, s, co, f32)["tile"]
                 for v1, s, c, co in MODEL_CONVS] for b in BATCHES}
    assert tiles[384] == [8, 3, 2, 0, 1, 3, 3, 5, 7]
    for b in BATCHES:
        assert tiles[b][0] == 8 and tiles[b][-1] == 7
    for big, small in zip(tiles[384], tiles[1]):
        if big in TC._FWD_TILES:
            assert TC._FWD_TILES[small][0] <= TC._FWD_TILES[big][0]
    # every B = 1 grid is at least as large as the v1 kernel's
    # (64 x 64 tiles for Co > 32, 128 x 32 for Co > 16, 256 x 16 else)
    for v1, s, c, co in MODEL_CONVS[:-1]:
        plan = TC._fwd_plan(1, v1, c, s, co, f32)
        v1_bm, v1_bn = (64, 64) if co > 32 else (128, 32) if co > 16 \
            else (256, 16)
        assert plan["grid"][0] * plan["grid"][1] >= \
            -(-v1 // v1_bm) * -(-co // v1_bn)


def test_plan_narrow_only_where_w_fits():
    """A 3-channel input whose W would not fit the narrow kernel's shared
    memory takes a tile instead, and so does a narrow output."""
    plan = TC._fwd_plan(2, 50, 3, 2000, 16, torch.float32)
    assert plan["tile"] in TC._FWD_TILES
    plan = TC._fwd_plan(2, 50, 16, 1000, 3, torch.float32)
    assert plan["tile"] in TC._FWD_TILES


def test_vector_rule_follows_the_static_shape():
    x, _idx, w, _bias = _case(c=8, co=16)
    assert TC._vector_ok(x, w) == (True, True)
    assert TC._vector_ok(x.bfloat16(), w.bfloat16()) == (True, True)
    x, _idx, w, _bias = _case(c=4, co=12)
    assert TC._vector_ok(x, w) == (True, True)
    assert TC._vector_ok(x.bfloat16(), w.bfloat16()) == (False, False)
    x, _idx, w, _bias = _case(c=3, co=3)
    assert TC._vector_ok(x, w) == (False, False)


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    base = (-flat.data_ptr() // t.element_size()) % (16 // t.element_size())
    out = flat[base + 4 // t.element_size():][:t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.parametrize("name", ["x", "w"])
def test_check_rejects_misaligned_vector_input(name):
    """Where the static shape asks for 16-byte loads, x and W must start on
    a 16-byte boundary; a 3-channel x is read element by element and may
    start anywhere."""
    args = dict(zip(("x", "idx", "w", "bias"), _case()))
    TC._check_fwd(args["x"], args["idx"], args["w"], args["bias"])
    args[name] = _misaligned(args[name])
    with pytest.raises(ValueError, match="16-byte aligned"):
        TC._check_fwd(args["x"], args["idx"], args["w"], args["bias"])
    x, idx, w, bias = _case(c=3, co=3)
    TC._check_fwd(_misaligned(x), idx, _misaligned(w), bias)


@pytest.mark.parametrize("fault,error", [
    ("spiral_int64", TypeError), ("x_float64", TypeError),
    ("w_dtype", TypeError), ("x_strided", ValueError),
    ("w_rows", ValueError), ("smem", ValueError), ("offsets", ValueError)])
def test_check_rejects(fault, error):
    x, idx, w, bias = _case()
    if fault == "spiral_int64":
        idx = idx.long()
    elif fault == "x_float64":
        x, w = x.double(), w.double()
    elif fault == "w_dtype":
        w = w.bfloat16()
    elif fault == "x_strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "w_rows":
        w = w[:-1].contiguous()
    elif fault == "smem":
        # the [S, BM] offset table alone outgrows shared memory
        x, idx, w, bias = _case(v1=40, s=1000, c=8, co=16)
    elif fault == "offsets":
        # 2^31 elements: the kernel's offsets are 32-bit
        x = torch.empty((2 ** 16, 2 ** 13, 4), device="meta")
        idx = torch.empty((2 ** 13, 6), dtype=torch.int32, device="meta")
        w = torch.empty((24, 16), device="meta")
        bias = torch.empty((16,), device="meta")
    with pytest.raises(error):
        TC._check_fwd(x, idx, w, bias)


@pytest.mark.parametrize("activation", sorted(TC.ACTIVATIONS))
def test_v1_wrapper_takes_plain_on_cpu(activation):
    """On a CPU tensor the forward wrapper is the plain version and
    launches nothing."""
    x, idx, w, bias = _case(b=3, v1=50, s=9, c=3, co=3, seed=1)
    before = TC.spiral_conv.launches
    ref = TC.spiral_conv_plain(x, idx, w, bias, activation)
    assert torch.equal(TC._forward(x, idx, w, bias, activation), ref)
    assert TC.spiral_conv.launches == before


@pytest.mark.parametrize("b,halves", [(1, ("dx",)), (12, ("dx",)),
                                      (16, ("dx",)), (17, ()), (384, ())])
def test_dx_goes_unfused_at_small_batch(b, halves):
    """On the card dx takes the unfused route at batch <= 16, whatever the
    shape; the table's own entry is kept once; the CPU names nothing."""
    x = torch.empty((b, 1724, 32), device="meta")
    w = torch.empty((8 * 32, 64), device="meta")
    idx = torch.empty((1724, 8), dtype=torch.int32, device="meta")
    assert TC._unfused_halves(x, w, idx) == halves
    x = torch.empty((b, 863, 64), device="meta")
    w = torch.empty((8 * 64, 128), device="meta")
    idx = torch.empty((863, 8), dtype=torch.int32, device="meta")
    assert TC._unfused_halves(x, w, idx) == ("dx",)
    assert TC._unfused_halves(torch.zeros((b, 5, 2)), torch.zeros((4, 3)),
                              torch.zeros((5, 2), dtype=torch.int32)) == ()


def test_forced_tile_plans():
    """A forced tile keeps its own rows and channels; a narrow kernel that
    holds fewer outputs than Co is refused."""
    for tile, (bm, bn, nt, mb) in TC._FWD_TILES.items():
        plan = TC._fwd_plan(3, 301, 40, 7, 72, torch.float32, tile=tile)
        assert (plan["tile"], plan["bm"], plan["bn"], plan["threads"],
                plan["mb"]) == (tile, bm, bn, nt, mb)
        assert plan["smem"] == _kernel_smem(tile, 7, torch.float32)
    x, idx, w, bias = _case(co=16)
    assert TC._check_fwd(x, idx, w, bias, tile=8)["bn"] == 16
    with pytest.raises(ValueError, match="narrow kernel 7"):
        TC._check_fwd(x, idx, w, bias, tile=7)


def test_tile_table_matches_the_source():
    """`_FWD_TILES` and `_FWD_NARROW` are the instances of
    csrc/spiral_conv_fwd.cu's dispatch: rows, channels, threads (BM/TM x
    BN/TN) and blocks an SM, and the narrow kernels' outputs (4 NQ)."""
    src = (Path(TC.__file__).resolve().parents[1] / "csrc"
           / "spiral_conv_fwd.cu").read_text()
    tiles = {int(t): (bm, bn, bm // tm * (bn // tn), mb)
             for t, bm, bn, tm, tn, mb in (
                 (t, *map(int, rest)) for t, *rest in re.findall(
                     r"case (\d+): SH_TILE\((\d+), (\d+), (\d+), (\d+), "
                     r"(\d+)\)", src))}
    narrow = {int(t): 4 * int(nq) for t, nq in re.findall(
        r"case (\d+):\s+return narrow_launch<T, (\d+)>", src)}
    assert tiles == TC._FWD_TILES
    assert narrow == TC._FWD_NARROW
