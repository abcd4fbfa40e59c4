"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

On a host without a card every test skips; chip_smoke.py holds the kernels
at the full serving and training shapes.
"""

import importlib

import numpy as np
import pytest
import torch

# the module: `semantichuman_torch.ops.spiral_conv` is the function
TC = importlib.import_module("semantichuman_torch.ops.spiral_conv")


# (b, v1, s, c, co): small and ragged shapes, then a coarse and the last
# full-width serving conv
SHAPES = [(2, 40, 6, 8, 16), (3, 50, 9, 3, 3), (4, 863, 8, 64, 128),
          (2, 6893, 15, 16, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(shape, device, seed=3):
    b, v1, s, c, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0
    idx = rng.integers(0, v1, (v1, s)).astype(np.int32)
    idx[-1] = v1 - 1
    w = (rng.standard_normal((s * c, co)) / np.sqrt(s * c)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, idx, w, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("activation",
                         ["elu", "relu", "leaky_relu", "sigmoid", "tanh",
                          "identity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_spiral_conv_kernel_matches_plain(cuda, shape, dtype, activation):
    """Same products, f32 sums in another order (rtol 1e-4, atol 1e-5);
    the dummy row is exactly zero and each call is one counted launch."""
    args = _case(shape, cuda)
    before = TC.spiral_conv.launches
    got = TC.spiral_conv(*args, activation, compute_dtype=dtype)
    ref = TC.spiral_conv_plain(*args, activation, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert TC.spiral_conv.launches == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    assert torch.count_nonzero(got[:, -1]) == 0


@pytest.mark.cuda
def test_spiral_conv_kernel_rejects_bad_input(cuda):
    x, idx, w, bias = _case(SHAPES[0], cuda)
    with pytest.raises(TypeError):
        TC.spiral_conv(x, idx.long(), w, bias)
    with pytest.raises(ValueError):
        TC.spiral_conv(x, idx, w, bias.cpu())


# --- the training kernels ------------------------------------------------------

def _spiral_with_pads(v1, s, rng):
    """A random spiral table whose pads (a fifth of the entries, and the
    whole dummy spiral) point at the dummy row, which becomes long."""
    idx = rng.integers(0, v1 - 1, (v1, s)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.2] = v1 - 1
    idx[-1] = v1 - 1
    return idx


def _csr(idx, device):
    from semantichuman_torch.models.tables import inverse_spiral_csr
    from semantichuman_torch.ops.csr_reduce import CSRTable
    return CSRTable.build(*inverse_spiral_csr(idx), n_src=idx.size,
                          device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v1,s,c", [(2, 40, 6, 3), (3, 500, 9, 16),
                                      (4, 6893, 15, 32), (2, 863, 8, 160)])
def test_csr_reduce_kernel_matches_plain(cuda, b, v1, s, c):
    """f32 sums of the same rows in another order: max |err| <= 1e-5 of
    the largest entry; one counted launch."""
    from semantichuman_torch.ops import csr_reduce as TR
    rng = np.random.default_rng(v1)
    idx = _spiral_with_pads(v1, s, rng)
    table = _csr(idx, cuda)
    assert table.long_rows.numel() >= (1 if v1 * s // 5 > TR.LONG_ROW else 0)
    g = torch.from_numpy(rng.standard_normal((b, v1 * s, c)).astype(
        np.float32)).to(cuda)
    before = TR.csr_reduce.launches
    got = TR.csr_reduce(g, table)
    ref = TR.csr_reduce_plain(g, table)
    torch.cuda.synchronize()
    assert TR.csr_reduce.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("activation",
                         ["elu", "relu", "leaky_relu", "sigmoid", "tanh",
                          "identity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_spiral_conv_backward_matches_plain(cuda, shape, dtype, activation):
    """A CUDA spiral_conv output carries a gradient, and its x, W and bias
    gradients (csr_reduce for dx) equal autograd of the plain conv run in
    f32 on the same compute-type values, rounded like the kernel route's:
    f32 to 1e-5 of the largest entry (sums in another order), bf16 to that
    and one bf16 rounding (rtol 2^-7)."""
    b, v1, s, c, co = shape
    rng = np.random.default_rng(7)
    x, _idx, w, bias = _case(shape, cuda)
    idx = torch.from_numpy(_spiral_with_pads(v1, s, rng)).to(cuda)
    table = _csr(idx.cpu().numpy(), cuda)
    dy = torch.from_numpy(rng.standard_normal((b, v1, co)).astype(
        np.float32)).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    cd = None if dtype == torch.float32 else dtype
    y = TC.spiral_conv(leaves[0], idx, leaves[1], leaves[2], activation,
                       compute_dtype=cd, csr=table)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    ref_in = [x.to(dtype).float().requires_grad_(True),
              w.to(dtype).float().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    y_ref = TC.spiral_conv_plain(ref_in[0], idx, ref_in[1], ref_in[2],
                                 activation)
    ref = list(torch.autograd.grad(y_ref, ref_in, dy))
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32
        if cd is None or i == 2:
            torch.testing.assert_close(g, r, rtol=0,
                                       atol=1e-5 * float(r.abs().max()))
        else:
            torch.testing.assert_close(g, r.to(cd).float(), rtol=2 ** -7,
                                       atol=1e-5 * float(r.abs().max()))


def _part_case(n_reals, n_pad, batch, device, seed=0, spread=False):
    """Random tiles; with `spread` the reconstruction sits away from the
    origin, as early training's does, where its Gram sums cancel more."""
    rng = np.random.default_rng(seed)
    p = len(n_reals)
    vp = rng.uniform(-0.5, 0.5, (p * batch, n_pad, 3)).astype(np.float32)
    rp = (vp + rng.normal(0, 0.02, vp.shape)).astype(np.float32)
    if spread:
        rp = (0.2 * vp + rng.normal(0, 0.05, vp.shape) + 0.4).astype(
            np.float32)
    bone = rng.normal(0, 0.3, (p * batch, 3)).astype(np.float32)
    a = rng.uniform(0.8, 1.2, (p, batch)).astype(np.float32)
    n_real = np.asarray(n_reals, np.int32)
    allone = (np.arange(p) % 3 == 1).astype(np.int32)
    return [torch.from_numpy(t).to(device)
            for t in (vp, rp, bone, a, n_real, allone)]


# (n_reals, n_pad, batch, spread): ragged parts; the step's bucket, also
# with a spread reconstruction (many pairs' two Gram orders round
# otherwise); a tile of 1100 rows; one tile (G = 1); n_real 1, 2, odd and
# even; the Trainer's grid (17 parts x B = 4 = 68); 192 tiles of 408 rows
# (a grid large enough for 4 warps a block, `_rows_warps`)
PART_CASES = [((40, 33, 17), 40, 3, False), ((406, 405), 408, 4, False),
              ((406, 405), 408, 96, False),
              ((406, 405), 408, 4, True), ((1100,), 1104, 1, False),
              ((408,), 408, 1, False), ((1, 2, 7, 8), 8, 2, False),
              ((406, 405, 408) * 5 + (405, 406), 408, 4, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("w_mode,relat", [("threshold", True),
                                          ("linear", False), ("sin", True),
                                          ("all_one", True)])
@pytest.mark.parametrize("n_reals,n_pad,batch,spread", PART_CASES)
def test_part_dist_kernels_match_plain(cuda, n_reals, n_pad, batch, spread,
                                       w_mode, relat):
    """The three part_dist kernels (fwd, fwd_grad, bwd) against their
    plain versions, which round every per-pair value alike: counts equal,
    term sums rtol 1e-5 and gradients to 1e-4 of the largest entry (sums
    in another order).  One counted launch each; two runs bit-equal."""
    from semantichuman_torch.ops import part_dist as TP
    args = _part_case(n_reals, n_pad, batch, cuda, spread=spread) \
        + [w_mode, 0.8, relat]
    ct = torch.linspace(0.5, 1.5, args[0].shape[0], device=cuda)
    before = dict(TP.part_dist_sums.launches)
    sums = TP._launch("fwd", *args)
    sums2, g0 = TP.part_dist_call("fwd_grad", *args)
    drp = TP.part_dist_call("bwd", *args, ct=ct)
    again = TP.part_dist_call("fwd_grad", *args)
    ref_sums, ref_g0 = TP.part_dist_plain(*args, mode="fwd_grad")
    ref_drp = TP.part_dist_plain(*args, mode="bwd", ct=ct)
    torch.cuda.synchronize()
    for mode, extra in (("fwd", 1), ("fwd_grad", 2), ("bwd", 1)):
        assert TP.part_dist_sums.launches[mode] == before[mode] + extra
    for s in (sums, sums2):
        torch.testing.assert_close(s[:, 0], ref_sums[:, 0], rtol=1e-5,
                                   atol=0)
        assert torch.equal(s[:, 1], ref_sums[:, 1])
    for g, r in ((g0, ref_g0), (drp, ref_drp)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))
    assert torch.equal(again[0], sums2) and torch.equal(again[1], g0)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.05, 0.3, 0.5, 0.95])
def test_part_dist_band_keeps_the_counts(cuda, thr):
    """Threshold mode at other thresholds than the step's: the kernel's
    acos band zeroes exactly the weights the plain version zeroes (counts
    equal), and its sums and gradient agree as in
    test_part_dist_kernels_match_plain."""
    from semantichuman_torch.ops import part_dist as TP
    args = _part_case((406, 405), 408, 4, cuda, seed=1) \
        + ["threshold", thr, True]
    sums, g0 = TP.part_dist_call("fwd_grad", *args)
    ref_sums, ref_g0 = TP.part_dist_plain(*args, mode="fwd_grad")
    torch.cuda.synchronize()
    assert torch.equal(sums[:, 1], ref_sums[:, 1])
    torch.testing.assert_close(sums[:, 0], ref_sums[:, 0], rtol=1e-5, atol=0)
    torch.testing.assert_close(g0, ref_g0, rtol=0,
                               atol=1e-4 * float(ref_g0.abs().max()))


@pytest.mark.cuda
def test_part_dist_autograd_routes_agree(cuda):
    """The one-pass and two-kernel VJPs of part_dist_sums and autograd of
    part_dist_sums_plain give one gradient (to 1e-4 of its largest entry:
    autograd adds each pair's two symmetric terms separately); without a
    gradient only the fwd kernel runs."""
    from semantichuman_torch.ops import part_dist as TP
    vp, rp, bone, a, n_real, allone = _part_case((406, 405), 408, 2, cuda)
    consts = ("threshold", 0.8, True)
    ct = torch.linspace(0.5, 1.5, vp.shape[0], device=cuda)
    grads = []
    for fn, kw in ((TP.part_dist_sums, {"one_pass": True}),
                   (TP.part_dist_sums, {"one_pass": False}),
                   (TP.part_dist_sums_plain, {})):
        r = rp.clone().requires_grad_(True)
        (fn(vp, r, bone, a, n_real, allone, *consts, **kw)[:, 0]
         * ct).sum().backward()
        grads.append(r.grad)
    for g in grads[1:]:
        torch.testing.assert_close(g, grads[0], rtol=0,
                                   atol=1e-4 * float(grads[0].abs().max()))
    before = dict(TP.part_dist_sums.launches)
    with torch.no_grad():
        TP.part_dist_sums(vp, rp, bone, a, n_real, allone, *consts)
    assert TP.part_dist_sums.launches["fwd"] == before["fwd"] + 1
    assert TP.part_dist_sums.launches["fwd_grad"] == before["fwd_grad"]


# --- the banded gather (rows 5, 6) and the row gather (row 7) ------------------

TOPOLOGY = "assets/topology_synth_full_2222.npz"


def _local_table(n, s, spread, rng, far_frac=0.02):
    """A local index table with dummy pads and a few far entries (the
    out-of-band fix-ups); the dummy is row n - 1."""
    tbl = np.clip(np.arange(n)[:, None] + rng.integers(-spread, spread,
                                                       (n, s)), 0, n - 1)
    tbl[rng.uniform(size=(n, s)) < 0.3] = n - 1
    far = rng.uniform(size=(n, s)) < far_frac
    tbl[far] = rng.integers(0, n, far.sum())
    return tbl.astype(np.int32)


def _small_band(device, weighted=False, seed=0):
    from semantichuman_torch.ops import banding
    from semantichuman_torch.ops.banded_gather import BandTable
    rng = np.random.default_rng(seed)
    n, s = 600, 9
    tbl = _local_table(n, s, 150, rng)
    spec = banding.pick_band_spec(tbl, presets=((128, 384),), max_oob=1.0,
                                  dummy=n - 1)
    weights = rng.uniform(size=n * s).astype(np.float32) if weighted else None
    return BandTable.build(spec, device, weights)


@pytest.fixture(scope="module")
def full_bands():
    """The trainer's band tables at full width: conv levels 0-1 and the
    four unpool transitions of the bundled topology, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.topology import MeshHierarchy
    t = device_tables(MeshHierarchy.load(TOPOLOGY), "cuda", banded=True)
    bands = {f"conv{lvl}": b for lvl, b in enumerate(t.bands)
             if b is not None}
    bands.update({f"unpool{lvl}": b for lvl, b in enumerate(t.unpool_bands)
                  if b is not None})
    assert sorted(bands) == ["conv0", "conv1", "unpool0", "unpool1",
                             "unpool2", "unpool3"]
    return bands


# channels C of every banded call of the default model's step: the conv
# inputs at levels 0-1 and the unpool inputs into levels 0-3
TRAINER_WIDTHS = {"conv0": (3, 32, 16), "conv1": (16, 32),
                  "unpool0": (32,), "unpool1": (32,), "unpool2": (64,),
                  "unpool3": (128,)}


def _band_cases(full_bands, cuda):
    """(label, table, row width M = B*C) at the trainer's widths (trunk
    batch 12) and a small table with odd widths."""
    small, weighted = _small_band(cuda), _small_band(cuda, weighted=True)
    cases = [("small", small, 24), ("small-odd", small, 7),
             ("small-w", weighted, 20), ("small-w-odd", weighted, 5)]
    for name, table in full_bands.items():
        for c in TRAINER_WIDTHS[name]:
            cases.append((name, table, 12 * c))
    return cases


def _xp(table, m, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((table.n_src, m), generator=gen, device=device)
    x[-1] = 0.0                                  # the zero dummy source row
    return x.to(dtype)


@pytest.mark.cuda
def test_banded_gather_fwd_matches_plain(cuda, full_bands):
    """Row 5: unweighted (f32 and bf16) a copy, bit-equal to the plain
    version; weighted (f32) one product per element, rtol 1e-6.  One
    counted launch per call."""
    from semantichuman_torch.ops import banded_gather as BG
    for label, table, m in _band_cases(full_bands, cuda):
        dtypes = ((torch.float32,) if table.weighted
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            xp = _xp(table, m, dtype, cuda)
            before = BG.banded_gather_fwd.launches
            got = BG.banded_gather_fwd(xp, table)
            ref = BG.banded_gather_fwd_plain(xp, table)
            torch.cuda.synchronize()
            assert BG.banded_gather_fwd.launches == before + 1
            assert got.dtype == dtype and got.shape == (table.n_rows, m)
            if table.weighted:
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=0,
                                           msg=lambda s: f"{label}: {s}")
            else:
                assert torch.equal(got, ref), f"{label} {dtype}"


@pytest.mark.cuda
def test_banded_gather_bwd_matches_plain_and_repeats(cuda, full_bands):
    """Row 6: the transpose against index_add_ of the plain version, to
    1e-5 of the largest entry with the dummy row zeroed (sums in another
    order; the dummy row collects every in-band pad); two runs bit-equal
    (fixed order, no atomics)."""
    from semantichuman_torch.ops import banded_gather as BG
    for label, table, m in _band_cases(full_bands, cuda):
        gen = torch.Generator(device=cuda).manual_seed(1)
        ct = torch.randn((table.n_rows, m), generator=gen, device=cuda)
        before = BG.banded_gather_bwd.launches
        got = BG.banded_gather_bwd(ct, table)
        again = BG.banded_gather_bwd(ct, table)
        ref = BG.banded_gather_bwd_plain(ct, table)
        torch.cuda.synchronize()
        assert BG.banded_gather_bwd.launches == before + 2
        assert torch.equal(got, again), label
        got[-1] = 0
        ref[-1] = 0
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()),
                                   msg=lambda s: f"{label}: {s}")


@pytest.mark.cuda
def test_banded_gather_fn_gradient(cuda, full_bands):
    """BandedGatherFn's gradient on the card equals autograd of the plain
    forward (1e-5 of the largest entry, dummy row zeroed), and the weights
    get none."""
    from semantichuman_torch.ops import banded_gather as BG
    for label in ("conv0", "unpool0"):
        table = full_bands[label]
        xp = _xp(table, 12 * 16, torch.float32, cuda).requires_grad_(True)
        gen = torch.Generator(device=cuda).manual_seed(2)
        ct = torch.randn((table.n_rows, 12 * 16), generator=gen, device=cuda)
        (got,) = torch.autograd.grad(BG.BandedGatherFn.apply(xp, table), xp,
                                     ct)
        (ref,) = torch.autograd.grad(BG.banded_gather_fwd_plain(xp, table),
                                     xp, ct)
        torch.cuda.synchronize()
        got[-1] = 0
        ref[-1] = 0
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_src,d,n_out", [(300, 24, 64), (6893, 192, 2368),
                                           (3447, 384, 904), (50, 3, 7),
                                           (1724, 192, 208)])
def test_row_gather_matches_index_select(cuda, n_src, d, n_out, dtype):
    """Row 7 copies rows: bit-equal to index_select, one counted launch;
    its gradient (csr_reduce over the inverse index) equals index_add_'s
    to 1e-6 of the largest entry."""
    from semantichuman_torch.ops import row_gather as RG
    rng = np.random.default_rng(n_src)
    idx = rng.integers(0, n_src, n_out)
    idx[:3] = idx[3]                                    # repeated rows
    table = RG.GatherTable.build(idx, n_src, cuda)
    x = torch.from_numpy(rng.standard_normal((n_src, d)).astype(
        np.float32)).to(cuda).to(dtype)
    before = RG.row_gather.launches
    got = RG.row_gather(x, table.idx)
    torch.cuda.synchronize()
    assert RG.row_gather.launches == before + 1
    assert torch.equal(got, x.index_select(0, table.idx.long()))
    if dtype != torch.float32:
        return
    xg = x.clone().requires_grad_(True)
    ct = torch.from_numpy(rng.standard_normal((n_out, d)).astype(
        np.float32)).to(cuda)
    (dx,) = torch.autograd.grad(RG.RowGatherFn.apply(xg, table), xg, ct)
    ref = torch.zeros_like(x).index_add_(0, table.idx.long(), ct)
    torch.testing.assert_close(dx, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_routes_match_take(cuda, full_bands, dtype, monkeypatch):
    """With the gates forced open to the JAX package's (16 and 128; the
    card's measurements closed both), spiral_conv at B <= 16 on a banded
    level and unpool on a banded transition launch rows 5-7 and give the
    take route's values (f32 1e-5, bf16 inputs the same gathered values,
    so the same tolerance) and x/W/b gradients (1e-5 of the largest
    entry, dummy row zeroed)."""
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.ops import banded_gather as BG
    from semantichuman_torch.ops import row_gather as RG
    from semantichuman_torch.ops import sampling as SA
    from semantichuman_torch.topology import MeshHierarchy
    monkeypatch.setattr(TC, "_BANDED_MAX_B", 16)
    monkeypatch.setattr(SA, "_UNPOOL_BAND_MAX_B", 128)
    t = device_tables(MeshHierarchy.load(TOPOLOGY), "cuda")
    b, c, co = 12, 16, 32
    v1, s = t.spirals[0].shape
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((b, v1, c), generator=gen, device=cuda)
    x[:, -1] = 0
    w = torch.randn((s * c, co), generator=gen, device=cuda) / (s * c) ** 0.5
    bias = torch.randn((co,), generator=gen, device=cuda)
    dy = torch.randn((b, v1, co), generator=gen, device=cuda)
    cd = None if dtype == torch.float32 else dtype
    outs = []
    for band in (full_bands["conv0"], None):
        leaves = [a.clone().requires_grad_(True) for a in (x, w, bias)]
        counts = (BG.banded_gather_fwd.launches, RG.row_gather.launches)
        y = TC.spiral_conv(leaves[0], t.spirals[0], leaves[1], leaves[2],
                           "elu", compute_dtype=cd, csr=t.spiral_csr[0],
                           band=band)
        grads = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
        if band is not None:
            assert (BG.banded_gather_fwd.launches, RG.row_gather.launches) \
                == (counts[0] + 1, counts[1] + 1)
        outs.append((y, grads))
    (yb, gb), (yt, gt) = outs
    torch.testing.assert_close(yb, yt, rtol=0, atol=1e-5)
    for i, (g, r) in enumerate(zip(gb, gt)):
        g, r = g.clone(), r.clone()
        if g.dim() == 3:
            g[:, -1] = 0
            r[:, -1] = 0
        # x and W gradients of a bf16 conv are rounded to bf16 on both
        # routes: f32 sums in another order may round one ulp apart, and
        # the banded route adds dx's in-band and fix-up parts in bf16
        bf16 = cd is not None and i < 2
        torch.testing.assert_close(
            g, r, rtol=2 ** -7 if bf16 else 0,
            atol=(2 ** -7 if i == 0 and bf16 else 1e-5)
            * float(r.abs().max()))
    # unpool 0: fine level 0 from coarse level 1
    xc = torch.randn((b, t.sizes[1] + 1, c), generator=gen, device=cuda)
    xc[:, -1] = 0
    band = full_bands["unpool0"]
    res = []
    for fn in (lambda a: SA.unpool(a, t.unpool_gather[0], band=band),
               lambda a: SA.unpool_take(a, t.unpool_gather[0])):
        a = xc.clone().requires_grad_(True)
        y = fn(a)
        res.append((y, torch.autograd.grad(y, a, torch.ones_like(y))[0]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=1e-5)
    g, r = res[0][1].clone(), res[1][1].clone()
    g[:, -1] = 0
    r[:, -1] = 0
    torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 12, 16, 64, 128])
def test_default_routes_take_at_the_measured_batches(cuda, full_bands, b):
    """At every batch the gates were measured at on the card (serving 1,
    16, 64; the Trainer's trunk 12 and the fast recipe's 128) a banded
    level's conv and a banded unpool take the take route: no banded
    launch, the take route's kernels, its values bit for bit."""
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.ops import banded_gather as BG
    from semantichuman_torch.ops import row_gather as RG
    from semantichuman_torch.ops import sampling as SA
    from semantichuman_torch.topology import MeshHierarchy
    assert not TC._banded_ok(b, cuda) and not SA._unpool_band_ok(b, cuda)
    t = device_tables(MeshHierarchy.load(TOPOLOGY), "cuda")
    gen = torch.Generator(device=cuda).manual_seed(b)
    c, co = 3, 16
    v1, s = t.spirals[0].shape
    x = torch.randn((b, v1, c), generator=gen, device=cuda)
    x[:, -1] = 0
    w = torch.randn((s * c, co), generator=gen, device=cuda) / (s * c) ** 0.5
    bias = torch.randn((co,), generator=gen, device=cuda)
    xc = torch.randn((b, t.sizes[1] + 1, c), generator=gen, device=cuda)
    xc[:, -1] = 0
    before = (BG.banded_gather_fwd.launches, TC.spiral_conv.launches,
              RG.row_gather.launches)
    y = TC.spiral_conv(x, t.spirals[0], w, bias, "elu",
                       band=full_bands["conv0"])
    u = SA.unpool(xc, t.unpool_gather[0], band=full_bands["unpool0"])
    torch.cuda.synchronize()
    assert (BG.banded_gather_fwd.launches, TC.spiral_conv.launches,
            RG.row_gather.launches) == (before[0], before[1] + 1,
                                        before[2] + 1)
    assert torch.equal(y, TC.spiral_conv(x, t.spirals[0], w, bias, "elu"))
    assert torch.equal(u, SA.unpool_take(xc, t.unpool_gather[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_to_device_matches_inline(cuda, size):
    """The threaded pipeline (pinned batches, non_blocking copies on a
    side stream) yields exactly the inline batches, in order.  The
    consumer reads each batch on a stream of its own right after it
    arrives: its stream waits on the copy's event, so it reads the
    copied values, never memory the copy has not reached."""
    from semantichuman_torch.data import dataset as TD

    rng = np.random.default_rng(0)
    verts = rng.standard_normal((96, 6892, 3)).astype(np.float32)
    meas = rng.standard_normal((96, 32)).astype(np.float32)

    def batches():
        return iter(TD.BatchLoader(TD.ArraySource(verts, meas), 16,
                                   shuffle=True, seed=5))

    inline = list(TD.prefetch_to_device(batches(), cuda, size=0))
    consumer = torch.cuda.Stream()
    got = []
    with torch.cuda.stream(consumer):
        for batch in TD.prefetch_to_device(batches(), cuda, size=size):
            assert batch["verts"].is_cuda and batch["measure"].is_cuda
            # read on the consumer's stream at once: a doubled copy
            got.append({k: batch[k] * 2 for k in ("verts", "measure")}
                       | {"idx": batch["idx"]})
    consumer.synchronize()
    assert len(got) == len(inline) == 6
    for a, b in zip(inline, got):
        np.testing.assert_array_equal(a["idx"], b["idx"])
        for k in ("verts", "measure"):
            assert torch.equal(a[k] * 2, b[k])


@pytest.mark.cuda
def test_banded_kernels_reject_bad_input(cuda):
    from semantichuman_torch.ops import banded_gather as BG
    from semantichuman_torch.ops import row_gather as RG
    table = _small_band(cuda)
    weighted = _small_band(cuda, weighted=True)
    xp = _xp(table, 24, torch.float32, cuda)
    with pytest.raises(TypeError):
        BG.banded_gather_fwd(xp.double(), table)
    with pytest.raises(TypeError):
        BG.banded_gather_fwd(xp.bfloat16(), weighted)
    with pytest.raises(ValueError):
        BG.banded_gather_fwd(xp[:-1].contiguous(), table)
    with pytest.raises(ValueError):
        BG.banded_gather_fwd(xp, _small_band("cpu"))
    with pytest.raises(ValueError):
        BG.banded_gather_bwd(torch.zeros((5, 24), device=cuda), table)
    gt = RG.GatherTable.build(np.array([0, 3, 3]), 10, cuda)
    x = torch.zeros((10, 8), device=cuda)
    with pytest.raises(TypeError):
        RG.row_gather(x, gt.idx.long())
    with pytest.raises(ValueError):
        RG.row_gather(x, gt.idx.cpu())
    with pytest.raises(ValueError):
        RG.row_gather(x.t(), gt.idx)


@pytest.mark.cuda
def test_training_kernels_reject_bad_input(cuda):
    from semantichuman_torch.ops import csr_reduce as TR
    from semantichuman_torch.ops import part_dist as TP
    idx = _spiral_with_pads(40, 6, np.random.default_rng(0))
    table = _csr(idx, cuda)
    with pytest.raises(ValueError):
        TR.csr_reduce(torch.zeros((2, 240, 3), device=cuda).double(), table)
    with pytest.raises(ValueError):
        TR.csr_reduce(torch.zeros((2, 239, 3), device=cuda), table)
    vp, rp, bone, a, n_real, allone = _part_case((8,), 8, 2, cuda)
    with pytest.raises(ValueError):
        TP.part_dist_call("fwd", vp, rp, bone, a, n_real.long(), allone,
                          "threshold", 0.8, True)
    with pytest.raises(ValueError):
        TP.part_dist_call("fwd", vp, rp[:, :4].contiguous(), bone, a, n_real,
                          allone, "threshold", 0.8, True)


# --- the fused conv backward (spiral_conv_bwd_dw, spiral_conv_bwd_dx) --------

# (level, C, Co) of the default model's nine convs, in forward order
MODEL_CONVS = [(0, 3, 16), (1, 16, 32), (2, 32, 64), (3, 64, 128),
               (3, 128, 64), (2, 64, 32), (1, 32, 32), (0, 32, 16),
               (0, 16, 3)]
# (v1, s, c, co) random tables off every tile size, with a long dummy row
RAGGED = [(501, 9, 5, 7), (333, 7, 24, 40), (130, 6, 132, 12)]


@pytest.fixture(scope="module")
def full_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.topology import MeshHierarchy
    return device_tables(MeshHierarchy.load(TOPOLOGY), "cuda")


def _bwd_inputs(b, v1, s, c, co, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, v1, c), generator=gen, device=device)
    x[:, -1] = 0.0
    w = torch.randn((s * c, co), generator=gen, device=device) / (s * c) ** 0.5
    dy = torch.randn((b, v1, co), generator=gen, device=device)
    dy[:, -1] = 0.0
    return x.to(dtype), w.to(dtype), dy


def _bwd_cases(full_tables, cuda):
    """(label, batch, spiral table, inverse table, C, Co)."""
    cases = []
    for lvl, c, co in MODEL_CONVS:
        batches = (3, 37) if lvl >= 2 else (3,)
        for b in batches:
            cases.append((f"L{lvl} {c}->{co} B={b}", b,
                          full_tables.spirals[lvl],
                          full_tables.spiral_csr[lvl], c, co))
    for b in (1, 5):
        for lvl, c, co in ((1, 32, 32), (0, 16, 3)):
            cases.append((f"L{lvl} {c}->{co} B={b}", b,
                          full_tables.spirals[lvl],
                          full_tables.spiral_csr[lvl], c, co))
    rng = np.random.default_rng(11)
    for v1, s, c, co in RAGGED:
        idx = _spiral_with_pads(v1, s, rng)
        for b in (1, 5):
            cases.append((f"ragged {v1}x{s} {c}->{co} B={b}", b,
                          torch.from_numpy(idx).to(cuda), _csr(idx, cuda),
                          c, co))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_bwd_dw_matches_plain(cuda, full_tables, dtype):
    """The dW kernel against its plain version at the nine full-width conv
    shapes and at ragged sizes: the same products (bf16 inputs are exact
    in f32), f32 sums in another order, max |err| <= 1e-4 of the largest
    entry; two runs bit-equal; one counted launch a call."""
    for i, (label, b, spiral, _csr_t, c, co) in enumerate(
            _bwd_cases(full_tables, cuda)):
        v1, s = spiral.shape
        x, _w, dy = _bwd_inputs(b, v1, s, c, co, dtype, cuda, i)
        before = TC.spiral_conv_bwd_dw.launches
        got = TC.spiral_conv_bwd_dw(x, spiral, dy)
        again = TC.spiral_conv_bwd_dw(x, spiral, dy)
        ref = TC.spiral_conv_bwd_dw_plain(x, spiral, dy)
        torch.cuda.synchronize()
        assert TC.spiral_conv_bwd_dw.launches == before + 2
        assert got.dtype == torch.float32 and got.shape == (s * c, co)
        assert torch.equal(got, again), label
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m: f"{label}: {m}")


def _permuted_level(spiral, seed):
    """The level's table with its vertices in a random order (the dummy
    row stays last): the same spirals, with no locality for a window."""
    sp = spiral.cpu().numpy()
    v = sp.shape[0] - 1
    perm = np.append(np.random.default_rng(seed).permutation(v), v)
    out = np.empty_like(sp)
    out[perm] = perm[sp]
    return torch.from_numpy(out).to(spiral.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 12, 128])
def test_spiral_conv_bwd_dw_window_at_model_convs(cuda, full_tables, b,
                                                  dtype):
    """The dW kernel through the tables' window plans at the nine convs,
    and on the level-0 and level-3 tables with their vertices permuted
    (little reuse): against the plain version, max |err| <= 1e-4 of the
    largest entry as above; two runs bit-equal."""
    cases = [(f"L{lvl} {c}->{co}", full_tables.spirals[lvl], c, co)
             for lvl, c, co in MODEL_CONVS]
    for lvl, c, co in ((0, 32, 16), (3, 128, 64)):
        cases.append((f"L{lvl} permuted {c}->{co}",
                      _permuted_level(full_tables.spirals[lvl], lvl), c, co))
    for i, (label, spiral, c, co) in enumerate(cases):
        v1, s = spiral.shape
        x, _w, dy = _bwd_inputs(b, v1, s, c, co, dtype, cuda, 300 + i)
        got = TC.spiral_conv_bwd_dw(x, spiral, dy)
        again = TC.spiral_conv_bwd_dw(x, spiral, dy)
        ref = TC.spiral_conv_bwd_dw_plain(x, spiral, dy)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{label} B={b}"
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m: f"{label} B={b}: {m}")
        del x, dy, ref


@pytest.mark.cuda
def test_spiral_conv_bwd_dw_launches_two_kernels_and_counts(cuda,
                                                            full_tables):
    """A fused dW call is one `dw_partial_kernel` and one `dw_finish_kernel`
    on the device and nothing else, and the conv backward records it in
    `spiral_conv_dw` with the launch plan's rows and entries."""
    from torch.profiler import ProfilerActivity, profile

    from semantichuman_torch.ops import launches
    from semantichuman_torch.ops.dw_window import window_of
    lvl, c, co, b = 0, 32, 16, 16
    spiral = full_tables.spirals[lvl]
    v1, s = spiral.shape
    x, w, dy = _bwd_inputs(b, v1, s, c, co, torch.float32, cuda, 9)
    TC.spiral_conv_bwd_dw(x, spiral, dy)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TC.spiral_conv_bwd_dw(x, spiral, dy)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert "dw_partial_kernel" in kernels[0], kernels
    assert "dw_finish_kernel" in kernels[1], kernels
    before = launches.read()
    TC._conv_backward(x, w, dy, spiral, full_tables.spiral_csr[lvl], False,
                      True)
    got = {k: n for k, n in launches.diff(launches.read(), before)[
        "spiral_conv_dw"].items() if n["calls"]}
    plan = window_of(spiral).launch_plan(b, c, co, torch.float32)
    assert got == {f"{b},{v1},{s},{c},{co}:{plan['t']}": {
        "calls": 1, "rows": plan["rows"], "entries": plan["entries"]}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_bwd_dx_matches_plain(cuda, full_tables, dtype):
    """The dx kernel against its plain version, dummy row included, at the
    same shapes: max |err| <= 1e-4 of the largest entry (the dummy row
    sums 34,041 entries at level 0); two runs bit-equal; one counted
    launch a call."""
    for i, (label, b, spiral, csr_t, c, co) in enumerate(
            _bwd_cases(full_tables, cuda)):
        v1, s = spiral.shape
        _x, w, dy = _bwd_inputs(b, v1, s, c, co, dtype, cuda, 100 + i)
        before = TC.spiral_conv_bwd_dx.launches
        got = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        again = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        ref = TC.spiral_conv_bwd_dx_plain(dy, w, csr_t, (v1, s))
        torch.cuda.synchronize()
        assert TC.spiral_conv_bwd_dx.launches == before + 2
        assert got.dtype == torch.float32 and got.shape == (b, v1, c)
        assert torch.equal(got, again), label
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m: f"{label}: {m}")
        real = ref[:, :-1].abs().max()
        torch.testing.assert_close(got[:, :-1], ref[:, :-1], rtol=0,
                                   atol=1e-4 * float(real),
                                   msg=lambda m: f"{label} real rows: {m}")


# (level, C, Co) of the convs whose dx the step computes fused, and the
# 64 -> 128 conv, which the dispatch sends unfused
DX_FUSED_CONVS = [(1, 16, 32), (2, 32, 64), (3, 128, 64), (2, 64, 32),
                  (1, 32, 32), (0, 32, 16), (0, 16, 3), (3, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [17, 128, 256])
def test_spiral_conv_bwd_dx_at_fused_convs(cuda, full_tables, b, dtype):
    """The dx kernels through the tables' short-row plans at every conv
    whose dx runs fused, and at 64 -> 128, at B = 17, 128 and 256: against
    the plain version, max |err| <= 1e-4 of the largest entry (and of the
    largest real row's); two runs bit-equal; one counted launch a call."""
    for i, (lvl, c, co) in enumerate(DX_FUSED_CONVS):
        spiral, csr_t = full_tables.spirals[lvl], full_tables.spiral_csr[lvl]
        v1, s = spiral.shape
        label = f"L{lvl} {c}->{co} B={b}"
        _x, w, dy = _bwd_inputs(b, v1, s, c, co, dtype, cuda, 400 + i)
        before = TC.spiral_conv_bwd_dx.launches
        got = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        again = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        ref = TC.spiral_conv_bwd_dx_plain(dy, w, csr_t, (v1, s))
        torch.cuda.synchronize()
        assert TC.spiral_conv_bwd_dx.launches == before + 2
        assert torch.equal(got, again), label
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m: f"{label}: {m}")
        real = ref[:, :-1].abs().max()
        torch.testing.assert_close(got[:, :-1], ref[:, :-1], rtol=0,
                                   atol=1e-4 * float(real),
                                   msg=lambda m: f"{label} real rows: {m}")
        del _x, w, dy, got, again, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_bwd_dx_every_instance(cuda, full_tables, dtype):
    """Each short-row instance (lanes along c 1, 2, 4, 8), reached through
    C = 8, 16, 32 and 40 at a level-1 conv, and a ragged random table
    whose Co = 7 takes the load path: against the plain version, max
    |err| <= 1e-4 of the largest entry; two runs bit-equal."""
    from semantichuman_torch.ops.dx_plan import dx_plan_of
    rng = np.random.default_rng(21)
    idx = _spiral_with_pads(333, 7, rng)
    cases = [(f"L1 {c}->24", full_tables.spirals[1],
              full_tables.spiral_csr[1], c, 24, 19, ntc)
             for c, ntc in ((8, 1), (16, 2), (32, 4), (40, 8))]
    cases.append(("ragged 333x7 12->7", torch.from_numpy(idx).to(cuda),
                  _csr(idx, cuda), 12, 7, 70, 2))
    for label, spiral, csr_t, c, co, b, ntc in cases:
        v1, s = spiral.shape
        assert dx_plan_of(csr_t).launch_plan(b, c, co)["ntc"] == ntc, label
        _x, w, dy = _bwd_inputs(b, v1, s, c, co, dtype, cuda, 7)
        ref = TC.spiral_conv_bwd_dx_plain(dy, w, csr_t, (v1, s))
        got = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        again = TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        torch.testing.assert_close(
            got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()),
            msg=lambda m: f"{label}: {m}")


@pytest.mark.cuda
def test_spiral_conv_bwd_dx_kernel_names_and_counter(cuda, full_tables):
    """A fused dx call at a level-0 conv launches, on the device, only
    kernels whose names hold one of the names that
    `conv_dx_roofline.*` reads (dx_short_kernel, dx_narrow_kernel,
    dx_long_partial_kernel, dx_long_finish_kernel): the short-row kernel
    once and the two long-row kernels for the dummy row; and the conv
    backward records the call in `spiral_conv_dx` as fused."""
    from torch.profiler import ProfilerActivity, profile

    from semantichuman_torch.ops import launches
    names = ("dx_short_kernel", "dx_narrow_kernel", "dx_long_partial_kernel",
             "dx_long_finish_kernel")
    lvl, c, co, b = 0, 32, 16, 128
    spiral, csr_t = full_tables.spirals[lvl], full_tables.spiral_csr[lvl]
    v1, s = spiral.shape
    x, w, dy = _bwd_inputs(b, v1, s, c, co, torch.float32, cuda, 11)
    TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s))
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and all(any(n in k for n in names) for k in kernels), \
        kernels
    assert sum("dx_short_kernel" in k for k in kernels) == 1, kernels
    assert sum("dx_long_" in k for k in kernels) == 2, kernels
    before = launches.read()
    TC._conv_backward(x, w, dy, spiral, csr_t, True, False)
    got = launches.diff(launches.read(), before)
    assert {k: v for k, v in got["spiral_conv_dx"].items() if v} == {
        f"fused:{b},{v1},{s},{c},{co}": 1}
    assert got["spiral_conv_bwd_dx"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_fused_backward_through_autograd(cuda, full_tables, dtype,
                                                     monkeypatch):
    """spiral_conv on the card carries a grad_fn whose backward launches
    both fused kernels for a shape the dispatch table does not name (the
    batch rule for dx lowered to let batch 4 through), and
    its x, W and bias gradients equal autograd of the plain conv (f32 to
    1e-4 of the largest entry, bf16 one rounding more)."""
    monkeypatch.setattr(TC, "_UNFUSED", {})
    monkeypatch.setattr(TC, "_DX_FUSED_MIN_B", 1)
    lvl, c, co = 1, 32, 32
    spiral, csr_t = full_tables.spirals[lvl], full_tables.spiral_csr[lvl]
    v1, s = spiral.shape
    x, w, dy = _bwd_inputs(4, v1, s, c, co, torch.float32, cuda, 5)
    bias = torch.linspace(-0.1, 0.1, co, device=cuda)
    cd = None if dtype == torch.float32 else dtype
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    before = (TC.spiral_conv_bwd_dx.launches, TC.spiral_conv_bwd_dw.launches)
    y = TC.spiral_conv(leaves[0], spiral, leaves[1], leaves[2], "elu",
                       compute_dtype=cd, csr=csr_t)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    assert (TC.spiral_conv_bwd_dx.launches,
            TC.spiral_conv_bwd_dw.launches) == (before[0] + 1, before[1] + 1)
    ref_in = [x.to(dtype).float().requires_grad_(True),
              w.to(dtype).float().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    y_ref = TC.spiral_conv_plain(ref_in[0], spiral, ref_in[1], ref_in[2],
                                 "elu")
    ref = torch.autograd.grad(y_ref, ref_in, dy)
    torch.cuda.synchronize()
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32
        bf16 = cd is not None and i < 2
        torch.testing.assert_close(
            g, r.to(cd).float() if bf16 else r, rtol=2 ** -7 if bf16 else 0,
            atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_spiral_conv_bwd_kernels_reject_bad_input(cuda, full_tables):
    spiral, csr_t = full_tables.spirals[3], full_tables.spiral_csr[3]
    v1, s = spiral.shape
    x, w, dy = _bwd_inputs(2, v1, s, 8, 16, torch.float32, cuda, 0)
    with pytest.raises(TypeError):
        TC.spiral_conv_bwd_dw(x.double(), spiral, dy)
    with pytest.raises(ValueError):
        TC.spiral_conv_bwd_dw(x.cpu(), spiral, dy)
    with pytest.raises(ValueError):
        TC.spiral_conv_bwd_dw(x, spiral[:-1].contiguous(), dy)
    with pytest.raises(TypeError):
        TC.spiral_conv_bwd_dx(dy, w.half(), csr_t, (v1, s))
    with pytest.raises(ValueError):
        TC.spiral_conv_bwd_dx(dy, w.cpu(), csr_t, (v1, s))
    with pytest.raises(ValueError):
        TC.spiral_conv_bwd_dx(dy, w, csr_t, (v1, s + 1))


# --- the forward kernel (csrc/spiral_conv_fwd.cu) ---------------------------

# (v1, s, c, co) random tables off every chunk and tile size: C = 5 (K = 35,
# element copies), C = 40 (a 32-channel slice and an 8-channel one), C = 12
# (bf16 element by element), C = 3 into 16 and 3 outputs, 7 and 130 outputs
FWD_RAGGED = [(501, 7, 5, 7), (333, 9, 40, 40), (130, 6, 12, 130),
              (77, 3, 3, 16), (50, 9, 3, 3), (257, 5, 64, 3)]


def _fwd_cases(full_tables, cuda):
    """(label, batch, spiral table, C, Co)."""
    cases = []
    for lvl, c, co in MODEL_CONVS:
        for b in (1, 5):
            cases.append((f"L{lvl} {c}->{co} B={b}", b,
                          full_tables.spirals[lvl], c, co))
    rng = np.random.default_rng(12)
    for v1, s, c, co in FWD_RAGGED:
        idx = torch.from_numpy(_spiral_with_pads(v1, s, rng)).to(cuda)
        for b in (1, 5):
            cases.append((f"ragged {v1}x{s} {c}->{co} B={b}", b, idx, c, co))
    return cases


def _fwd_inputs(b, v1, s, c, co, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, v1, c), generator=gen, device=device)
    x[:, -1] = 0.0
    w = torch.randn((s * c, co), generator=gen, device=device) / (s * c) ** 0.5
    bias = torch.randn((co,), generator=gen, device=device) * 0.1
    return x.to(dtype), w.to(dtype), bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_fwd_matches_plain(cuda, full_tables, dtype):
    """The forward kernel against its plain version at the nine full-width
    conv shapes and at ragged sizes, B = 1 and 5: the same products, f32
    sums in another order (rtol 1e-4, atol 1e-5); the dummy row exactly
    zero; two runs bit-equal; one counted launch a call."""
    for i, (label, b, spiral, c, co) in enumerate(_fwd_cases(full_tables,
                                                             cuda)):
        v1, s = spiral.shape
        x, w, bias = _fwd_inputs(b, v1, s, c, co, dtype, cuda, i)
        before = TC.spiral_conv.launches
        got = TC._forward(x, spiral, w, bias, "elu")
        again = TC._forward(x, spiral, w, bias, "elu")
        ref = TC.spiral_conv_plain(x, spiral, w, bias, "elu")
        torch.cuda.synchronize()
        assert TC.spiral_conv.launches == before + 2, label
        assert got.dtype == torch.float32 and got.shape == (b, v1, co)
        assert torch.equal(got, again), label
        assert torch.count_nonzero(got[:, -1]) == 0, label
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{label}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("activation",
                         ["elu", "relu", "leaky_relu", "sigmoid", "tanh",
                          "identity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_fwd_activations(cuda, dtype, activation):
    """Every activation in the tile and the narrow kernels' epilogues."""
    rng = np.random.default_rng(13)
    for v1, s, c, co in ((333, 9, 40, 40), (50, 9, 3, 3), (77, 3, 3, 16)):
        idx = torch.from_numpy(_spiral_with_pads(v1, s, rng)).to(cuda)
        x, w, bias = _fwd_inputs(5, v1, s, c, co, dtype, cuda, v1)
        got = TC._forward(x, idx, w, bias, activation)
        ref = TC.spiral_conv_plain(x, idx, w, bias, activation)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        assert torch.count_nonzero(got[:, -1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile", sorted(TC._FWD_TILES)
                         + sorted(TC._FWD_NARROW))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spiral_conv_fwd_every_tile(cuda, tile, dtype):
    """Each template instance, forced, on ragged shapes: 16-byte and
    element copies, outputs not a multiple of the tile's."""
    rng = np.random.default_rng(tile)
    shapes = [(301, 7, 40, 72), (301, 7, 3, 16), (130, 6, 12, 13)]
    if tile in TC._FWD_NARROW:
        keep = TC._FWD_NARROW[tile]
        shapes = [(301, 7, 40, min(keep, 3)), (301, 7, 3, keep),
                  (130, 6, 16, keep)]
    for v1, s, c, co in shapes:
        idx = torch.from_numpy(_spiral_with_pads(v1, s, rng)).to(cuda)
        x, w, bias = _fwd_inputs(3, v1, s, c, co, dtype, cuda, v1 + c)
        got = TC._forward(x, idx, w, bias, "tanh", tile=tile)
        again = TC._forward(x, idx, w, bias, "tanh", tile=tile)
        ref = TC.spiral_conv_plain(x, idx, w, bias, "tanh")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{(v1, s, c, co)}: {m}")
        assert torch.count_nonzero(got[:, -1]) == 0


@pytest.mark.cuda
def test_spiral_conv_fwd_rejects_bad_input(cuda):
    x, w, bias = _fwd_inputs(2, 40, 6, 8, 16, torch.float32, cuda, 0)
    idx = torch.from_numpy(_spiral_with_pads(40, 6, np.random.default_rng(
        0))).to(cuda)
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TC._forward(shifted, idx, w, bias, "elu")
    with pytest.raises(TypeError):
        TC._forward(x, idx.long(), w, bias, "elu")
    with pytest.raises(ValueError):
        TC._forward(x, idx, w, bias.cpu(), "elu")
    with pytest.raises(ValueError):
        TC._forward(x, idx, w, bias, "elu", tile=7)    # 4 outputs held
    wide = torch.from_numpy(_spiral_with_pads(40, 1000, np.random.default_rng(
        1))).to(cuda)
    xw, ww, bw = _fwd_inputs(2, 40, 1000, 8, 16, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="shared memory"):
        TC._forward(xw, wide, ww, bw, "elu")


# --- the batched, weighted row gather (row 7) and the weighted CSR reduce ----

def _gather_case(kind, b, c, dtype, device, n_src=500, n_rows=900, seed=0):
    """x [B, n_src + 1, C] (the last row sliced off, so rows are packed but
    the batch stride is not B's), and a gather table: "copy" T = 1
    unweighted, "w1" T = 1 weighted, "w3" T = 3 weighted (unpool-like
    barycentric weights), every case with repeated source rows."""
    from semantichuman_torch.ops import row_gather as RG
    rng = np.random.default_rng(seed + b + c)
    taps = 3 if kind == "w3" else 1
    idx = rng.integers(0, n_src, (n_rows, taps) if taps > 1 else n_rows)
    idx[:5] = idx[5]
    w = None
    if kind != "copy":
        w = rng.uniform(0, 1, idx.shape).astype(np.float32)
        if taps > 1:
            w /= w.sum(axis=1, keepdims=True)
    table = RG.GatherTable.build(idx, n_src, device, w=w)
    x = torch.from_numpy(rng.standard_normal((b, n_src + 1, c)).astype(
        np.float32)).to(device).to(dtype)[:, :-1]
    return x, table


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 12, 384])
@pytest.mark.parametrize("c", [3, 16, 32, 128])
@pytest.mark.parametrize("kind", ["copy", "w1", "w3"])
def test_gather_rows_matches_plain(cuda, kind, c, b, dtype):
    """Row 7 at T = 1 and 3: copies bit-equal to index_select, weighted sums
    within 2e-6 of the plain version relative to its largest entry (both
    round each product and sum in tap order); one counted launch a call,
    two launches bit-equal."""
    from semantichuman_torch.ops import row_gather as RG
    x, table = _gather_case(kind, b, c, dtype, cuda)
    before = RG.row_gather.launches
    got = RG.gather_rows_fwd(x, table.idx, table.w)
    again = RG.gather_rows_fwd(x, table.idx, table.w)
    ref = RG.gather_rows_plain(x, table.idx, table.w)
    torch.cuda.synchronize()
    assert RG.row_gather.launches == before + 2
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(got, again)
    if kind == "copy":
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=2e-6,
                                   atol=2e-6 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["copy", "w3"])
def test_gather_rows_fn_gradient(cuda, kind):
    """GatherRowsFn: forward the row 7 kernel, backward the (weighted)
    CSR reduce; dx equals index_add_'s to 1e-5 of the largest entry, two
    backward runs bit-equal, rows past the table's n_src get 0."""
    from semantichuman_torch.ops import csr_reduce as TR
    from semantichuman_torch.ops import row_gather as RG
    x, table = _gather_case(kind, 12, 32, torch.float32, cuda, seed=4)
    x = torch.cat([x, torch.ones_like(x[:, :7])], dim=1)
    xg = x.clone().requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    ct = torch.randn((12, table.n_rows, 32), generator=gen, device=cuda)
    before = TR.csr_reduce.launches
    y = RG.gather_rows(xg, table)
    (dx,) = torch.autograd.grad(y, xg, ct, retain_graph=True)
    (dx2,) = torch.autograd.grad(y, xg, ct)
    assert TR.csr_reduce.launches == before + 2
    taps = table.taps
    flat = table.idx.reshape(-1).long()
    cw = ct.repeat_interleave(taps, dim=1)
    if table.w is not None:
        cw = cw * table.w.reshape(-1)[None, :, None]
    ref = torch.zeros_like(x).index_add_(1, flat, cw)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2)
    assert torch.count_nonzero(dx[:, table.n_src:]) == 0
    torch.testing.assert_close(dx, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1, 3), (12, 32), (384, 16)])
def test_csr_reduce_weighted_matches_plain(cuda, b, c):
    """Row 8 with a weight per entry (unpool's transpose, plus a long row
    of 300 entries): within 1e-5 of the plain version's largest entry, one
    counted launch; without weights it gives the unweighted bits."""
    from semantichuman_torch.ops import csr_reduce as TR
    from semantichuman_torch.ops import row_gather as RG
    rng = np.random.default_rng(c)
    idx = rng.integers(0, 400, (900, 3))
    idx[:100] = 7                                   # a long row
    w = rng.uniform(0, 1, idx.shape).astype(np.float32)
    table = RG.GatherTable.build(idx, 400, cuda, w=w)
    g = torch.from_numpy(rng.standard_normal((b, 900, c)).astype(
        np.float32)).to(cuda)
    assert table.inverse.long_rows.numel() == 1
    before = TR.csr_reduce.launches
    got = TR.csr_reduce(g, table.inverse, table.inv_w)
    plain = TR.csr_reduce(g, table.inverse)
    torch.cuda.synchronize()
    assert TR.csr_reduce.launches == before + 2
    ref = TR.csr_reduce_plain(g, table.inverse, table.inv_w)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    ones = torch.ones_like(table.inv_w)
    assert torch.equal(TR.csr_reduce(g, table.inverse, ones), plain)


@pytest.mark.cuda
def test_gather_rows_rejects_bad_input(cuda):
    from semantichuman_torch.ops import csr_reduce as TR
    from semantichuman_torch.ops import row_gather as RG
    x, table = _gather_case("w3", 2, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        RG.gather_rows_fwd(x.double(), table.idx, table.w)
    with pytest.raises(ValueError):
        RG.gather_rows_fwd(x.transpose(1, 2), table.idx, table.w)
    with pytest.raises(ValueError):
        RG.gather_rows_fwd(x, table.idx, table.w.cpu())
    with pytest.raises(ValueError):
        RG.gather_rows_fwd(x, table.idx[:, :2].contiguous())
    with pytest.raises(ValueError):
        RG.gather_rows(x[:, :10], table)
    g = torch.zeros((2, table.n_rows, 8), device=cuda)
    with pytest.raises(ValueError):
        TR.csr_reduce(g, table.inverse, table.inv_w[:-1])


# --- the CSR reduce (row 8): run to run, and against its plain version -------

def _csr_cases(rng):
    """(label, CSR table, weights in CSR order or None, C): a spiral
    inverse with a long dummy row, and an unpool-like T = 3 inverse with a
    long row of 300 entries and a fifth of its weights exactly 0."""
    from semantichuman_torch.ops import row_gather as RG
    idx = _spiral_with_pads(500, 9, rng)
    taps = rng.integers(0, 400, (900, 3))
    taps[:100] = 7
    w = rng.uniform(0, 1, taps.shape).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.2] = 0.0
    return [("spiral", _csr(idx, "cuda"), None),
            ("taps", RG.GatherTable.build(taps, 400, "cuda", w=w), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("b", [1, 3, 12, 17, 40])
@pytest.mark.parametrize("c", [3, 6, 16, 32, 64, 192])
def test_csr_reduce_repeats_and_matches_plain(cuda, c, b, weighted):
    """At every batch tile's edge and unit (16 bytes; 8 at C = 6; 4 at
    C = 3), and at B = 1 with wide rows, each table with a long row: two
    runs bit-equal (a fixed order of sums, no atomics); within 1e-5 of the
    plain version's largest entry (index_add_ adds the same terms in
    another order: the long rows' chunk tree is not ascending); each call
    one counted launch."""
    from semantichuman_torch.ops import csr_reduce as TR
    rng = np.random.default_rng(b * 1000 + c)
    for label, table, has_w in _csr_cases(rng):
        inv = table if has_w is None else table.inverse
        wt = table.inv_w if weighted and has_w else None
        g = torch.from_numpy(rng.standard_normal(
            (b, inv.n_src, c)).astype(np.float32)).to(cuda)
        before = TR.csr_reduce.launches
        got = TR.csr_reduce(g, inv, wt)
        again = TR.csr_reduce(g, inv, wt)
        ref = TR.csr_reduce_plain(g, inv, wt)
        torch.cuda.synchronize()
        assert TR.csr_reduce.launches == before + 2, label
        assert inv.long_rows.numel() >= 1, label
        assert torch.equal(got, again), label
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()),
                                   msg=lambda m: f"{label}: {m}")


@pytest.mark.cuda
def test_csr_reduce_repeats_on_the_topology(cuda, full_tables):
    """Every spiral, pool and unpool inverse of the bundled topology at
    B = 40, weighted where the table is: two runs bit-equal, within 1e-5
    of the plain version's largest entry."""
    from semantichuman_torch.ops import csr_reduce as TR
    gen = torch.Generator(device=cuda).manual_seed(3)
    cases = [(f"spiral L{l}", t, None, 16)
             for l, t in enumerate(full_tables.spiral_csr)]
    cases += [(f"pool {l}", t.inverse, None, 32)
              for l, t in enumerate(full_tables.pool_gather)]
    cases += [(f"unpool {l}", t.inverse, t.inv_w, 32)
              for l, t in enumerate(full_tables.unpool_gather)]
    for label, table, wt, c in cases:
        g = torch.randn((40, table.n_src, c), generator=gen, device=cuda)
        got = TR.csr_reduce(g, table, wt)
        again = TR.csr_reduce(g, table, wt)
        ref = TR.csr_reduce_plain(g, table, wt)
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()),
                                   msg=lambda m: f"{label}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["csr_reduce"])
def test_csr_reduce_kernels_reject_bad_input(cuda, name):
    """A wrong dtype, a wrong row count, weights of the wrong shape or
    place: each raises and launches nothing."""
    from semantichuman_torch.ops import csr_reduce as TR
    fn = getattr(TR, name)
    (_l, _s, _n), (_lt, taps, _w) = _csr_cases(np.random.default_rng(0))
    inv = taps.inverse
    g = torch.zeros((2, inv.n_src, 8), device=cuda)
    before = fn.launches
    with pytest.raises(ValueError):
        fn(g.double(), inv, taps.inv_w)
    with pytest.raises(ValueError):
        fn(g[:, 1:].contiguous(), inv, taps.inv_w)
    with pytest.raises(ValueError):
        fn(g, inv, taps.inv_w[:-1])
    with pytest.raises(ValueError):
        fn(g, inv, taps.inv_w[:, None])
    with pytest.raises(ValueError):
        fn(g, inv, taps.inv_w.cpu())
    assert fn.launches == before


def _graph_trainer(tmp_path, name, n_train=12, **model):
    """A small-width Trainer on the epoch path on the card: the bundled
    6892-vertex topology, 12 synthetic train meshes (3 steps an epoch at
    B = 4), narrow filters; `model` overrides the model's settings."""
    import shutil

    from semantichuman_torch.config import Config
    from semantichuman_torch.train.loop import Trainer

    wd = tmp_path / name
    wd.mkdir()
    for suffix in ("", ".meta"):
        shutil.copy(TOPOLOGY + suffix, wd / f"topology_2222.npz{suffix}")
    cfg = Config.from_dict({
        "model": {"filter_sizes_enc": [[3, 8, 8, 16, 16], [[]] * 5],
                  "filter_sizes_dec": [[16, 16, 8, 8, 8],
                                       [[], [], [], [], 3]], **model},
        "data": {"synthetic": True, "synthetic_train": n_train,
                 "synthetic_test": 4},
        "train": {"n_epochs": 1, "save_recons": False, "batch_test": 4}})
    tr = Trainer(cfg, str(wd), device="cuda")
    assert tr._epoch_scan_ok()
    return tr


@pytest.mark.cuda
def test_captured_step_replays_equal_eager_steps(cuda, tmp_path,
                                                 monkeypatch):
    """An epoch of the epoch path at small width: 3 replays of the captured
    step give the parameters, moments and losses of the same step run 3
    times eagerly, bit for bit."""
    import types

    from semantichuman_torch.train import graph as G
    from semantichuman_torch.utils.params import tree_leaves

    captured = _graph_trainer(tmp_path, "graph")
    captured.fit()
    with monkeypatch.context() as mp:
        mp.setattr(G, "warm_up", lambda fn, reset, name, steps=2: None)
        mp.setattr(G, "capture",
                   lambda fn, pool, name: types.SimpleNamespace(replay=fn))
        eager = _graph_trainer(tmp_path, "eager")
        eager.fit()
    assert captured.global_step == eager.global_step == 3
    assert captured.history[0]["train"] == eager.history[0]["train"]
    for a, b in zip(tree_leaves(captured.params) + captured.opt_state.mu
                    + captured.opt_state.nu,
                    tree_leaves(eager.params) + eager.opt_state.mu
                    + eager.opt_state.nu):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_captured_baseline_step_replays_equal_eager_steps(cuda, tmp_path,
                                                          monkeypatch):
    """The neural3DMM baseline on the epoch path at small width: 2 replays
    of its captured step (graph train/<flags>/ori) give the parameters,
    moments and losses of the same step run twice eagerly on the same
    rows, bit for bit; the graph's replays count one a step."""
    import types

    from semantichuman_torch.ops import launches
    from semantichuman_torch.train import graph as G
    from semantichuman_torch.utils.params import tree_leaves

    n3dmm = {"model_type": "neural3DMM", "nz": 16, "banded_conv": False}
    captured = _graph_trainer(tmp_path, "graph", n_train=8, **n3dmm)
    before = launches.read()
    captured.fit()
    got = launches.diff(launches.read(), before)
    replays = {k: n for k, n in got["graph_replays"]["by_name"].items()
               if n}
    assert len(replays) == 1
    (name, n), = replays.items()
    assert name.startswith("train/") and name.endswith("/ori") and n == 2
    with monkeypatch.context() as mp:
        mp.setattr(G, "warm_up", lambda fn, reset, name, steps=2: None)
        mp.setattr(G, "capture",
                   lambda fn, pool, name: types.SimpleNamespace(replay=fn))
        eager = _graph_trainer(tmp_path, "eager", n_train=8, **n3dmm)
        eager.fit()
    assert captured.global_step == eager.global_step == 2
    assert captured.history[0]["train"] == eager.history[0]["train"]
    assert captured.history[0]["val"] == eager.history[0]["val"]
    for a, b in zip(tree_leaves(captured.params) + captured.opt_state.mu
                    + captured.opt_state.nu,
                    tree_leaves(eager.params) + eager.opt_state.mu
                    + eager.opt_state.nu):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_capture_with_a_host_copy_raises(cuda, tmp_path):
    """A step that copies from the host meets the capture and raises; the
    Trainer does not run the step eagerly instead: after the warm-up's two
    steps (on the epoch buffers, not the Trainer's state) and the one
    capture that failed, batch_fn was called no more, and the parameters
    and the step count are as before."""
    from semantichuman_torch.utils.params import tree_leaves

    tr = _graph_trainer(tmp_path, "host_copy")
    src = tr.train_loader.source
    batch_fn, calls = src.batch_fn, []

    def host_copy_batch_fn(idx):
        calls.append(torch.cuda.is_current_stream_capturing())
        torch.as_tensor(np.zeros(3, np.float32), device="cuda")
        return batch_fn(idx)

    src.batch_fn = host_copy_batch_fn
    before = [p.clone() for p in tree_leaves(tr.params)]
    with pytest.raises(RuntimeError):
        tr.fit()
    torch.cuda.synchronize()
    assert calls == [False] * 6 + [True]
    assert tr.global_step == 0 and tr.history == []
    for a, b in zip(before, tree_leaves(tr.params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 16])
def test_spiral_ae_through_the_kernels_matches_plain(cuda, b):
    """The neural3DMM SpiralAE (the default filters, nz 256) on the bundled
    topology: forward and the baseline loss's gradient through the conv,
    row gather and CSR reduce kernels against the same model with the
    plain conv, rtol 1e-4 on the reconstruction and loss, every gradient
    leaf within 1e-4 of its largest entry (f32 sums in another order); the
    dummy row exactly 0; the conv and gather kernels counted."""
    import copy

    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.ops.row_gather import row_gather
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train import losses as TL
    from semantichuman_torch.train import step as TS
    from semantichuman_torch.utils.params import tree_leaves

    human = SyntheticHuman()
    model = build_model(ModelConfig(model_type="neural3DMM",
                                    banded_conv=False),
                        MeshHierarchy.load(TOPOLOGY), device=cuda)
    plain = copy.copy(model)
    plain.conv_fn = TC.spiral_conv_plain
    params = model.init(0)
    tables = TL.build_loss_tables(human.template_faces, human.J_regressor,
                                  human.part_dict, device=cuda)
    m = human.sample_meshes(b, seed=4).astype(np.float32)
    x = torch.from_numpy(np.concatenate(
        [m, np.zeros((b, 1, 3), np.float32)], 1)).to(cuda)
    convs, gathers = TC.spiral_conv.launches, row_gather.launches
    with torch.no_grad():
        rec, z = model(params, x)
    torch.cuda.synchronize()
    assert TC.spiral_conv.launches - convs == 9
    assert row_gather.launches - gathers == 8
    with torch.no_grad():
        rec_p, z_p = plain(params, x)
    torch.testing.assert_close(rec, rec_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(z, z_p, rtol=1e-4, atol=1e-5)
    assert torch.count_nonzero(rec[:, -1]) == 0
    flags = TS.StepFlags()
    got = TS.value_and_grad(TS.make_baseline_loss_fn(model, tables, flags),
                            params, {"verts": x})
    ref = TS.value_and_grad(TS.make_baseline_loss_fn(plain, tables, flags),
                            params, {"verts": x})
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=0)
    for g, r in zip(tree_leaves(got[2]), tree_leaves(ref[2])):
        err = (g - r).abs().max() / r.abs().max().clamp_min(1e-30)
        assert float(err) <= 1e-4


# --- the custom ops and the exported bundle on the card ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_pass_opcheck_on_the_card(cuda, dtype):
    """torch.library.opcheck of both ops with CUDA tensors: the real
    implementation launches the kernels, the fake gives their shapes."""
    from semantichuman_torch.ops import row_gather as RG

    for shape in (SHAPES[0], SHAPES[2]):
        x, idx, w, bias = _case(shape, cuda)
        torch.library.opcheck(TC.spiral_conv_fwd_op,
                              (x.to(dtype), idx, w.to(dtype), bias, "elu"))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 40, 16)).astype(
        np.float32)).to(cuda, dtype)
    for taps, weighted in ((1, False), (3, True)):
        idx = rng.integers(0, 40, (25, taps) if taps > 1 else (25,))
        w = rng.uniform(size=idx.shape) if weighted else None
        table = RG.GatherTable.build(idx, 40, cuda, w=w)
        torch.library.opcheck(RG.gather_rows_op, (x, table.idx, table.w))


def _served(tmp_path, cuda):
    """A narrow PartAE on the bundled topology, exported on the card."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.serving import ServingBundle, export_inference
    from semantichuman_torch.topology import MeshHierarchy

    human = SyntheticHuman()
    model = build_model(
        ModelConfig(filter_sizes_enc=[[3, 8, 8, 16, 16], [[]] * 5],
                    filter_sizes_dec=[[16, 16, 8, 8, 8],
                                      [[], [], [], [], 3]]),
        MeshHierarchy.load(TOPOLOGY), human.part_dict, device=cuda)
    manifest = export_inference(model, model.init(0), human.J_regressor,
                                str(tmp_path))
    assert manifest["symbolic_batch"]
    assert manifest["artifacts"]["forward"]["platforms"] == [
        f"cuda:{torch.cuda.current_device()}"]
    m = human.sample_meshes(32, seed=6).astype(np.float32)
    verts = torch.from_numpy(np.concatenate(
        [m, np.zeros((32, 1, 3), np.float32)], 1)).to(cuda)
    return ServingBundle(str(tmp_path), device=cuda), verts


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16])
def test_graph_replay_equals_the_eager_program(cuda, tmp_path, b):
    """At B = 1 and 16 the captured forward, encode and decode give the
    eager program's bits, replay after replay."""
    from semantichuman_torch import serving as TSV

    bundle, verts = _served(tmp_path, cuda)
    assert b <= TSV._GRAPH_MAX_B
    x = verts[:b]
    for name, args in (("forward", (x,)), ("encode", (x,))):
        eager = bundle.call(name, *args, graph=False)
        for _ in range(2):
            got = bundle.call(name, *args)
            assert all(torch.equal(g, e) for g, e in zip(got, eager))
    z, z_kps, _dummy = bundle.call("encode", x, graph=False)
    eager = bundle.call("decode", z, z_kps, graph=False)
    assert torch.equal(bundle.call("decode", z, z_kps), eager)
    assert {(n, b) for n in ("forward", "encode", "decode")} \
        <= set(bundle._captured)


@pytest.mark.cuda
def test_graph_replays_return_their_own_outputs(cuda, tmp_path):
    """Two successive calls with different inputs: the second leaves the
    first call's result as it was (the replays return clones of the
    static outputs)."""
    bundle, verts = _served(tmp_path, cuda)
    a, b = verts[:4], verts[4:8]
    first = bundle.forward(a)
    kept = [t.clone() for t in first]
    second = bundle.forward(b)
    assert all(torch.equal(f, k) for f, k in zip(first, kept))
    assert not torch.equal(first[0], second[0])
    eager = bundle.call("forward", b, graph=False)
    assert all(torch.equal(s, e) for s, e in zip(second, eager))


@pytest.mark.cuda
def test_sharded_bundle_on_one_card(cuda, tmp_path):
    """Two copies on the one card (device listed twice): each shard on its
    copy's card, forward, encode and decode within 1e-5 of the one-device
    bundle, eager and captured; each copy captures its own graphs into
    its own pool."""
    from semantichuman_torch.serving import Shards, ServingBundle

    bundle, verts = _served(tmp_path, cuda)
    dp = ServingBundle(str(tmp_path), device=[cuda, cuda])
    for graph in (False, None):
        got = dp.call("forward", verts[:16], graph=graph)
        assert isinstance(got, Shards) and len(got) == 2
        assert all(t.shape[0] == 8 and t.device == c.device
                   for shard, c in zip(got, dp._copies) for t in shard)
        ref = bundle.call("forward", verts[:16], graph=graph)
        for g, r in zip(got.gather(), ref):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    z, z_kps, _ = bundle.encode(verts[:16])
    for g, r in zip(dp.encode(verts[:16]).gather(), (z, z_kps)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    torch.testing.assert_close(dp.decode(z, z_kps).gather(),
                               bundle.decode(z, z_kps), rtol=0, atol=1e-5)
    a, b = dp._copies
    assert set(a.captured) == set(b.captured) == {
        ("forward", 8), ("encode", 8), ("decode", 8)}
    assert a.pool is not None and a.pool != b.pool


def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_forward_on_a_second_card(dtype):
    """The forward conv at every test shape on cuda:0, then on cuda:1
    (where the kernels' shared-memory limit must be set again), each
    against its plain version there."""
    cards = _two_cards()
    for dev in cards:
        for shape in SHAPES:
            args = _case(shape, dev)
            with torch.cuda.device(cards[0]):
                got = TC.spiral_conv(*args, "elu", compute_dtype=dtype)
            ref = TC.spiral_conv_plain(*args, "elu", compute_dtype=dtype)
            assert got.device == dev
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_bundle_moved_to_a_second_card(tmp_path):
    """A bundle exported on cuda:0 and loaded on cuda:1 alone, and on
    [cuda:0, cuda:1], while cuda:0 is current: every program moved with
    nothing left off its card, its eager and captured forward equal to
    the bundle on cuda:0."""
    from semantichuman_torch import serving as TSV
    from semantichuman_torch.serving import ServingBundle

    c0, c1 = _two_cards()
    bundle, verts = _served(tmp_path, c0)
    for name in ("forward", "encode", "decode"):
        ep = TSV.load_program(str(tmp_path / f"{name}.pt2"), c1)
        assert TSV.off_device(ep, c1) == []
    moved = ServingBundle(str(tmp_path), device=c1)
    with torch.cuda.device(c0):
        for graph in (False, True):
            got = moved.call("forward", verts[:4], graph=graph)
            ref = bundle.call("forward", verts[:4], graph=graph)
            assert all(g.device == c1 and torch.equal(g.cpu(), r.cpu())
                       for g, r in zip(got, ref))
        split = ServingBundle(str(tmp_path), device=[c0, c1])
        got = split.forward(verts[:8])
        assert [s[0].device for s in got] == [c0, c1]
        for g, r in zip(got.gather(c0), bundle.forward(verts[:8])):
            torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
