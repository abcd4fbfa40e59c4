"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

On a host without a card every test skips; chip_smoke.py holds the kernels
at the full serving and training shapes.
"""

import numpy as np
import pytest
import torch

from semantichuman_torch.ops import spiral_conv as TC

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


def _part_case(n_reals, n_pad, batch, device, seed=0):
    rng = np.random.default_rng(seed)
    p = len(n_reals)
    vp = rng.uniform(-0.5, 0.5, (p * batch, n_pad, 3)).astype(np.float32)
    rp = (vp + rng.normal(0, 0.02, vp.shape)).astype(np.float32)
    bone = rng.normal(0, 0.3, (p * batch, 3)).astype(np.float32)
    a = rng.uniform(0.8, 1.2, (p, batch)).astype(np.float32)
    n_real = np.asarray(n_reals, np.int32)
    allone = (np.arange(p) % 3 == 1).astype(np.int32)
    return [torch.from_numpy(t).to(device)
            for t in (vp, rp, bone, a, n_real, allone)]


@pytest.mark.cuda
@pytest.mark.parametrize("w_mode,relat", [("threshold", True),
                                          ("linear", False), ("sin", True),
                                          ("all_one", True)])
@pytest.mark.parametrize("n_reals,n_pad,batch", [((40, 33, 17), 40, 3),
                                                 ((406, 405), 408, 4),
                                                 ((800,), 800, 1)])
def test_part_dist_kernels_match_plain(cuda, n_reals, n_pad, batch, w_mode,
                                       relat):
    """The three part_dist kernels (fwd, fwd_grad, bwd) against their
    plain versions, which round every per-pair value alike: counts equal,
    term sums rtol 1e-5 and gradients to 1e-4 of the largest entry (sums
    in another order).  One counted launch each."""
    from semantichuman_torch.ops import part_dist as TP
    args = _part_case(n_reals, n_pad, batch, cuda) + [w_mode, 0.8, relat]
    ct = torch.linspace(0.5, 1.5, args[0].shape[0], device=cuda)
    before = dict(TP.part_dist_sums.launches)
    sums = TP.part_dist_call("fwd", *args)
    sums2, g0 = TP.part_dist_call("fwd_grad", *args)
    drp = TP.part_dist_call("bwd", *args, ct=ct)
    ref_sums, ref_g0 = TP.part_dist_plain(*args, mode="fwd_grad")
    ref_drp = TP.part_dist_plain(*args, mode="bwd", ct=ct)
    torch.cuda.synchronize()
    for mode in ("fwd", "fwd_grad", "bwd"):
        assert TP.part_dist_sums.launches[mode] == before[mode] + 1
    for s in (sums, sums2):
        torch.testing.assert_close(s[:, 0], ref_sums[:, 0], rtol=1e-5,
                                   atol=0)
        assert torch.equal(s[:, 1], ref_sums[:, 1])
    for g, r in ((g0, ref_g0), (drp, ref_drp)):
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=1e-4 * float(r.abs().max()))


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
