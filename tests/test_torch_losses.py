"""The port's geometry, skeleton, measures and losses against the JAX
package, and the plain part_dist kernels against the Pallas kernels in
interpret mode, from the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantichuman_torch.constants as TC
import semantichuman_tpu.constants as JC
from semantichuman_torch.data import measure_np as TM
from semantichuman_torch.data.synthetic import SyntheticHuman as TorchHuman
from semantichuman_torch.ops import distance as TD
from semantichuman_torch.ops import part_dist as TP
from semantichuman_torch.ops import skeleton as TK
from semantichuman_torch.train import losses as TL
from semantichuman_tpu.data import measure_np as JM
from semantichuman_tpu.ops import distance as JD
from semantichuman_tpu.ops import skeleton as JK
from semantichuman_tpu.ops.pallas import part_dist_pallas as JP
from semantichuman_tpu.train import losses as JL

torch.set_num_threads(1)

B = 3


@pytest.fixture()
def _interpret_part_dist():
    old = JP._INTERPRET
    JP._INTERPRET = True
    yield
    JP._INTERPRET = old


@pytest.fixture(scope="module")
def data(small_human):
    rng = np.random.default_rng(7)
    tx = small_human.sample_meshes(B, seed=11).astype(np.float32)
    rec = (tx + rng.normal(0, 0.01, tx.shape)).astype(np.float32)
    measure = small_human.measures(tx).astype(np.float32)
    kps = np.einsum("jv,bvd->bjd",
                    small_human.J_regressor, tx).astype(np.float32)
    a_full = np.ones((B, 17), np.float32)
    edited = np.zeros(17, np.float32)
    for p in (2, 3, 5):
        a_full[:, p] = 1.1
        edited[p] = 1.0
    return tx, rec, measure, kps, a_full, edited


@pytest.fixture(scope="module")
def tables(small_human):
    args = (small_human.template_faces, small_human.J_regressor,
            small_human.part_dict)
    return JL.build_loss_tables(*args), TL.build_loss_tables(*args,
                                                             device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# --- constants, measures, synthetic ----------------------------------------

def test_constants_equal_jax():
    for name in ("SKL_LIST", "SKL_KEEP", "NEWSKL_KEEP", "MEASURE_SKL_LIST",
                 "LEAF_PART_INDICES", "NOLEAF_PART_INDICES",
                 "NOLEAF_IN_MEASURE", "MEASURE_PART_LIST", "PARENT_DICT",
                 "CHILD_DICT", "NEWSKL_LIST", "KPS_KEEP", "PART_LIST"):
        assert getattr(TC, name) == getattr(JC, name), name
    for skl in (JC.SKL_LIST, JC.NEWSKL_LIST):
        for a, b in zip(TC.bone_endpoint_arrays(skl),
                        JC.bone_endpoint_arrays(skl)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TC.skl_path_matrix(),
                                  JC.skl_path_matrix())


@pytest.mark.parametrize("size", [(16, 36), (None, None)])
def test_synthetic_measures_equal_jax(size, small_human):
    """Girth rings and the 32-d measures, bit for bit."""
    from semantichuman_tpu.data.synthetic import SyntheticHuman as JaxHuman
    t, j = TorchHuman(*size), JaxHuman(*size)
    for a, b in zip(t.girth_edges, j.girth_edges):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.girth_factors, j.girth_factors):
        np.testing.assert_array_equal(a, b)
    meshes = j.sample_meshes(2, seed=3)
    np.testing.assert_array_equal(t.measures(meshes), j.measures(meshes))


def test_measure_np_equals_jax():
    rng = np.random.default_rng(5)
    verts = rng.standard_normal((40, 3))
    edges = [rng.integers(0, 40, (7, 2)) for _ in range(3)]
    factors = [rng.uniform(0, 1, (7, 1)) for _ in range(3)]
    np.testing.assert_array_equal(TM.girths_np(verts, factors, edges),
                                  JM.girths_np(verts, factors, edges))
    kps = rng.standard_normal((35, 3))
    np.testing.assert_array_equal(
        TM.bone_lengths_np(kps, TC.MEASURE_SKL_LIST),
        JM.bone_lengths_np(kps, JC.MEASURE_SKL_LIST))
    ring = np.stack([np.cos(np.linspace(0, 6, 12)),
                     np.full(12, 0.3), np.sin(np.linspace(0, 6, 12))], 1)
    pts = np.stack([ring - [0, 0.5, 0], ring + [0, 0.5, 0]], 1)
    got, want = (TM.plane_girth([0, 0.1, 0], [0, 1, 0.1], pts),
                 JM.plane_girth([0, 0.1, 0], [0, 1, 0.1], pts))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no edge crosses"):
        TM.plane_girth([0, 0, 0], [1, 0, 0], np.zeros((2, 2, 3)))


# --- geometry and skeleton ---------------------------------------------------

def test_distance_ops_match_jax(data, tables):
    """f32 ops in another order: atol 1e-6 (distances and volumes of
    order 1)."""
    tx, rec, *_ = data
    jt, tt = tables
    x = tx[:, :50]
    np.testing.assert_allclose(TD.pairwise_dist(_t(x)).numpy(),
                               np.asarray(JD.pairwise_dist(_j(x))),
                               atol=1e-6)
    mask = np.random.default_rng(0).uniform(size=(B, 50, 50)) > 0.3
    np.fill_diagonal(mask[0], True)          # sqrt at 0 inside the mask
    got = TD.masked_pairwise_dist(_t(x), _t(mask))
    want = JD.masked_pairwise_dist(_j(x), _j(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        TD.face_edge_lengths(_t(tx), tt.faces).numpy(),
        np.asarray(JD.face_edge_lengths(_j(tx), _j(jt.faces))), atol=1e-6)
    np.testing.assert_allclose(
        TD.signed_part_volumes(_t(tx), tt.faces, tt.face_part_mask).numpy(),
        np.asarray(JD.signed_part_volumes(_j(tx), _j(jt.faces),
                                          _j(jt.face_part_mask))),
        atol=1e-6)


def test_masked_pairwise_dist_grad_matches_jax(data):
    """The double-where keeps the gradient finite (0) off the mask; sums
    of ~30 pair terms of order 30 in another order: rtol 1e-5."""
    tx, *_ = data
    x = tx[:, :30]
    mask = np.random.default_rng(1).uniform(size=(B, 30, 30)) > 0.4
    for b in range(B):
        np.fill_diagonal(mask[b], False)
    xt = _t(x).requires_grad_(True)
    TD.masked_pairwise_dist(xt, _t(mask)).sum().backward()
    want = jax.grad(lambda v: JD.masked_pairwise_dist(v, _j(mask)).sum())(
        _j(x))
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_skeleton_matches_jax(data):
    _, _, _, kps, *_ = data
    kept = kps[:, TC.KPS_KEEP]
    np.testing.assert_array_equal(TK.expand_kps(_t(kept)).numpy(),
                                  np.asarray(JK.expand_kps(_j(kept))))
    a, b1, b2 = TC.bone_endpoint_arrays(TC.SKL_LIST)
    np.testing.assert_allclose(
        TK.bone_vectors(_t(kps), a, b1, b2).numpy(),
        np.asarray(JK.bone_vectors(_j(kps), a, b1, b2)), atol=1e-7)
    for mode in ("ori_m", "vec_m", "vec", "m"):
        for k in (kps, kept):
            np.testing.assert_allclose(
                TK.kps2skl(_t(k), mode).numpy(),
                np.asarray(JK.kps2skl(_j(k), mode)), atol=1e-6, err_msg=mode)
    for mode in ("ori_m", "vec_m"):
        skl = np.asarray(JK.kps2skl(_j(kps), mode))
        np.testing.assert_allclose(TK.skl2kps(_t(skl), mode).numpy(),
                                   np.asarray(JK.skl2kps(_j(skl), mode)),
                                   atol=1e-6, err_msg=mode)
    with pytest.raises(ValueError):
        TK.kps2skl(_t(kps), "nope")


# --- losses ------------------------------------------------------------------

@pytest.mark.parametrize("relat", [True, False])
def test_simple_losses_match_jax(data, tables, relat):
    """rec, edgereg (GT edges computed or staged), zpartreg, kps
    consistency, volume (GT volumes computed or staged), regress_kps: rtol
    1e-6 (float32 means of the same terms in another order)."""
    tx, rec, measure, kps, *_ = data
    jt, tt = tables
    jf = _j(jt.faces)
    z = np.random.default_rng(2).normal(0, 1, (B, 17, 8)).astype(np.float32)
    edges = np.asarray(JD.face_edge_lengths(_j(tx), jf))
    vols = np.asarray(JD.signed_part_volumes(_j(tx), jf,
                                             _j(jt.face_part_mask)))
    pairs = [
        (TL.rec_loss(_t(tx), _t(rec)), JL.rec_loss(_j(tx), _j(rec))),
        (TL.edgereg_loss(_t(tx), _t(rec), tt.faces),
         JL.edgereg_loss(_j(tx), _j(rec), jf)),
        (TL.edgereg_loss(_t(tx), _t(rec), tt.faces, gt_edges=_t(edges)),
         JL.edgereg_loss(_j(tx), _j(rec), jf, gt_edges=_j(edges))),
        (TL.zpartreg_loss(_t(z), _t(measure), relat),
         JL.zpartreg_loss(_j(z), _j(measure), relat)),
        (TL.kps_consistency_loss(_t(rec), _t(kps[:, TC.KPS_KEEP]),
                                 tt.j_regressor, tt.kps_keep),
         JL.kps_consistency_loss(_j(rec), _j(kps[:, TC.KPS_KEEP]),
                                 _j(jt.j_regressor), _j(jt.kps_keep))),
        (TL.volume_loss(_t(tx), _t(rec), tt),
         JL.volume_loss(_j(tx), _j(rec), jt)),
        (TL.volume_loss(_t(tx), _t(rec), tt, gt_vols=_t(vols)),
         JL.volume_loss(_j(tx), _j(rec), jt, gt_vols=_j(vols))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=str(i))
    np.testing.assert_allclose(
        TL.regress_kps(_t(tx), tt.j_regressor).numpy(),
        np.asarray(JL.regress_kps(_j(tx), _j(jt.j_regressor))), atol=1e-6)


@pytest.mark.parametrize("as_table", [True, False])
def test_edge_loss_matches_jax(data, small_human, as_table):
    """edge_loss over the unique edges, as the prebuilt table or the
    [E, 2] list: the value (rtol 1e-6) and its gradient in rec, through
    the gather's plain version and its CSR backward, against jax.grad
    (rtol 1e-5, atol 1e-5 of the gradient's largest entry); 0 on
    identical meshes and positive on a stretched one (as
    tests/test_losses.py holds the JAX loss)."""
    from semantichuman_torch.topology.adjacency import unique_edges

    tx, rec, *_ = data
    e = unique_edges(small_human.template_faces)
    edges = (TL.edge_table(e, tx.shape[1], "cpu") if as_table else e)
    r = _t(rec).requires_grad_(True)
    got = TL.edge_loss(_t(tx), r, edges)
    got.backward()
    want, jgrad = jax.value_and_grad(
        lambda x: JL.edge_loss(_j(tx), x, e))(_j(rec))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(r.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgrad).max()))
    assert float(TL.edge_loss(_t(tx), _t(tx), edges)) == 0.0
    assert float(TL.edge_loss(_t(tx), _t(tx) * 1.1, edges)) > 0.0


def _wdl_pair(data, tables, w_mode, w_part_mode, relat, leafkeep=True,
              with_a=True, part_indices=None, tx=None, rec=None, kps=None):
    """(port loss fn of rec, JAX jnp-path loss fn of rec)."""
    tx0, rec0, _, kps0, a_full, edited = data
    tx = tx0 if tx is None else tx
    kps = kps0 if kps is None else kps
    jt, _tt = tables
    if part_indices is not None:
        jt = dataclasses.replace(jt, part_indices=part_indices)
    ptab = TP.PartDistTables(jt.part_indices, leafkeep, w_mode, "cpu")
    a = a_full if with_a else None

    def port(r):
        return TL.weighted_distance_loss(
            _t(tx), r, _t(kps), ptab, a_full=None if a is None else _t(a),
            edited_mask=_t(edited), n_edited=torch.tensor(3.0),
            w_mode=w_mode, w_threshold=0.8, w_part_mode=w_part_mode,
            relat=relat)

    def ref(r):
        return JL.weighted_distance_loss(
            _j(tx), r, _j(kps), jt, a_full=None if a is None else _j(a),
            edited_mask=_j(edited), n_edited=jnp.float32(3.0),
            w_mode=w_mode, w_threshold=0.8, w_part_mode=w_part_mode,
            relat=relat, leafkeep=leafkeep, fused=False)

    return port, ref


@pytest.mark.parametrize("relat", [True, False])
@pytest.mark.parametrize("w_part_mode", ["1/K", "n/N", "1/rand_num"])
@pytest.mark.parametrize("w_mode", ["threshold", "linear", "sin", "all_one"])
def test_weighted_distance_matches_jax(data, tables, w_mode, w_part_mode,
                                       relat):
    """The port's loss (plain part_dist on CPU) against JAX's jnp path
    (fused=False): rtol 1e-5, the tolerance tests/test_pallas.py holds the
    Pallas kernel to against the same path."""
    port, ref = _wdl_pair(data, tables, w_mode, w_part_mode, relat,
                          leafkeep=w_mode != "sin")
    rec = data[1]
    np.testing.assert_allclose(float(port(_t(rec))), float(ref(_j(rec))),
                               rtol=1e-5)


@pytest.mark.parametrize("w_mode,relat", [("threshold", True),
                                          ("linear", False), ("sin", True)])
def test_weighted_distance_grad_matches_jax(data, tables, w_mode, relat):
    """The autograd route on CPU (PartDistFn over the plain kernels, the
    one-pass g0) against jax.grad of the jnp path: value rtol 1e-5,
    gradient rtol 1e-4 atol 1e-5 (tests/test_pallas.py's tolerances)."""
    port, ref = _wdl_pair(data, tables, w_mode, "1/K", relat)
    rec = data[1]
    r = _t(rec).requires_grad_(True)
    v = port(r)
    v.backward()
    v_ref, g_ref = jax.value_and_grad(ref)(_j(rec))
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)


def _ragged(n_verts, sizes, seed=0):
    perm = np.random.default_rng(seed).permutation(n_verts)
    cuts = np.cumsum(sizes)[:-1]
    return tuple(np.sort(c).astype(np.int32)
                 for c in np.split(perm[:sum(sizes)], cuts))


def test_weighted_distance_ragged_and_oversize_match_jax(data, tables):
    """17 ragged parts (several n_pad buckets) with one part above the
    Pallas kernel's 768-vertex VMEM cap: the port takes the kernel for
    every part, JAX's jnp path is the reference (value rtol 1e-5,
    gradient rtol 1e-4 atol 1e-5)."""
    rng = np.random.default_rng(9)
    n_verts = 1300
    sizes = [800, 3, 9, 16, 17, 33] + [38] * 11
    parts = _ragged(n_verts, sizes)
    assert max(len(p) for p in parts) > JP.MAX_FUSED_N
    tx = rng.uniform(-0.5, 0.5, (2, n_verts, 3)).astype(np.float32)
    rec = (tx + rng.normal(0, 0.01, tx.shape)).astype(np.float32)
    kps = rng.uniform(-0.5, 0.5, (2, 35, 3)).astype(np.float32)
    d = data[:4] + (data[4][:2], data[5])
    port, ref = _wdl_pair(d, tables, "threshold", "n/N", True,
                          part_indices=parts, tx=tx, kps=kps)
    r = _t(rec).requires_grad_(True)
    v = port(r)
    v.backward()
    v_ref, g_ref = jax.value_and_grad(ref)(_j(rec))
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)
    ptab = TP.PartDistTables(parts, True, "threshold", "cpu")
    assert len(ptab.buckets) > 3


# --- the plain kernels against the Pallas kernels ----------------------------

def _stacked_case(n_reals, n_pad, batch, seed):
    """One bucket: vp, rp [P*B, n_pad, 3], bone [P*B, 3], a [P, B], n_real,
    allone [P]; rows past n_real hold junk, which both sides ignore."""
    rng = np.random.default_rng(seed)
    p = len(n_reals)
    vp = rng.uniform(-0.5, 0.5, (p * batch, n_pad, 3)).astype(np.float32)
    rp = (vp + rng.normal(0, 0.02, vp.shape)).astype(np.float32)
    bone = rng.normal(0, 0.3, (p * batch, 3)).astype(np.float32)
    a = rng.uniform(0.8, 1.2, (p, batch)).astype(np.float32)
    n_real = np.asarray(n_reals, np.int32)
    allone = (np.arange(p) % 3 == 1).astype(np.int32)
    return vp, rp, bone, a, n_real, allone


def _lanes(x):
    """[G, n, 3] -> the Pallas layout [G, n, 128], xyz in lanes 0-2."""
    return np.pad(x, ((0, 0), (0, 0), (0, 125)))


def _bone_tile(bone):
    return np.pad(bone[:, None, :], ((0, 0), (0, 7), (0, 125)))


@pytest.mark.parametrize("onepass", ["1", "0"])
@pytest.mark.parametrize("w_mode,relat", [("threshold", True),
                                          ("linear", False), ("sin", True),
                                          ("all_one", False)])
@pytest.mark.parametrize("n_reals,n_pad", [((40, 33, 17), 40),
                                           ((9,), 16), ((770,), 776)],
                         ids=["bucket40", "bucket16", "oversize776"])
def test_plain_part_dist_matches_pallas(_interpret_part_dist, monkeypatch,
                                        n_reals, n_pad, w_mode, relat,
                                        onepass):
    """part_dist_sums (the plain kernels on CPU, through PartDistFn)
    against the Pallas part_dist_sums in interpret mode: the sums (rtol
    1e-5) and the rp VJP for a random cotangent (rtol 1e-4, atol 1e-5),
    under both VJP designs.  The 776-row tile is above the Pallas kernel's
    VMEM cap; each of its gradient rows sums 769 terms of either sign in
    another order, so its atol is 1e-4 of the tile's largest entry."""
    monkeypatch.setenv("SH_TPU_DIST_ONEPASS", onepass)
    batch = 2 if n_pad < 700 else 1
    vp, rp, bone, a, n_real, allone = _stacked_case(n_reals, n_pad, batch,
                                                    seed=n_pad)
    ct = np.random.default_rng(1).normal(0, 1, (len(vp), 2)).astype(
        np.float32)
    consts = (w_mode, 0.8, relat)

    def jfn(r):
        return JP.part_dist_sums(_j(_lanes(vp)), r, _j(_bone_tile(bone)),
                                 _j(a), n_real, allone, *consts)

    want, vjp = jax.vjp(jfn, _j(_lanes(rp)))
    (want_g,) = vjp(_j(ct))
    r = _t(rp).requires_grad_(True)
    got = TP.part_dist_sums(_t(vp), r, _t(bone), _t(a), _t(n_real),
                            _t(allone), *consts, one_pass=onepass == "1")
    got.backward(_t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    want_g = np.asarray(want_g)[..., :3]
    atol = 1e-4 * np.abs(want_g).max() if n_pad > JP.MAX_FUSED_N else 1e-5
    np.testing.assert_allclose(r.grad.numpy(), want_g, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("w_mode,relat", [("threshold", True),
                                          ("linear", False)])
def test_plain_modes_agree(w_mode, relat):
    """The three plain modes and the differentiable plain sums tell one
    story: fwd == fwd_grad's sums, bwd(ct) == g0 * ct (rtol 1e-5, atol
    1e-5: ct enters before the row sums, not after), and autograd of
    part_dist_sums_plain == g0 * ct (rtol 1e-4, atol 1e-5: autograd sums
    each pair's two symmetric terms separately)."""
    vp, rp, bone, a, n_real, allone = _stacked_case((30, 24), 32, 3, seed=4)
    args = [_t(x) for x in (vp, rp, bone, a, n_real, allone)] + [
        w_mode, 0.8, relat]
    ct = torch.linspace(0.5, 1.5, len(vp))
    sums = TP.part_dist_plain(*args, mode="fwd")
    sums2, g0 = TP.part_dist_plain(*args, mode="fwd_grad")
    drp = TP.part_dist_plain(*args, mode="bwd", ct=ct)
    torch.testing.assert_close(sums, sums2, rtol=0, atol=0)
    torch.testing.assert_close(drp, g0 * ct[:, None, None], rtol=1e-5,
                               atol=1e-5)
    r = args[1].clone().requires_grad_(True)
    plain = TP.part_dist_sums_plain(args[0], r, *args[2:])
    torch.testing.assert_close(plain.detach(), sums, rtol=1e-6, atol=0)
    (plain[:, 0] * ct).sum().backward()
    torch.testing.assert_close(r.grad, g0 * ct[:, None, None], rtol=1e-4,
                               atol=1e-5)


def test_threshold_weights_agree_with_arccos():
    """PARITY #27: with acos in place of the Pallas arcsin series, the
    weights that survive the threshold equal arccos(cos)·2/π computed in
    float64 to ~1e-7."""
    vp, _rp, bone, _a, _n, _al = _stacked_case((60,), 64, 2, seed=8)
    vt, bt = _t(vp), _t(bone)
    n_real = torch.tensor([60, 60])
    w, _ = TP._weights(vt, bt, n_real, torch.zeros(2, dtype=torch.int32),
                       "threshold", 0.8)
    v64, b64 = vp.astype(np.float64)[:, :60], bone.astype(np.float64)
    d = v64[:, :, None] - v64[:, None, :]
    cos = np.abs(np.einsum("gjkd,gd->gjk", d, b64)) / (
        np.linalg.norm(d, axis=-1) * np.linalg.norm(b64, axis=-1)[:, None,
                                                                    None]
        + 1e-300)
    ref = np.arccos(np.clip(cos, 0, 1)) * 2 / np.pi
    w = w.numpy()[:, :60, :60]
    live = w > 0
    assert live.sum() > 100
    np.testing.assert_allclose(w[live], ref[live], atol=2e-6)


def test_zero_reconstructed_distance_has_zero_gradient():
    """PARITY #19: a masked pair whose reconstructed vertices coincide
    gives 0, not NaN, in the gradient (one-pass, two-kernel and the
    differentiable plain sums)."""
    vp, rp, bone, a, n_real, allone = _stacked_case((20,), 24, 1, seed=5)
    rp[0, 3] = rp[0, 4]
    allone[:] = 1
    args = (_t(vp), None, _t(bone), _t(a), _t(n_real), _t(allone),
            "threshold", 0.8, True)
    grads = []
    for one_pass in (True, False):
        r = _t(rp).requires_grad_(True)
        TP.part_dist_sums(args[0], r, *args[2:],
                          one_pass=one_pass)[:, 0].sum().backward()
        grads.append(r.grad)
    r = _t(rp).requires_grad_(True)
    TP.part_dist_sums_plain(args[0], r, *args[2:])[:, 0].sum().backward()
    grads.append(r.grad)
    for g in grads:
        assert torch.isfinite(g).all()
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-4, atol=1e-6)


def test_part_dist_rejects_other_devices():
    vp, rp, bone, a, n_real, allone = _stacked_case((8,), 8, 1, seed=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        TP.part_dist_sums(_t(vp).to("meta"), _t(rp).to("meta"), _t(bone),
                          _t(a), _t(n_real), _t(allone), "threshold", 0.8,
                          True)


def _bad_part_dist_inputs():
    vp, rp, bone, a, n_real, allone = (_t(x) for x in _stacked_case(
        (8, 6), 8, 2, seed=0))
    ok = (vp, rp, bone, a, n_real, allone, "threshold", None)
    return {
        "w_mode": ok[:6] + ("cosine", None),
        "rp_shape": (vp, rp[:, :4], *ok[2:]),
        "bone_shape": (vp, rp, bone[:, :2], *ok[3:]),
        "a_size": (vp, rp, bone, a[:, :1], *ok[4:]),
        "parts_not_dividing": (vp, rp, bone, a, n_real[:1].repeat(3),
                               allone[:1].repeat(3), *ok[6:]),
        "no_parts": (vp, rp, bone, a, n_real[:0], allone[:0], *ok[6:]),
        "vp_float64": (vp.double(), *ok[1:]),
        "rp_not_contiguous": (vp, rp.transpose(1, 2).contiguous()
                              .transpose(1, 2), *ok[2:]),
        "n_real_int64": (*ok[:4], n_real.long(), *ok[5:]),
        "ct_shape": (*ok[:7], torch.ones(3)),
    }


@pytest.mark.parametrize("case", sorted(_bad_part_dist_inputs()))
def test_part_dist_checks_reject(case):
    """The CUDA wrapper's checks raise on what the kernel does not take."""
    with pytest.raises(ValueError):
        TP._check(*_bad_part_dist_inputs()[case])
