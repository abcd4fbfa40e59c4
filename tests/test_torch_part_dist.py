"""The part_dist kernel's host side on the CPU: the threshold's guard band
against the plain acos decision (on float32 cosines and on the bundled
meshes), the premise of one evaluation per unordered pair (where the two
Gram orders of a pair round alike every decision agrees) and the count of
pairs where they do not, and the wrapper's plain version.  The kernels
themselves run in test_torch_kernels_cuda.py."""

import math

import numpy as np
import pytest
import torch

from semantichuman_torch.data.synthetic import SyntheticHuman
from semantichuman_torch.ops import part_dist as TP
from semantichuman_torch.train.losses import (build_loss_tables, part_bones,
                                              regress_kps)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def step_bucket():
    """The bundled template's 17 parts (one bucket of n_pad 408) on two
    synthetic meshes and a reconstruction 1 cm off, stacked as the loss
    stacks them: vp, rp, bone, a, n_real, allone."""
    human = SyntheticHuman()
    tables = build_loss_tables(human.template_faces, human.J_regressor,
                               human.part_dict, device="cpu")
    ptab = TP.PartDistTables(tables.part_indices, True, "threshold", "cpu")
    assert [bk["n_pad"] for bk in ptab.buckets] == [408]
    bk = ptab.buckets[0]
    rng = np.random.default_rng(3)
    tx = human.sample_meshes(2, seed=3).astype(np.float32)
    rec = (tx + rng.normal(0, 0.01, tx.shape)).astype(np.float32)
    tx_t, rec_t = torch.from_numpy(tx), torch.from_numpy(rec)
    pc = bk["part_ids"].shape[0]
    bones = part_bones(regress_kps(tx_t, tables.j_regressor))
    bone = bones.index_select(1, bk["part_ids"]).transpose(0, 1) \
        .reshape(pc * 2, 3).contiguous()
    return (TP._stack_parts(tx_t, bk["gather"], pc, 408),
            TP._stack_parts(rec_t, bk["gather"], pc, 408), bone,
            torch.ones((pc, 2)), bk["n_real"], bk["allone"])


@pytest.mark.parametrize("w_mode", ["threshold", "linear", "sin"])
def test_equal_gram_sums_give_equal_decisions(step_bucket, w_mode):
    """Where the Gram sums of (j, k) and (k, j) are the same bits, de0, w
    and the mask are too, so one evaluation serves both orders; the pairs
    whose sums differ stay under 10 % (for vp alone and with rp in the
    mask), which is what the kernel evaluates twice."""
    vp, rp, bone, a, n_real, allone = step_bucket
    g = vp.shape[0]
    a_e, n_real_e, allone_e = TP._expand(a, n_real, allone, g)
    w, de0 = TP._weights(vp, bone, n_real_e, allone_e, w_mode, 0.8)
    mask = (w * de0) != 0.0
    sums = TP._gram_sums(vp)
    same = sums == sums.transpose(1, 2)
    idx = torch.arange(vp.shape[1])
    real = idx[None, :] < n_real_e[:, None]
    live = (idx[:, None] < idx[None, :])[None] & real[:, :, None] \
        & real[:, None, :]
    both = same & live
    for m in (de0, w, mask):
        assert torch.equal(m[both], m.transpose(1, 2)[both])
    assert int(both.sum()) > 0.9 * int(live.sum())
    apart = TP.asymmetric_pairs(vp, rp, bone, a, n_real, allone, w_mode, 0.8)
    assert 0 < float(apart.sum()) < 0.1 * int(live.sum())


def test_asymmetric_pairs_counts_by_hand():
    """asymmetric_pairs against a plain loop over the unordered pairs of a
    small ragged bucket."""
    rng = np.random.default_rng(5)
    vp = rng.uniform(-0.5, 0.5, (4, 24, 3)).astype(np.float32)
    rp = (vp + rng.normal(0, 0.02, vp.shape)).astype(np.float32)
    bone = rng.normal(0, 0.3, (4, 3)).astype(np.float32)
    a = rng.uniform(0.8, 1.2, (2, 2)).astype(np.float32)
    n_real = np.asarray([24, 19], np.int32)
    allone = np.asarray([0, 1], np.int32)
    args = [torch.from_numpy(x) for x in (vp, rp, bone, a, n_real, allone)]
    got = TP.asymmetric_pairs(*args, "threshold", 0.8)
    a_e, n_e, al_e = TP._expand(args[3], args[4], args[5], 4)
    w, de0 = TP._weights(args[0], args[2], n_e, al_e, "threshold", 0.8)
    mask = (w * (de0 * a_e[:, None, None])) != 0.0
    sv, sr = TP._gram_sums(args[0]), TP._gram_sums(args[1])
    for t in range(4):
        n = int(n_e[t])
        want = sum(1 for j in range(n) for k in range(j + 1, n)
                   if sv[t, j, k] != sv[t, k, j]
                   or (mask[t, j, k] and sr[t, j, k] != sr[t, k, j]))
        assert float(got[t]) == want


def _ulps_around(c: float, half: int) -> torch.Tensor:
    """2 half + 1 consecutive float32 values centred on c."""
    bits = np.float32(c).view(np.int32)
    return torch.from_numpy(np.arange(bits - half, bits + half + 1,
                                      dtype=np.int32).view(np.float32))


@pytest.mark.parametrize("thr", [0.05, 0.2, 0.35, 0.5, 0.67, 0.8, 0.9,
                                 0.95, 0.99])
def test_guard_band_keeps_the_plain_decision(thr):
    """On ~10^6 float32 cosines around the threshold's cut (the band and
    far past it), zeroing where c > c_skip without acos and deciding the
    rest with acos gives the plain version's decision w < thr for every
    value; the band skips the values past it and keeps the cut inside."""
    cut = math.cos(0.5 * math.pi * thr)
    c_skip = TP._acos_skip_cos(thr)
    assert cut < c_skip < 1.0
    c = torch.cat([_ulps_around(cut, 250_000), _ulps_around(c_skip, 250_000),
                   torch.linspace(0.0, 1.0, 500_001)])
    c = c[c <= 1.0]                # the kernel's cosine is clamped to 1
    plain = torch.acos(c) * (2.0 / math.pi) < thr
    band = torch.where(c > c_skip, True,
                       torch.acos(c) * (2.0 / math.pi) < thr)
    assert torch.equal(band, plain)
    assert bool((c > c_skip).any()) and bool((~plain).any())
    assert not bool((c > c_skip)[~plain].any())


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.67, 0.8, 0.95])
def test_guard_band_on_the_meshes(step_bucket, thr):
    """On every pair of the bundled meshes' 17 parts, the kernel's weight
    (zero past the band without acos, else the plain formula) equals the
    plain version's, and the band skips acos for most of the pairs the
    threshold zeroes."""
    vp, _rp, bone, a, n_real, allone = step_bucket
    g = vp.shape[0]
    _a_e, n_e, al_e = TP._expand(a, n_real, allone, g)
    w, de0 = TP._weights(vp, bone, n_e, al_e, "threshold", thr)
    s = TP._dot3(vp, bone[:, None, :])
    bn = torch.sqrt(TP._dot3(bone, bone))[:, None, None]
    denom = de0 * bn
    pos = denom > 0.0
    c = torch.clamp(torch.where(pos, (s[:, :, None] - s[:, None, :]).abs()
                                / torch.where(pos, denom, 1.0), 1.0), 0.0,
                    1.0)
    skip = c > TP._acos_skip_cos(thr)
    band = torch.where(skip, 0.0, torch.acos(c) * (2.0 / math.pi))
    band = torch.where(band < thr, 0.0, band)
    band = torch.where(al_e[:, None, None] > 0, 1.0, band)
    idx = torch.arange(vp.shape[1])
    real = idx[None, :] < n_e[:, None]
    valid = (idx[:, None] != idx[None, :])[None] & real[:, :, None] \
        & real[:, None, :]
    band = torch.where(valid, band, 0.0)
    assert torch.equal(band, w)
    zeroed = valid & (al_e[:, None, None] == 0) & (w == 0)
    assert float((skip & zeroed).sum()) > 0.5 * float(zeroed.sum())


@pytest.mark.parametrize("thr", [0.01, 0.1, 0.25, 0.4, 0.5, 0.6, 0.7, 0.75,
                                 0.8, 0.85, 0.9, 0.95, 0.99, 0.999])
def test_acos_skip_cos_is_the_rounded_up_cut(thr):
    """c_skip is cos((pi/2) t (1 - 1e-4)) rounded up to the next float32:
    no float32 below it reaches the cut angle, and it lies above the
    threshold's own cosine."""
    c_skip = TP._acos_skip_cos(thr)
    cut = math.cos(0.5 * math.pi * thr * (1.0 - TP._ACOS_BAND))
    below = float(np.nextafter(np.float32(c_skip), np.float32(-1.0)))
    assert below < cut <= c_skip
    assert c_skip > math.cos(0.5 * math.pi * thr)
    assert np.float32(c_skip) == c_skip


def test_asymmetric_share_grows_with_a_spread_reconstruction(step_bucket):
    """The share of pairs whose two Gram orders round otherwise is set by
    the GT meshes (~5 %) while the reconstruction sits near them; a
    reconstruction spread around a point away from the origin, as early
    training gives, adds its own."""
    vp, rp, bone, a, n_real, allone = step_bucket
    rng = np.random.default_rng(7)
    spread = (0.3 * vp + 0.4 + torch.from_numpy(
        rng.normal(0, 0.05, vp.shape).astype(np.float32))).contiguous()
    n = n_real.double().repeat_interleave(vp.shape[0] // n_real.shape[0])
    pairs = float((n * (n - 1) / 2).sum())
    near = float(TP.asymmetric_pairs(vp, rp, bone, a, n_real, allone,
                                     "threshold", 0.8).sum()) / pairs
    far = float(TP.asymmetric_pairs(vp, spread, bone, a, n_real, allone,
                                    "threshold", 0.8).sum()) / pairs
    assert 0.02 < near < 0.1 and far > near + 0.01


@pytest.mark.parametrize("thr,want", [(0.0, 2.0), (-0.5, 2.0),
                                      (float("nan"), 2.0), (1.5, -1.0),
                                      (7.0, -1.0)])
def test_guard_band_edges(thr, want):
    """No skip where no weight can fall below the threshold; all skipped
    where every weight does."""
    assert TP._acos_skip_cos(thr) == want


@pytest.mark.parametrize("w_mode", ["all_one", "linear", "sin",
                                    "threshold"])
@pytest.mark.parametrize("mode", ["fwd", "fwd_grad", "bwd"])
def test_wrappers_run_the_plain_version_on_the_cpu(mode, w_mode):
    """part_dist_call on CPU tensors is the plain version in every mode
    and w_mode, and counts no launch."""
    rng = np.random.default_rng(4)
    vp = rng.uniform(-0.5, 0.5, (4, 24, 3)).astype(np.float32)
    rp = (vp + rng.normal(0, 0.02, vp.shape)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (
        vp, rp, rng.normal(0, 0.3, (4, 3)).astype(np.float32),
        rng.uniform(0.8, 1.2, (2, 2)).astype(np.float32),
        np.asarray([24, 17], np.int32), np.asarray([0, 1], np.int32))] \
        + [w_mode, 0.6, w_mode != "linear"]
    kw = {"ct": torch.linspace(0.5, 1.5, 4)} if mode == "bwd" else {}
    ref = TP.part_dist_plain(*args, mode=mode, **kw)
    before = dict(TP.part_dist_sums.launches)
    got = TP.part_dist_call(mode, *args, **kw)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)
    assert dict(TP.part_dist_sums.launches) == before


@pytest.mark.parametrize("mode,with_ct", [("fwd", True), ("bwd", False)])
def test_launch_takes_ct_in_bwd_only(mode, with_ct):
    """The cotangent goes with mode 'bwd' and no other; a mismatch raises
    before any build or launch."""
    vp = torch.zeros((1, 8, 3))
    args = (vp, vp.clone(), torch.ones((1, 3)), torch.ones((1, 1)),
            torch.tensor([8], dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), "threshold", 0.8, True)
    kw = {"ct": torch.ones(1)} if with_ct else {}
    with pytest.raises(ValueError, match="cotangent"):
        TP._launch(mode, *args, **kw)


@pytest.mark.parametrize("g,n_pad,want", [
    (2176, 408, 4), (68, 408, 8), (1, 8, 8), (162, 408, 8), (163, 408, 4),
    (65535, 8, 4)])
def test_rows_warps(g, n_pad, want):
    """4 warps a block where the grid (32 rows a block) has 16 blocks or
    more per SM, as the step's 17 x 128 tiles, else 8, as the Trainer's
    17 x 4."""
    assert TP._rows_warps(g, n_pad) == want


@pytest.mark.parametrize("launch", ["_launch"])
def test_tiles_above_the_shared_memory_raise(launch):
    """A tile above the kernel's shared memory raises before any launch;
    nothing falls back to another route."""
    big = TP.MAX_N + 8
    vp = torch.zeros((1, big, 3))
    args = (vp, vp.clone(), torch.ones((1, 3)), torch.ones((1, 1)),
            torch.tensor([big], dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), "threshold", 0.8, True)
    with pytest.raises(ValueError, match="shared-memory tile"):
        getattr(TP, launch)("fwd", *args)
