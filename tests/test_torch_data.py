"""The port's data pipeline against the JAX package's: the batch schedule
(seeded shuffles, set_epoch, the anchored interp cycle), normalization, and
the device-resident batches with their staged GT loss inputs."""

import itertools

import numpy as np
import pytest
import torch

from semantichuman_torch.data import dataset as TD
from semantichuman_torch.data.assets import BodyAssets as TAssets
from semantichuman_torch.data.device_data import DeviceDataSource as TDev
from semantichuman_tpu.data import dataset as JD
from semantichuman_tpu.data.assets import BodyAssets as JAssets
from semantichuman_tpu.data.device_data import DeviceDataSource as JDev

torch.set_num_threads(1)

MODES = ["No", "zeroroot", "zeromean_small", "zeroroot_onelength",
         "zeroroot_gass", "normal"]


@pytest.fixture(scope="module")
def arrays(small_human):
    train = small_human.sample_meshes(12, seed=0).astype(np.float32)
    test = small_human.sample_meshes(6, seed=1).astype(np.float32)
    return train, test, small_human.measures(train).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, seed=2, drop_last=True),
    dict(batch_size=5, shuffle=False, seed=0, pad_final=True),
    dict(batch_size=5, shuffle=True, seed=103, drop_last=False),
], ids=["train", "eval_pad", "ragged"])
def test_batch_schedule_equals_jax(arrays, small_human, kw):
    """Same batches, epoch after epoch and through the anchored cycle."""
    train, _, meas = arrays
    jr = small_human.J_regressor
    tl = TD.BatchLoader(TD.ArraySource(train, meas), normalization="zeroroot",
                        j_regressor=jr, **kw)
    jl = JD.BatchLoader(JD.ArraySource(train, meas), normalization="zeroroot",
                        j_regressor=jr, **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 3):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        for a, b in itertools.zip_longest(tl, jl):
            np.testing.assert_array_equal(a["global_idx"], b["global_idx"])
            np.testing.assert_array_equal(a["verts"], b["verts"])
            np.testing.assert_array_equal(a["measure"], b["measure"])
            np.testing.assert_array_equal(a["valid"], b["valid"])
            assert a["pad"] == b["pad"]
    for a, b in zip(itertools.islice(tl.cycle(anchor=7), 9),
                    itertools.islice(jl.cycle(anchor=7), 9)):
        np.testing.assert_array_equal(a["global_idx"], b["global_idx"])


@pytest.mark.parametrize("mode", MODES)
def test_normalization_equals_jax(arrays, small_human, mode):
    train, test, _ = arrays
    ts = TD.compute_stats(train, test, mode)
    js = JD.compute_stats(train, test, mode)
    for f in ("mean", "std", "center", "scale"):
        a, b = getattr(ts, f), getattr(js, f)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    idx = np.arange(len(test))
    got = TD.normalize_batch(test, mode, small_human.J_regressor, ts, idx)
    want = JD.normalize_batch(test, mode, small_human.J_regressor, js, idx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TD.unnormalize_batch(got, mode, ts, idx),
        JD.unnormalize_batch(want, mode, js, idx))


@pytest.mark.parametrize("mode", ["zeroroot", "zeroroot_gass"])
def test_device_source_equals_jax(arrays, small_human, mode):
    """Staged batches and GT loss inputs against the JAX device source
    (1e-6 of each array's largest value: the same f32 arithmetic,
    reductions in another order).
    Some coordinates of the small human have a train std of float noise
    (~1e-7), and 'gass' divides by it, which would magnify the root's f32
    rounding into the result; both sides get the same stats with the std
    floored at 1e-2."""
    from semantichuman_tpu.train.losses import build_loss_tables
    train, test, meas = arrays
    stats = JD.compute_stats(train, test, mode)
    if stats.std is not None:
        stats.std = np.maximum(stats.std, 1e-2)
    tables = build_loss_tables(small_human.template_faces,
                               small_human.J_regressor,
                               small_human.part_dict)
    faces = np.asarray(tables.faces)
    mask = np.asarray(tables.face_part_mask)
    common = dict(j_regressor=small_human.J_regressor, stats=stats,
                  gt_faces=faces, gt_face_part_mask=mask)
    jsrc = JDev(train, meas, mode, **common)
    tsrc = TDev(train, meas, mode, device="cpu", **common)
    meta = {"global_idx": np.array([5, 0, 11, 5]), "pad": 1,
            "valid": np.array([1, 1, 1, 0], np.float32)}
    want, got = jsrc.take(meta), tsrc.take(meta)
    for k in ("verts", "measure", "gt_face_edges", "gt_part_vols", "valid"):
        b = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max() + 1e-7,
                                   err_msg=k)
    assert got["pad"] == 1
    # the host pipeline gives the same verts
    host = TD.BatchLoader(TD.ArraySource(train, meas), batch_size=4,
                          normalization=mode,
                          j_regressor=small_human.J_regressor, stats=stats)
    first = next(iter(host))
    np.testing.assert_allclose(
        tsrc.take({"global_idx": first["global_idx"], "pad": 0,
                   "valid": first["valid"]})["verts"].numpy(),
        first["verts"], rtol=1e-6,
        atol=1e-6 * np.abs(first["verts"]).max() + 1e-7)


def test_synthetic_assets_equal_jax():
    ta, _ = TAssets.synthetic(16, 36)
    ja, _ = JAssets.synthetic(16, 36)
    for f in ("template_verts", "template_faces", "j_regressor",
              "edge_verts"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    assert list(ta.part_dict) == list(ja.part_dict)
    from semantichuman_torch.data.assets import part_color_map as tcm
    from semantichuman_tpu.data.assets import part_color_map as jcm
    np.testing.assert_array_equal(tcm(ta.part_dict, len(ta.template_verts)),
                                  jcm(ja.part_dict, len(ja.template_verts)))
    # the on-disk loader is ported (tests/test_torch_dfaust_path.py): a
    # missing template raises as the JAX loader's does
    for load in (TAssets.load, JAssets.load):
        with pytest.raises(FileNotFoundError, match="template.obj"):
            load("data/asset", "no_such_dir/template.obj")
