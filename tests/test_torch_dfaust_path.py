"""The port's DFAUST data path against the JAX package's, on the CPU: the
asset loader on the clean bundle and on every hostile format the JAX
package's tests build, the on-disk dataset containers, the prefetch
pipeline, the three preprocessing CLIs (array for array) and the Trainer
trained from their on-disk layout, stacked and per sample."""

import json
import os
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from semantichuman_torch.cli import data_generation as t_datagen
from semantichuman_torch.cli import make_synthetic as t_make
from semantichuman_torch.cli import obj2npy as t_obj2npy
from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.data import dataset as TD
from semantichuman_torch.data.assets import BodyAssets as TAssets
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils.params import params_to_numpy
from semantichuman_tpu.cli import data_generation as j_datagen
from semantichuman_tpu.cli import make_synthetic as j_make
from semantichuman_tpu.cli import obj2npy as j_obj2npy
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.data import dataset as JD
from semantichuman_tpu.data.assets import BodyAssets as JAssets
from semantichuman_tpu.topology.adjacency import unique_edges
from semantichuman_tpu.topology.obj_io import save_obj
from semantichuman_tpu.train.loop import Trainer as JaxTrainer

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)


# --- BodyAssets.load --------------------------------------------------------

def _write_assets(tmp_path, sh):
    """The well-formed make_synthetic asset layout (tests/test_data.py's
    `asset_dir` fixture)."""
    adir = tmp_path / "asset"
    adir.mkdir()
    np.save(adir / "J_regressor.npy", sh.J_regressor)
    np.save(adir / "vert_part_index_dict.npy",
            np.asarray(sh.part_dict, dtype=object))
    np.save(adir / "factor_list.npy",
            np.asarray(sh.girth_factors, dtype=object))
    np.save(adir / "edge_point_index_list.npy",
            np.asarray(sh.girth_edges, dtype=object))
    np.save(adir / "edge_verts_index.npy", unique_edges(sh.template_faces))
    tpl = tmp_path / "template.obj"
    save_obj(str(tpl), sh.template_verts, sh.template_faces)
    return adir, tpl


def _sparse_object_j(adir, sh):
    wrapped = np.empty((), dtype=object)
    wrapped[()] = sp.csc_matrix(sh.J_regressor)
    np.save(adir / "J_regressor.npy", wrapped, allow_pickle=True)


def _out_of_range_part(adir, sh):
    bad = dict(sh.part_dict)
    first = next(iter(bad))
    bad[first] = np.append(np.asarray(bad[first]),
                           len(sh.template_verts) + 5)
    np.save(adir / "vert_part_index_dict.npy", np.asarray(bad, dtype=object))


def _nan_j(adir, sh):
    j = sh.J_regressor.copy()
    j[0, 0] = np.nan
    np.save(adir / "J_regressor.npy", j)


def _no_optional_tables(adir, sh):
    for name in ("factor_list.npy", "edge_point_index_list.npy",
                 "edge_verts_index.npy"):
        os.remove(adir / name)


# the hostile formats of tests/test_data.py:238-320 and
# tests/test_dfaust_drill.py, and the clean bundle
HOSTILE = {
    "clean": lambda adir, sh: None,
    "sparse_object_j_regressor": _sparse_object_j,
    "bare_sparse_j_regressor": lambda adir, sh: np.save(
        adir / "J_regressor.npy", sp.csr_matrix(sh.J_regressor),
        allow_pickle=True),
    "wrong_shape_j_regressor": lambda adir, sh: np.save(
        adir / "J_regressor.npy", sh.J_regressor[:, :-3]),
    "non_finite_j_regressor": _nan_j,
    "out_of_range_part_index": _out_of_range_part,
    "part_dict_not_a_dict": lambda adir, sh: np.save(
        adir / "vert_part_index_dict.npy", np.arange(4)),
    "nested_list_girth_tables": lambda adir, sh: np.save(
        adir / "factor_list.npy",
        np.asarray([list(map(list, np.asarray(f, dtype=float)))
                    for f in sh.girth_factors], dtype=object),
        allow_pickle=True),
    "mismatched_girth_tables": lambda adir, sh: np.save(
        adir / "factor_list.npy",
        np.asarray(sh.girth_factors[:-2], dtype=object)),
    "ragged_girth_edges_out_of_range": lambda adir, sh: np.save(
        adir / "edge_point_index_list.npy",
        np.asarray([np.asarray(e) + len(sh.template_verts)
                    for e in sh.girth_edges], dtype=object)),
    "edge_verts_wrong_shape": lambda adir, sh: np.save(
        adir / "edge_verts_index.npy", unique_edges(sh.template_faces)[:, :1]),
    "no_optional_tables": _no_optional_tables,
}


def _assets_equal(got, want):
    for f in ("template_verts", "template_faces", "j_regressor"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert list(got.part_dict) == list(want.part_dict)
    for k in want.part_dict:
        np.testing.assert_array_equal(got.part_dict[k], want.part_dict[k])
    for f in ("girth_edges", "girth_factors"):
        a, b = getattr(got, f), getattr(want, f)
        assert len(a) == len(b), f
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)
    if want.edge_verts is None:
        assert got.edge_verts is None
    else:
        np.testing.assert_array_equal(got.edge_verts, want.edge_verts)


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_assets_load_matches_jax(case, tmp_path, small_human):
    """The same arrays as the JAX loader, or the same ValueError naming
    the same file."""
    adir, tpl = _write_assets(tmp_path, small_human)
    HOSTILE[case](adir, small_human)
    try:
        want = JAssets.load(str(adir), str(tpl))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TAssets.load(str(adir), str(tpl))
        assert str(got.value) == str(e)
        assert ".npy" in str(e)
        return
    _assets_equal(TAssets.load(str(adir), str(tpl)), want)


# --- MeshData, FileSource, save_meshes --------------------------------------

@pytest.fixture(scope="module")
def meshes(small_human):
    return small_human.sample_meshes(10, seed=9).astype(np.float32)


def _stacked_layout(root, meshes, sh):
    pre = root / "preprocessed"
    pre.mkdir(parents=True)
    np.save(pre / "train.npy", meshes[:8])
    np.save(pre / "test.npy", meshes[8:])
    (root / "template").mkdir()
    save_obj(str(root / "template" / "template.obj"), sh.template_verts,
             sh.template_faces)


@pytest.mark.parametrize("normalization", ["No", "gass", "normal"])
def test_mesh_data_matches_jax(tmp_path, meshes, small_human,
                               normalization):
    """Splits (memmapped), template, stats, and the OBJ export of
    reconstructions with the scaling undone, byte for byte."""
    _stacked_layout(tmp_path, meshes, small_human)
    t = TD.MeshData(str(tmp_path), n_val=2, normalization=normalization)
    j = JD.MeshData(str(tmp_path), n_val=2, normalization=normalization)
    assert isinstance(t.vertices_train, np.memmap)
    for f in ("vertices_train", "vertices_val", "vertices_test",
              "template_verts", "template_faces"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    for f in ("mean", "std", "center", "scale"):
        a, b = getattr(t.stats, f), getattr(j.stats, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    recs = meshes[:2] * 0.9
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t.save_meshes(str(tmp_path / "t" / "rec"), recs, [0, 1])
    j.save_meshes(str(tmp_path / "j" / "rec"), recs, [0, 1])
    for i in (0, 1):
        name = f"rec_{i:06d}.obj"
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())


def test_mesh_data_rejects_n_val_out_of_range(tmp_path, meshes,
                                              small_human):
    _stacked_layout(tmp_path, meshes, small_human)
    with pytest.raises(ValueError, match="n_val"):
        TD.MeshData(str(tmp_path), n_val=8)


def test_file_source_matches_jax(tmp_path, meshes, small_human):
    """The per-sample layout data_generation writes: verts and measures of
    any index set, as the JAX source reads them."""
    root = tmp_path / "preprocessed"
    os.makedirs(root / "points_train")
    os.makedirs(root / "measure_train")
    measures = small_human.measures(meshes).astype(np.float32)
    names = []
    for i in range(len(meshes)):
        name = str(i).zfill(6)
        np.save(root / "points_train" / f"{name}.npy", meshes[i])
        np.save(root / "measure_train" / f"{name}.npy", measures[i])
        names.append(name)
    np.save(root / "paths_train.npy", names)
    t = TD.FileSource(str(root), "train", measure=True)
    j = JD.FileSource(str(root), "train", measure=True)
    assert len(t) == len(j) == 10
    idx = np.array([3, 7, 0])
    got, want = t.take(idx), j.take(idx)
    assert sorted(got) == sorted(want)
    for k in ("verts", "measure", "idx"):
        np.testing.assert_array_equal(got[k], want[k])


# --- prefetch_to_device on the CPU ------------------------------------------

def test_prefetch_threaded_matches_inline(meshes):
    """The worker thread yields exactly the inline batches, in order, as
    tensors on the device asked for (ids stay on the host)."""
    src = TD.ArraySource(meshes)

    def batches():
        return iter(TD.BatchLoader(src, 4, shuffle=True, seed=7))

    inline = list(TD.prefetch_to_device(batches(), "cpu", size=0))
    threaded = list(TD.prefetch_to_device(batches(), "cpu", size=2))
    assert len(inline) == len(threaded) == 3
    for a, b in zip(inline, threaded):
        assert isinstance(b["verts"], torch.Tensor)
        assert torch.equal(a["verts"], b["verts"])
        assert torch.equal(a["valid"], b["valid"])
        np.testing.assert_array_equal(a["idx"], b["idx"])
        assert isinstance(b["idx"], np.ndarray)


def test_prefetch_threaded_propagates_errors(meshes):
    def boom():
        yield {"verts": meshes[:2], "idx": np.arange(2)}
        raise RuntimeError("loader exploded")

    it = TD.prefetch_to_device(boom(), "cpu", size=2)
    next(it)
    with pytest.raises(RuntimeError, match="loader exploded"):
        list(it)


def test_prefetch_threaded_early_abandon(meshes):
    """Closing the generator releases the worker blocked on a full
    queue."""
    n_before = threading.active_count()
    src = TD.ArraySource(meshes)
    it = TD.prefetch_to_device(iter(TD.BatchLoader(src, 2)), "cpu", size=1)
    next(it)
    it.close()
    for _ in range(50):                      # the worker exits within 5 s
        if threading.active_count() <= n_before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= n_before


# --- the three preprocessing CLIs -------------------------------------------

def _run_clis(mods, root, n_val):
    make, obj2npy, datagen = mods
    make.main(["--out_dir", str(root), "--n_train", "12", "--n_test", "4",
               "--n_theta", "12", "--n_phi", "24"])
    obj2npy.main(["--save_path", str(root),
                  "--trainobj_path", str(root / "obj_train"),
                  "--testobj_path", str(root / "obj_test"),
                  "--asset_dir", str(root / "asset")])
    datagen.main(["-r", str(root), "--n_val", str(n_val)])


@pytest.fixture(scope="module")
def cli_layouts(tmp_path_factory):
    """make_synthetic -> obj2npy -> data_generation through each package's
    CLIs, at tests/test_cli.py's sizes."""
    base = tmp_path_factory.mktemp("clis")
    _run_clis((t_make, t_obj2npy, t_datagen), base / "torch", 2)
    _run_clis((j_make, j_obj2npy, j_datagen), base / "jax", 2)
    return base / "torch", base / "jax"


def test_clis_write_the_jax_files(cli_layouts):
    """Every file the port's CLIs write equals the JAX CLIs' file: .npy
    array for array (pickled object arrays element for element), .obj
    byte for byte."""
    t_root, j_root = cli_layouts
    t_files = sorted(p.relative_to(t_root).as_posix()
                     for p in t_root.rglob("*") if p.is_file())
    j_files = sorted(p.relative_to(j_root).as_posix()
                     for p in j_root.rglob("*") if p.is_file())
    assert t_files == j_files
    assert "preprocessed/paths_val.npy" in t_files
    assert "preprocessed/train_measurements.npy" in t_files
    for rel in t_files:
        a, b = t_root / rel, j_root / rel
        if rel.endswith(".obj"):
            assert a.read_bytes() == b.read_bytes(), rel
            continue
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        assert x.dtype == y.dtype and x.shape == y.shape, rel
        if x.dtype != object:
            np.testing.assert_array_equal(x, y, err_msg=rel)
        elif x.ndim == 0:
            xd, yd = x.item(), y.item()
            assert list(xd) == list(yd), rel
            for k in xd:
                np.testing.assert_array_equal(xd[k], yd[k], err_msg=rel)
        else:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=rel)


# --- the Trainer on the on-disk layout --------------------------------------

def _disk_cfg(root, from_stacked):
    """The DFAUST recipe's data and loss settings on the small layout: two
    epochs of batch 4 over its 10 train meshes.  The per-sample layout
    runs with device_resident off on both sides (the JAX Trainer's
    staging check reads array shapes, which a FileSource has none of)."""
    return {
        "model": dict(SMALL_MODEL_OVERRIDES, banded_conv=False),
        "data": {"root_dir": str(root), "asset_dir": str(root / "asset"),
                 "normalization": "zeroroot", "measure": True,
                 "from_stacked": from_stacked,
                 **({} if from_stacked else {"device_resident": False})},
        "train": {"n_epochs": 2, "batch_train": 4, "batch_interp": 4,
                  "batch_test": 4, "ck_frequency": 2, "save_recons": False,
                  "data_parallel": False},
    }


def _epoch_losses(workdir: str) -> list:
    """(epoch, train loss, val loss) from the metrics log both Trainers
    write."""
    recs = [json.loads(line) for line in
            open(os.path.join(workdir, "summaries", "metrics.jsonl"))]
    return [(r["step"], r["epoch_train"], r["epoch_val"])
            for r in recs if "epoch_train" in r]


@pytest.fixture(scope="module", params=[True, False],
                ids=["stacked", "per_sample"])
def disk_runs(request, cli_layouts, tmp_path_factory):
    root = cli_layouts[0]
    raw = _disk_cfg(root, request.param)
    base = tmp_path_factory.mktemp("disk")
    jt = JaxTrainer(JaxConfig.from_dict(raw), str(base / "jax"))
    jt.fit()
    tt = TorchTrainer(TorchConfig.from_dict(raw), str(base / "torch"),
                      device="cpu")
    tt.fit()
    return request.param, jt, tt


def test_disk_trainer_matches_jax(disk_runs):
    """Epoch losses rtol 1e-4 and parameters atol 1e-4 against the JAX
    Trainer (as tests/test_torch_trainer.py holds them); the port takes the
    epoch path on the stacked layout and the prefetched loop per sample;
    both compiled the first train frame's template."""
    stacked, jt, tt = disk_runs
    assert tt._epoch_scan_ok() == stacked
    assert isinstance(tt.data["train"],
                      TD.ArraySource if stacked else TD.FileSource)
    assert len(tt.data["train"]) == 10 and len(tt.data["val"]) == 2
    assert tt.hierarchy.sizes == list(jt.hierarchy.sizes)
    for a, b in zip(tt.hierarchy.spirals, jt.hierarchy.spirals):
        np.testing.assert_array_equal(a, b)
    assert Path(tt.workdir, "topology_2222.npz.meta").read_text() == \
        Path(jt.workdir, "topology_2222.npz.meta").read_text()
    got, want = _epoch_losses(tt.workdir), _epoch_losses(jt.workdir)
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == [1, 2]
    np.testing.assert_allclose(np.asarray(got)[:, 1:],
                               np.asarray(want)[:, 1:], rtol=1e-4)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")


def test_disk_layouts_train_alike(cli_layouts, tmp_path):
    """The stacked and the per-sample layout of one dataset give the port
    the same batches and the same epoch losses (the loop on both)."""
    root = cli_layouts[0]
    hist = {}
    for stacked in (True, False):
        raw = _disk_cfg(root, stacked)
        raw["data"]["device_resident"] = False
        tr = TorchTrainer(TorchConfig.from_dict(raw),
                          str(tmp_path / str(stacked)), device="cpu")
        first = next(iter(tr.train_loader))
        hist[stacked] = (first, tr.fit().history)
    (a, ha), (b, hb) = hist[True], hist[False]
    np.testing.assert_array_equal(a["verts"], b["verts"])
    np.testing.assert_array_equal(a["measure"], b["measure"])
    assert [h["train"] for h in ha] == [h["train"] for h in hb]
