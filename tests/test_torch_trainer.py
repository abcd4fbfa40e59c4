"""The port's Trainer against the JAX package's, and its surroundings:
checkpoints, resume, the segment runner, config loading and the training
CLI, on the small synthetic human on the CPU."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.train.loop import topology_key
from semantichuman_torch.utils.params import params_to_numpy, tree_leaves
from semantichuman_torch.utils.testing import \
    band_gate_patches as torch_band_patches
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.topology import compile_topology
from semantichuman_tpu.train.loop import Trainer as JaxTrainer
from semantichuman_tpu.utils.testing import \
    band_gate_patches as jax_band_patches

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_THETA, N_PHI = 16, 36


def _raw_cfg(**train):
    return {
        "model": dict(SMALL_MODEL_OVERRIDES, banded_conv=True),
        "data": {"synthetic": True, "synthetic_train": 16,
                 "synthetic_test": 8, "synthetic_n_theta": N_THETA,
                 "synthetic_n_phi": N_PHI, "normalization": "zeroroot"},
        "train": {"n_epochs": 2, "batch_train": 4, "batch_interp": 4,
                  "batch_test": 4, "ck_frequency": 2, "log_every": 0,
                  "save_recons": False, "epoch_scan": False,
                  "data_parallel": False, **train},
    }


def _port_cfg(**train):
    return TorchConfig.from_dict(_raw_cfg(**train))


@pytest.fixture(scope="module")
def topology_dir(tmp_path_factory, small_human):
    """The small human's hierarchy as the JAX Trainer compiles it (anchor
    vertex min(414, V-1)), with its .meta key: copied into every port
    workdir below."""
    d = tmp_path_factory.mktemp("topo")
    compile_topology(small_human.template_verts, small_human.template_faces,
                     cache_path=str(d / "topology_2222.npz"),
                     reference_vertex=min(414,
                                          len(small_human.template_verts) - 1))
    return d


def _workdir(base: Path, topology_dir: Path) -> str:
    base.mkdir(parents=True, exist_ok=True)
    for name in ("topology_2222.npz", "topology_2222.npz.meta"):
        shutil.copy(topology_dir / name, base / name)
    return str(base)


def _epoch_losses(workdir: str) -> list:
    recs = [json.loads(line) for line in
            open(os.path.join(workdir, "summaries", "metrics.jsonl"))]
    return [(r["step"], r["epoch_train"], r.get("epoch_val"))
            for r in recs if "epoch_train" in r]


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory, topology_dir):
    """Both Trainers, band gates forced on both sides (the JAX set without
    its pool band, which the port does not have), seed 2, two epochs of the
    step loop from the same hierarchy file."""
    base = tmp_path_factory.mktemp("parity")
    jax_dir = _workdir(base / "jax", topology_dir)
    torch_dir = _workdir(base / "torch", topology_dir)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, val in jax_band_patches():
            if name != "_pool_band_ok":
                mp.setattr(mod, name, val)
        jt = JaxTrainer(JaxConfig.from_dict(_raw_cfg()), jax_dir)
        assert any(b is not None for b in jt.model.tables.bands)
        jt.fit()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, val in torch_band_patches():
            mp.setattr(mod, name, val)
        tt = TorchTrainer(_port_cfg(), torch_dir, device="cpu")
        assert all(b is not None for b in tt.model.tables.bands)
        assert all(b is not None for b in tt.model.tables.unpool_bands)
        tt.fit()
    return jt, tt, jax_dir, torch_dir


def test_trainer_epoch_losses_match_jax(parity_runs):
    """Per-epoch train and val loss to rtol 1e-4 (needed: ~1e-6; f32 sums
    in another order through 8 steps of the whole loss stack)."""
    jt, tt, jax_dir, torch_dir = parity_runs
    want, got = _epoch_losses(jax_dir), _epoch_losses(torch_dir)
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == [1, 2]
    for (e, jtr, jval), (_, ttr, tval) in zip(want, got):
        np.testing.assert_allclose(ttr, jtr, rtol=1e-4, err_msg=f"train {e}")
        np.testing.assert_allclose(tval, jval, rtol=1e-4, err_msg=f"val {e}")
    assert tt.global_step == jt.global_step == 8


def test_trainer_params_match_jax(parity_runs):
    """Final parameters to atol 1e-4 after 8 Adam steps (lr 1e-3)."""
    jt, tt, _, _ = parity_runs
    # jax.tree.leaves on both: the same (sorted-key) leaf order
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")


def test_trainer_eval_matches_jax(parity_runs):
    """evaluate(): predictions and the L1 / mm metrics of the trained
    models agree (rtol 1e-4)."""
    jt, tt, _, _ = parity_runs
    jp, jz, jzk, jtx, jl1, jmm = jt.evaluate()
    tp, tz, tzk, ttx, tl1, tmm = tt.evaluate()
    np.testing.assert_allclose(ttx, jtx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose([tl1, tmm], [jl1, jmm], rtol=1e-4)


def test_trainer_checkpoint_written(parity_runs):
    _, tt, _, torch_dir = parity_runs
    assert os.path.isdir(os.path.join(torch_dir, "checkpoints", "2"))
    assert os.path.exists(os.path.join(torch_dir, "checkpoints",
                                       "train_params.txt"))
    assert [h["epoch"] for h in tt.history] == [1, 2]


def test_resume_replays_epoch(tmp_path, topology_dir):
    """A run resumed from its epoch-1 checkpoint replays epoch 2 exactly
    (the per-epoch reseed); finetune keeps the weights and restarts the
    schedule."""
    d1 = _workdir(tmp_path / "a", topology_dir)
    tr = TorchTrainer(_port_cfg(ck_frequency=1), d1, device="cpu").fit()
    ck1 = tmp_path / "ck1"
    shutil.copytree(os.path.join(d1, "checkpoints", "1"), ck1 / "1")
    d2 = _workdir(tmp_path / "b", topology_dir)
    tr2 = TorchTrainer(_port_cfg(resume=str(ck1)), d2, device="cpu")
    assert (tr2.start_epoch, tr2.global_step) == (2, 4)
    tr2.fit()
    assert tr2.history[0]["epoch"] == 2
    np.testing.assert_allclose(tr2.history[0]["train"], tr.history[1]["train"],
                               rtol=1e-6)
    for a, b in zip(tree_leaves(params_to_numpy(tr2.params)),
                    tree_leaves(params_to_numpy(tr.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    d3 = _workdir(tmp_path / "c", topology_dir)
    tr3 = TorchTrainer(_port_cfg(resume=os.path.join(d1, "checkpoints"),
                                 finetune=True), d3, device="cpu")
    assert (tr3.start_epoch, tr3.global_step) == (1, 0)
    for a, b in zip(tree_leaves(params_to_numpy(tr3.params)),
                    tree_leaves(params_to_numpy(tr.params))):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_retention(tmp_path):
    from semantichuman_torch.utils.checkpoint import (latest_step,
                                                      restore_checkpoint,
                                                      save_checkpoint)
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), step, {"x": torch.full((3,), step)},
                        max_to_keep=2)
    kept = sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit())
    assert kept == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    state, step = restore_checkpoint(str(tmp_path))
    assert step == 4 and torch.equal(state["x"], torch.full((3,), 4))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_run_segments_protocol(tmp_path):
    """Segments cover the budget with a trailing partial one, each
    evaluates once and appends a curve line, start_epoch moves past each,
    and stop_on_nonfinite stops after a NaN."""
    from semantichuman_torch.train.segments import run_segments

    class FakeTrainer:
        def __init__(self, mms):
            self.start_epoch = 1
            self.fits = []
            self.mms = list(mms)

        def fit(self, seg_end):
            self.fits.append((self.start_epoch, seg_end))

        def evaluate(self):
            mm = self.mms.pop(0)
            return None, None, None, None, mm / 1000.0, mm

    curve = os.path.join(tmp_path, "curve.jsonl")
    tr = FakeTrainer([5.0, 4.0, 3.0])
    recs = run_segments(tr, 25, 10, curve)
    assert tr.fits == [(1, 10), (11, 20), (21, 25)]
    assert [r["epoch"] for r in recs] == [10, 20, 25]
    assert tr.start_epoch == 26
    lines = [json.loads(line) for line in open(curve)]
    assert [line["mm"] for line in lines] == [5.0, 4.0, 3.0]
    assert all("elapsed_sec" in r and "elapsed_sec" not in line
               for r, line in zip(recs, lines))
    tr2 = FakeTrainer([2.0])
    tr2.start_epoch = 21
    recs2 = run_segments(tr2, 25, 10, os.path.join(tmp_path, "c2.jsonl"))
    assert tr2.fits == [(21, 25)] and [r["epoch"] for r in recs2] == [25]
    tr3 = FakeTrainer([5.0, float("nan"), 1.0])
    recs3 = run_segments(tr3, 30, 10, os.path.join(tmp_path, "c3.jsonl"),
                         stop_on_nonfinite=True)
    assert len(recs3) == 2 and tr3.fits == [(1, 10), (11, 20)]


@pytest.mark.parametrize("path", sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_config_file_loads_like_jax(path):
    """Every config file loads into the port's Config with the JAX
    package's values, field for field."""
    want = JaxConfig.from_yaml(str(ROOT / "configs" / path)).to_dict()
    got = TorchConfig.from_yaml(str(ROOT / "configs" / path)).to_dict()
    assert got == want


def test_config_defaults_match_jax():
    assert TorchConfig().to_dict() == JaxConfig().to_dict()
    with pytest.raises(KeyError, match="unknown config key"):
        TorchConfig.from_dict({"train": {"nope": 1}})


def test_topology_key_matches_jax_meta(topology_dir, small_human):
    key = topology_key(small_human.template_verts,
                       small_human.template_faces, (2, 2, 2, 2),
                       (2, 2, 1, 1, 1), (2, 2, 1, 1, 1),
                       min(414, len(small_human.template_verts) - 1))
    assert key == (topology_dir / "topology_2222.npz.meta").read_text()
    bundled = ROOT / "assets" / "topology_synth_full_2222.npz.meta"
    from semantichuman_torch.data.synthetic import SyntheticHuman
    sh = SyntheticHuman()
    assert topology_key(sh.template_verts, sh.template_faces, (2, 2, 2, 2),
                        (2, 2, 1, 1, 1), (2, 2, 1, 1, 1),
                        414) == bundled.read_text()


def test_trainer_refuses_what_is_not_ported(tmp_path, topology_dir,
                                            small_human, monkeypatch):
    """A workdir without a compiled topology, with a stale one or with one
    that has no .meta key gets the hierarchy compiled (the JAX compiler's
    policy: a cache is trusted only where its key matches); a trace
    window and a two-rank world, which once raised, are accepted (the
    window sends training to the loop; rank 1 of 2 takes its slice of
    every batch, writes nothing and takes the loop), and the other ported
    pieces build: a reference checkpoint through
    train.resume_torch (weights only: with finetune, else it raises for
    the missing optimizer state) and model_type neural3DMM (the epoch
    path); an on-disk dataset that is not there raises naming its file;
    the default device is the card."""
    want = np.load(topology_dir / "topology_2222.npz")
    key = (topology_dir / "topology_2222.npz.meta").read_text()
    empty = tmp_path / "empty"
    stale = _workdir(tmp_path / "stale", topology_dir)
    Path(stale, "topology_2222.npz.meta").write_text("other")
    no_meta = _workdir(tmp_path / "no_meta", topology_dir)
    os.remove(os.path.join(no_meta, "topology_2222.npz.meta"))
    # a cache with no key, its spirals scrambled: recompiled, not read
    with np.load(topology_dir / "topology_2222.npz") as z:
        arrays = dict(z)
    arrays["spirals_0"] = arrays["spirals_0"][::-1].copy()
    np.savez(os.path.join(no_meta, "topology_2222.npz"), **arrays)
    for d in (empty, stale, no_meta):
        tr = TorchTrainer(_port_cfg(), str(d), device="cpu")
        np.testing.assert_array_equal(tr.hierarchy.spirals[0],
                                      want["spirals_0"])
        assert Path(d, "topology_2222.npz.meta").read_text() == key
    d = _workdir(tmp_path / "ok", topology_dir)
    tr = TorchTrainer(_port_cfg(profile_stop=5, epoch_scan=True), d,
                      device="cpu")
    assert (tr.trace_window.start, tr.trace_window.stop) == (0, 5)
    assert not tr._epoch_scan_ok()
    with monkeypatch.context() as mp:
        mp.setattr(torch.distributed, "is_initialized", lambda: True)
        mp.setattr(torch.distributed, "get_world_size", lambda: 2)
        mp.setattr(torch.distributed, "get_rank", lambda: 1)
        mp.setattr(torch.distributed, "broadcast", lambda t, src: None)
        mp.setattr(torch.distributed, "barrier", lambda: None)
        tr = TorchTrainer(_port_cfg(data_parallel=True, epoch_scan=True), d,
                          device="cpu")
        assert tr.data_parallel and tr.process_slice == (1, 2)
        assert tr.train_loader.loader.process_slice == (1, 2)
        assert not tr._is_main and tr.logger is None
        assert not tr._epoch_scan_ok()

    from benchmarks.torch_baseline import (build_torch_model,
                                           reference_state_dict)
    from semantichuman_torch.constants import KPS_INDEX_LIST
    from semantichuman_torch.utils.import_torch import import_part_ae_state
    from semantichuman_tpu.topology.compiler import MeshHierarchy
    hier = MeshHierarchy.load(str(topology_dir / "topology_2222.npz"))
    fixture = build_torch_model(
        hier, hier.downsample_part_indices(small_human.part_dict),
        KPS_INDEX_LIST, enc_filters=[3, 8, 8, 16, 16],
        dec_filters=[16, 16, 8, 8, 8])
    ckpt = str(tmp_path / "weights.pth.tar")
    torch.save({"epoch": 5,
                "autoencoder_state_dict": reference_state_dict(fixture)},
               ckpt)
    with pytest.raises(ValueError, match="no optimizer state"):
        TorchTrainer(_port_cfg(resume_torch=ckpt), d, device="cpu")
    tr = TorchTrainer(_port_cfg(resume_torch=ckpt, finetune=True), d,
                      device="cpu")
    assert (tr.start_epoch, tr.global_step, tr.opt_state.count) == (1, 0, 0)
    want = import_part_ae_state(reference_state_dict(fixture), tr.model)
    for a, b in zip(tree_leaves(tr.params), tree_leaves(want)):
        assert torch.equal(a, b)
    cfg = _port_cfg(epoch_scan=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, model_type="neural3DMM"))
    tr = TorchTrainer(cfg, d, device="cpu")
    assert type(tr.model).__name__ == "SpiralAE"
    assert not tr.is_part_model and tr._epoch_scan_ok()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic=False, asset_dir=str(tmp_path / "no_assets")),
        model=_port_cfg().model)
    with pytest.raises(FileNotFoundError, match="template.obj"):
        TorchTrainer(cfg, d, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TorchTrainer(_port_cfg(), d)


def test_cli_train_cpu(tmp_path, topology_dir):
    """`python -m semantichuman_torch.cli.train --device cpu --synthetic
    --epochs 1` trains, checkpoints, evaluates and exports."""
    wd = _workdir(tmp_path / "cli", topology_dir)
    proc = subprocess.run(
        [sys.executable, "-m", "semantichuman_torch.cli.train",
         "--config", str(ROOT / "configs" / "train_synthetic_small.yaml"),
         "--workdir", wd, "--synthetic", "--epochs", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "test per-vertex euclidean (mm)" in proc.stdout
    assert os.path.isdir(os.path.join(wd, "checkpoints", "1"))
    for f in ("predictions.npy", "z_s.npy", "z_kps_s.npy", "tx_s.npy"):
        assert os.path.exists(os.path.join(wd, "predictions", f))


def test_seed_and_meter_match_jax():
    """utils.seeding.as_seed and logging.AverageValueMeter against the JAX
    package's copies."""
    from semantichuman_torch.utils.logging import AverageValueMeter as TM
    from semantichuman_torch.utils.seeding import as_seed as t_seed
    from semantichuman_tpu.utils.logging import AverageValueMeter as JM
    from semantichuman_tpu.utils.seeding import as_seed as j_seed
    for seed in (7, np.int64(3), np.array([0, 11], np.uint32),
                 np.asarray(jax.random.PRNGKey(5))):
        assert t_seed(seed) == j_seed(seed)
    with pytest.raises(TypeError):
        t_seed(np.array([0.5]))
    tm, jm = TM(), JM()
    for v, n in ((1.5, 1), (2.0, 3), (-0.25, 2)):
        tm.add(v, n)
        jm.add(v, n)
    assert (tm.n, tm.mean, tm.std) == (jm.n, jm.mean, jm.std)


def test_obj_export_matches_jax(tmp_path, small_human):
    """The part-coloured template and a skeleton export write the JAX
    package's files byte for byte."""
    from semantichuman_torch.constants import SKL_LIST
    from semantichuman_torch.data.assets import part_color_map as t_colors
    from semantichuman_torch.topology.adjacency import unique_edges as t_edges
    from semantichuman_torch.topology.obj_io import save_obj as t_save
    from semantichuman_tpu.data.assets import part_color_map as j_colors
    from semantichuman_tpu.topology.adjacency import unique_edges as j_edges
    from semantichuman_tpu.topology.obj_io import save_obj as j_save
    v, f = small_human.template_verts, small_human.template_faces
    np.testing.assert_array_equal(t_edges(f), j_edges(f))
    colors = t_colors(small_human.part_dict, len(v))
    np.testing.assert_array_equal(colors,
                                  j_colors(small_human.part_dict, len(v)))
    kps = small_human.J_regressor @ v
    for name, kw in (("parts", {"vert_colors": colors}),
                     ("skeleton", {"kps": kps, "skl_list": SKL_LIST,
                                   "samples_per_bone": 5})):
        t_save(str(tmp_path / f"t_{name}.obj"), v, f, **kw)
        j_save(str(tmp_path / f"j_{name}.obj"), v, f, **kw)
        assert (tmp_path / f"t_{name}.obj").read_bytes() == \
            (tmp_path / f"j_{name}.obj").read_bytes()
