"""chip_smoke.py's pieces that need no card: its modes, the kernel families
its step profile reports, the launch literals of the main paths, and the
batches at which phase 2 checks the conv forward."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tests.test_torch_trainer import topology_dir  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "semantichuman_torch" / "csrc"


def _kernels(source):
    """The __global__ functions of a CUDA source, by name."""
    chunks = (CSRC / source).read_text().split("__global__")[1:]
    return [re.search(r"(\w+)\(", re.sub(r"__launch_bounds__\([^)]*\)",
                                         "", c)).group(1) for c in chunks]


@pytest.mark.parametrize("argv,mode", [
    ([], (False, False, False)), (["--conv-forward"], (True, False, False)),
    (["--conv-backward"], (False, True, False)),
    (["--part-dist"], (False, False, True))])
def test_modes_parse(argv, mode):
    args = CS.parse_args(argv)
    assert (args.conv_forward, args.conv_backward, args.part_dist) == mode


@pytest.mark.parametrize("argv", [["--conv-forward", "--conv-backward"],
                                  ["--part-dist", "--conv-forward"],
                                  ["--conv"], ["extra"]])
def test_modes_refuse_the_rest(argv):
    with pytest.raises(SystemExit):
        CS.parse_args(argv)


def _families(label):
    return [g for g, key in CS.PROFILE_GROUPS.items() if key in label]


def test_profile_groups_split_the_two_forward_kernels():
    """Every kernel of csrc/spiral_conv_fwd.cu falls in `conv_fwd` and in
    no other family."""
    kernels = _kernels("spiral_conv_fwd.cu")
    assert sorted(kernels) == ["sc_fwd_narrow_kernel", "sc_fwd_tile_kernel"]
    for name in kernels:
        label = f"void (anonymous namespace)::{name}<float, 128>(float)"
        assert _families(label) == ["conv_fwd"]


def test_profile_groups_split_the_two_part_dist_kernels():
    """Every kernel of csrc/part_dist.cu falls in `part_dist` and in no
    other family."""
    kernels = _kernels("part_dist.cu")
    assert sorted(kernels) == ["part_dist_rows_finish_kernel",
                               "part_dist_rows_kernel"]
    for name in kernels:
        label = f"void (anonymous namespace)::{name}<1>(float const*)"
        assert _families(label) == ["part_dist"]


def test_profile_groups_split_the_two_csr_kernels():
    """Every kernel of csrc/csr_reduce.cu falls in `csr_reduce` and in no
    other family."""
    kernels = _kernels("csr_reduce.cu")
    assert sorted(kernels) == ["csr_rows_finish_kernel", "csr_rows_kernel",
                               "csr_rows_long_kernel"]
    for name in kernels:
        label = f"void (anonymous namespace)::{name}<4, 4, true>(float4)"
        assert _families(label) == ["csr_reduce"]


def test_csr_reduce_mode_parses():
    args = CS.parse_args(["--csr-reduce"])
    assert args.csr_reduce and not (args.conv_forward or args.conv_backward
                                    or args.part_dist or args.gather_rows)
    assert not CS.parse_args([]).csr_reduce
    with pytest.raises(SystemExit):
        CS.parse_args(["--csr-reduce", "--gather-rows"])


def test_launch_literals():
    """KERNEL_COUNTS names every kernel counter `launches.read()` reports
    and each literal counts only those; the Trainer's default step at
    batch 12 is the take route (both gates closed): 9 conv forwards and
    dW, every dx half of the 8 convs with one unfused (a csr_reduce
    each), and every row gather with a gradient adds one csr_reduce (its
    backward); the forced banded arm keeps the counts of the JAX gates:
    4 take-route convs, 4 unfused dx and 7 fix-up backwards."""
    from semantichuman_torch.ops import launches

    assert set(CS.KERNEL_COUNTS) == {k for k, v in launches.read().items()
                                     if isinstance(v, int)}
    assert [CS.SERVE_LAUNCHES[r]["spiral_conv_fwd"]
            for r in ("small", "large", "take")] == [4, 9, 9]
    assert CS.STEP_LAUNCHES["spiral_conv_fwd"] == 9
    assert CS.TRAIN_LAUNCHES["spiral_conv_fwd"] == 9
    assert CS.TRAIN_LAUNCHES["spiral_conv_bwd_dx"] == 0
    assert CS.TRAIN_LAUNCHES["csr_reduce"] == 8 + (
        CS.ENCODE_GATHER_GRADS + CS.UNPOOL_GATHERS
        + CS.LOSS_GATHER_GRADS) == 24
    assert CS.expect(CS.TRAIN_LAUNCHES)["banded_gather_fwd"] == 0
    assert CS.expect(CS.VAL_LAUNCHES)["banded_gather_fwd"] == 0
    assert CS.TRAIN_LAUNCHES_BANDED["spiral_conv_fwd"] == 4
    assert CS.TRAIN_LAUNCHES_BANDED["csr_reduce"] == 7 + 4 + (
        CS.ENCODE_GATHER_GRADS + CS.LOSS_GATHER_GRADS) == 23
    assert CS.STEP_LAUNCHES["csr_reduce"] == 17
    assert CS.STEP_LAUNCHES["part_dist_fwd_grad"] == 2
    assert CS.TRAIN_LAUNCHES["part_dist_fwd_grad"] == 2
    for table in (CS.STEP_LAUNCHES, CS.TRAIN_LAUNCHES,
                  CS.TRAIN_LAUNCHES_BANDED, *CS.SERVE_LAUNCHES.values()):
        assert set(table) <= set(CS.KERNEL_COUNTS)


def _trainer_batches():
    """The Trainer's trunk batch and its validation batch (one batch of
    every test mesh)."""
    return (CS.TRAINER_TRUNK_B, CS.trainer_cfg().data.synthetic_test)


@pytest.mark.parametrize("path,batches", [
    ("serving", lambda: CS.SERVE_BATCHES), ("step", lambda: (CS.TRUNK_B,)),
    ("trainer", _trainer_batches)])
def test_forward_phase_covers_the_main_paths(path, batches):
    """Phase 2 holds the forward kernel against its plain version at every
    batch at which a main path runs it."""
    assert set(batches()) <= set(CS.FWD_BATCHES), path
    assert set(CS.FWD_TIMED) <= set(CS.FWD_BATCHES)


def test_trainer_mode_parses():
    args = CS.parse_args(["--trainer"])
    assert args.trainer and not (args.conv_forward or args.csr_reduce)
    assert not CS.parse_args([]).trainer
    with pytest.raises(SystemExit):
        CS.parse_args(["--trainer", "--part-dist"])


def test_graph_launch_literals():
    """The epoch path's captured step is the 'dynamic' exchange variant:
    the volume term (one face gather and its backward) runs on every step,
    so it launches what a loop step that drew 'ori' does, the 'm' draw's
    fewer launches never apply; it counts only the kernels KERNEL_COUNTS
    names."""
    assert CS.GRAPH_LAUNCHES == CS.TRAIN_LAUNCHES
    assert CS.GRAPH_LAUNCHES_BANDED == CS.TRAIN_LAUNCHES_BANDED
    assert CS.GRAPH_LAUNCHES["row_gather"] == 6 + 4 + 11
    assert CS.GRAPH_LAUNCHES["csr_reduce"] == 24
    assert CS.GRAPH_LAUNCHES_BANDED["row_gather"] == 6 + 8 + 11
    assert CS.GRAPH_LAUNCHES_BANDED["csr_reduce"] == 23
    assert set(CS.M_VARIANT_FEWER) <= set(CS.GRAPH_LAUNCHES)
    assert set(CS.GRAPH_LAUNCHES) <= set(CS.KERNEL_COUNTS)


@pytest.mark.parametrize("flag,attr", [("--dfaust", "dfaust"),
                                       ("--band-gates", "band_gates")])
def test_dfaust_and_gate_modes_parse(flag, attr):
    args = CS.parse_args([flag])
    assert getattr(args, attr) and not (args.trainer or args.conv_forward)
    assert not getattr(CS.parse_args([]), attr)
    with pytest.raises(SystemExit):
        CS.parse_args([flag, "--trainer"])


def test_forced_gates_are_the_jax_gates_and_the_port_closed_both():
    """The forced banded arms open the gates the JAX package sets; the
    port's own gates are closed (the card's measurements)."""
    from semantichuman_torch.ops import sampling as TS
    from semantichuman_tpu.ops import sampling as JS
    import importlib
    tc = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    jc = importlib.import_module("semantichuman_tpu.ops.spiral_conv")
    assert CS.FORCED_GATES == (jc._BANDED_MAX_B, JS._UNPOOL_BAND_MAX_B)
    assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (0, 0)
    with CS.band_gates(*CS.FORCED_GATES):
        assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (16, 128)
    assert (tc._BANDED_MAX_B, TS._UNPOOL_BAND_MAX_B) == (0, 0)


@pytest.mark.parametrize("stacked", [True, False])
def test_dfaust_config_overrides_only_the_dataset(tmp_path, stacked):
    """Phase 8's config is configs/train_dfaust.yaml with root_dir,
    asset_dir and n_val set (and from_stacked off for the per-sample
    layout): the bf16 trunk, banded_conv off and every other field as
    the file has them."""
    from semantichuman_torch.config import Config
    path = CS.dfaust_config(tmp_path / "DF", tmp_path / "c.yaml", stacked)
    got = Config.from_yaml(path).to_dict()
    want = Config.from_yaml(str(CS.DFAUST_CONFIG)).to_dict()
    want["data"].update(root_dir=str(tmp_path / "DF"),
                        asset_dir=str(tmp_path / "DF" / "asset"),
                        n_val=CS.DFAUST_VAL, from_stacked=stacked)
    assert got == want
    assert got["model"]["trunk_dtype"] == "bfloat16"
    assert got["model"]["banded_conv"] is False


def test_baseline_mode_parses():
    args = CS.parse_args(["--baseline"])
    assert args.baseline and not (args.trainer or args.dfaust)
    assert not CS.parse_args([]).baseline
    with pytest.raises(SystemExit):
        CS.parse_args(["--baseline", "--dfaust"])


def test_n3dmm_config_overrides_only_the_dataset(tmp_path):
    """Phase 9's config is configs/train_neural3dmm.yaml with root_dir,
    asset_dir, n_val, the epochs and the loop (epoch_scan off) set: nz
    256, B 16, zeroroot and banded_conv off as the file has them."""
    from semantichuman_torch.config import Config
    path = CS.n3dmm_config(tmp_path / "DF", tmp_path / "c.yaml")
    got = Config.from_yaml(path).to_dict()
    want = Config.from_yaml(str(CS.N3DMM_CONFIG)).to_dict()
    want["data"].update(root_dir=str(tmp_path / "DF"),
                        asset_dir=str(tmp_path / "DF" / "asset"),
                        n_val=CS.DFAUST_VAL)
    want["train"].update(n_epochs=CS.N3DMM_EPOCHS, epoch_scan=False)
    assert got == want
    assert (got["model"]["model_type"], got["model"]["nz"],
            got["train"]["batch_train"], got["data"]["normalization"],
            got["model"]["banded_conv"]) == ("neural3DMM", 256, 16,
                                             "zeroroot", False)


def test_n3dmm_epoch_config_is_the_file_as_written(tmp_path):
    """Phase 9's second run is configs/train_neural3dmm.yaml with only
    root_dir, asset_dir, n_val and the epochs set: epoch_scan stays on as
    the file (and the Trainer's default) has it, so the baseline takes
    the epoch path."""
    from semantichuman_torch.config import Config
    path = CS.n3dmm_config(tmp_path / "DF", tmp_path / "c.yaml", loop=False)
    got = Config.from_yaml(path).to_dict()
    want = Config.from_yaml(str(CS.N3DMM_CONFIG)).to_dict()
    want["data"].update(root_dir=str(tmp_path / "DF"),
                        asset_dir=str(tmp_path / "DF" / "asset"),
                        n_val=CS.DFAUST_VAL)
    want["train"]["n_epochs"] = CS.N3DMM_EPOCHS
    assert got == want and got["train"]["epoch_scan"] is True


def test_n3dmm_launch_literals():
    """A neural3DMM step at B = 16: 9 conv forwards and dW, every dx half
    of the 8 convs with one on the unfused route (a csr_reduce each), 9 row
    gathers (4 pools, 4 unpools, edgereg's face gather), each with a
    gradient; a val batch 9 forwards and 8 gathers; no part_dist or banded
    launch."""
    t, v = CS.TRAIN_LAUNCHES_N3DMM, CS.VAL_LAUNCHES_N3DMM
    assert (t["spiral_conv_fwd"], t["spiral_conv_bwd_dw"],
            t["spiral_conv_bwd_dx"], t["row_gather"],
            t["csr_reduce"]) == (9, 9, 0, 9, 17)
    assert (v["spiral_conv_fwd"], v["row_gather"]) == (9, 8)
    for table in (t, v):
        for k in CS.KERNEL_COUNTS:
            if k.startswith(("part_dist", "banded")):
                assert CS.expect(table)[k] == 0


@pytest.fixture(scope="module")
def small_models(small_hierarchy, small_human, tmp_path_factory):
    """(port PartAE, port SpiralAE) of the small test size."""
    import dataclasses

    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from tests.conftest import SMALL_MODEL_OVERRIDES

    path = tmp_path_factory.mktemp("writer") / "hier.npz"
    small_hierarchy.save(str(path))
    hier = MeshHierarchy.load(str(path))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    over = {k: v for k, v in SMALL_MODEL_OVERRIDES.items() if k in fields}
    return (build_model(ModelConfig(**over), hier, small_human.part_dict,
                        device="cpu"),
            build_model(ModelConfig(**over, model_type="neural3DMM", nz=16),
                        hier, device="cpu"))


def test_baseline_step_gathers_match_the_launch_literals(small_models,
                                                         small_human,
                                                         monkeypatch):
    """One baseline step on staged GT edge lengths runs as many row
    gathers and gather backwards as TRAIN_LAUNCHES_N3DMM counts on the
    card (its csr_reduce launches but the 8 unfused dx halves')."""
    from semantichuman_torch.ops import row_gather as RG
    from semantichuman_torch.ops.distance import face_edge_lengths
    from semantichuman_torch.train import losses as TL
    from semantichuman_torch.train import step as TS
    from semantichuman_torch.train.optim import make_optimizer

    _, model = small_models
    tables = TL.build_loss_tables(small_human.template_faces,
                                  small_human.J_regressor,
                                  small_human.part_dict, device="cpu")
    meshes = small_human.sample_meshes(2, seed=5).astype(np.float32)
    v = torch.from_numpy(np.concatenate(
        [meshes, np.zeros((2, 1, 3), np.float32)], 1))
    with torch.no_grad():
        batch = {"verts": v,
                 "gt_face_edges": face_edge_lengths(v[:, :-1], tables.faces)}
    opt = make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    step = TS.make_baseline_train_step(model, tables, opt, TS.StepFlags())
    params = model.init(0)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = RG.gather_rows_fwd, RG.csr_reduce

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(RG, "gather_rows_fwd", count("fwd", fwd))
    monkeypatch.setattr(RG, "csr_reduce", count("bwd", bwd))
    _p, _s, metrics = step(params, opt.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert calls["fwd"] == CS.TRAIN_LAUNCHES_N3DMM["row_gather"] == 9
    assert calls["bwd"] == CS.TRAIN_LAUNCHES_N3DMM["csr_reduce"] - 8


def test_reference_writer_matches_the_fixture_layout(small_models,
                                                     small_hierarchy,
                                                     small_human):
    """Phase 9's reference-layout writer gives
    `benchmarks/torch_baseline.reference_state_dict`'s keys, key order and
    shapes on the small topology, and its output imports back to the same
    contiguous parameters, for both model families."""
    from benchmarks.torch_baseline import (build_torch_model,
                                           reference_state_dict)
    from semantichuman_torch.utils import import_torch as TI
    from semantichuman_torch.utils.params import tree_leaves
    from semantichuman_tpu.constants import KPS_INDEX_LIST

    part, spiral = small_models
    fixture = build_torch_model(
        small_hierarchy,
        small_hierarchy.downsample_part_indices(small_human.part_dict),
        KPS_INDEX_LIST, enc_filters=[3, 8, 8, 16, 16],
        dec_filters=[16, 16, 8, 8, 8])
    want = reference_state_dict(fixture)
    for model, importer in ((part, TI.import_part_ae_state),
                            (spiral, TI.import_spiral_ae_state)):
        params = model.init(3)
        got = CS.reference_state_dict(params, model)
        if model is part:
            assert [(k, tuple(t.shape)) for k, t in got.items()] == \
                [(k, tuple(t.shape)) for k, t in want.items()]
        else:
            assert list(got)[-2:] == ["dconv.4.conv.weight",
                                      "dconv.4.conv.bias"]
            assert list(got)[8:12] == [
                "fc_latent_enc.weight", "fc_latent_enc.bias",
                "fc_latent_dec.weight", "fc_latent_dec.bias"]
        assert all(t.is_contiguous() for t in got.values())
        back = importer(got, model)
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert a.is_contiguous() and torch.equal(a, b)


def _small_trainer_cfg(family, **train):
    from semantichuman_torch.config import Config
    from tests.conftest import SMALL_MODEL_OVERRIDES
    model = dict(SMALL_MODEL_OVERRIDES, banded_conv=False)
    if family == "neural3DMM":
        model.update(model_type="neural3DMM", nz=16)
    return Config.from_dict({
        "model": model,
        "data": {"synthetic": True, "synthetic_train": 8,
                 "synthetic_test": 4, "synthetic_n_theta": 16,
                 "synthetic_n_phi": 36, "normalization": "zeroroot"},
        "train": {"n_epochs": 3, "batch_train": 4, "batch_interp": 4,
                  "batch_test": 4, "ck_frequency": 2, "save_recons": False,
                  "epoch_scan": family != "neural3DMM", **train}})


@pytest.mark.parametrize("family", ["multiz+partkps", "neural3DMM"])
def test_resume_round_trip_is_bit_equal_on_the_cpu(tmp_path, topology_dir,
                                                   family, monkeypatch):
    """Phase 9 (b) at the small size on the CPU: a 2-epoch fit's
    checkpoint written in the reference's layout and resumed through
    train.resume_torch repeats the native resume's epoch 3 bit for bit
    (loss and parameters); the writer refuses a part-head pad that is
    not 0."""
    from semantichuman_torch.train.loop import Trainer
    from semantichuman_torch.utils.checkpoint import restore_checkpoint
    from tests.test_torch_trainer import _workdir

    monkeypatch.setattr(CS, "DEVICE", "cpu")
    fit = Trainer(_small_trainer_cfg(family),
                  _workdir(tmp_path / "fit", topology_dir), device="cpu")
    fit.fit(2)
    ckpt = str(Path(fit.workdir) / "checkpoints")
    out = CS.resume_round_trip(
        family, _small_trainer_cfg(family),
        lambda tag: _workdir(tmp_path / tag, topology_dir), ckpt, tmp_path,
        lambda tr: CS.read_counts())
    assert out["epoch3_loss"] > 0 and not list(tmp_path.glob("*.pth.tar"))
    if family == "multiz+partkps":
        state, _ = restore_checkpoint(ckpt)
        m = fit.model
        p = next(i for i, n in enumerate(m.part_sizes) if n < m.n_max)
        state["params"]["enc_heads"]["w"][p, -1, 0] = 1.0
        with pytest.raises(CS.SmokeFailure, match="pads of the params"):
            CS.write_reference_checkpoint(str(tmp_path / "x.pth.tar"),
                                          state, fit.model,
                                          fit.cfg.train)


# --- phase 10: editing and deployment -----------------------------------------

def test_deploy_mode_parses():
    """--deploy runs phase 1 and phase 10 alone; it excludes the other
    modes, and a run without arguments runs every phase."""
    args = CS.parse_args(["--deploy"])
    assert args.deploy and not (args.trainer or args.baseline
                                or args.dfaust or args.conv_forward)
    assert not CS.parse_args([]).deploy
    with pytest.raises(SystemExit):
        CS.parse_args(["--deploy", "--baseline"])


def test_deploy_launch_literals():
    """An encode and a decode make one forward; run_demo's calls (7
    encodes, 5 decodes, 2 keypoint encodes) give its launches, rows 1 and
    7 alone; a capture counts its warm-ups and itself."""
    enc, dec = CS.expect(CS.ENCODE_LAUNCHES), CS.expect(CS.DECODE_LAUNCHES)
    take = CS.expect(CS.SERVE_LAUNCHES["take"])
    assert {k: enc[k] + dec[k] for k in CS.KERNEL_COUNTS} == take
    demo = CS.demo_launches()
    assert (demo["spiral_conv_fwd"], demo["row_gather"]) == (
        7 * 4 + 5 * 5, 7 * 6 + 5 * 4 + 2)
    assert all(n == 0 for k, n in demo.items()
               if k not in ("spiral_conv_fwd", "row_gather"))
    assert CS.GRAPH_WARMUPS == 2
    assert CS.EDIT_BATCHES == (1, 4)


def test_run_demo_launches_match_the_literals(small_models, small_human,
                                              tmp_path, monkeypatch):
    """One run_demo on the CPU calls the conv forward and the row gather
    as often as phase 10 counts their launches on the card (the small
    model has the default model's 4 encoder and 5 decoder convs)."""
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.edit import Editor, run_demo
    from semantichuman_torch.ops import row_gather as RG
    import importlib
    sc = importlib.import_module("semantichuman_torch.ops.spiral_conv")

    model = small_models[0]
    assert (len(model.enc_plan), len(model.dec_plan)) == (4, 5)
    assets = BodyAssets(
        template_verts=small_human.template_verts,
        template_faces=small_human.template_faces,
        j_regressor=small_human.J_regressor,
        part_dict=small_human.part_dict,
        girth_edges=small_human.girth_edges,
        girth_factors=small_human.girth_factors)
    editor = Editor(model, model.init(0), assets, device="cpu")
    calls = {"spiral_conv_fwd": 0, "row_gather": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(sc, "_forward", count("spiral_conv_fwd",
                                              sc._forward))
    monkeypatch.setattr(RG, "gather_rows_fwd", count("row_gather",
                                                     RG.gather_rows_fwd))
    meshes = small_human.sample_meshes(4, seed=2).astype(np.float32)
    run_demo(editor, meshes, str(tmp_path))
    demo = CS.demo_launches()
    assert calls == {k: demo[k] for k in calls}


@pytest.mark.parametrize("runs, gate", [
    ({1: ([2.0, 2.2], [0.3, 0.3]), 16: ([2.5, 2.3], [0.9, 0.9]),
      64: ([2.33, 2.33], [2.29, 2.29])}, 64),
    ({1: ([2.0, 2.2], [0.3, 0.3]), 16: ([2.5, 2.3], [0.9, 0.9]),
      64: ([2.3, 2.3], [2.4, 2.3])}, 16),
    ({1: ([2.0, 2.0], [0.3, 0.3]), 16: ([1.0, 1.0], [1.1, 1.1]),
      64: ([3.0, 3.0], [2.0, 2.0])}, 1),
    ({1: ([0.2, 0.2], [0.3, 0.3]), 16: ([1.0, 1.0], [0.5, 0.5])}, 0),
])
def test_graph_gate_rule(runs, gate):
    """_GRAPH_MAX_B's rule: the largest batch at which the captured
    forward's mean beats the eager program's there and at every smaller
    batch measured; the serving constant is such a batch."""
    from semantichuman_torch import serving as SV

    assert CS.graph_gate({b: {"eager": e, "graph": g}
                          for b, (e, g) in runs.items()}) == gate
    assert SV._GRAPH_MAX_B in (0,) + CS.SERVE_BATCHES


def test_no_plain_on_card_counts_cuda_calls_only(small_models):
    """The phase's fallback probe counts plain-version calls on CUDA
    tensors alone and restores both functions."""
    import importlib

    from semantichuman_torch.ops import row_gather as RG
    sc = importlib.import_module("semantichuman_torch.ops.spiral_conv")
    saved = sc.spiral_conv_plain, RG.gather_rows_plain
    model = small_models[0]
    x = torch.zeros((1, model.tables.sizes[0] + 1, 3))
    kps = torch.zeros((1, 32, 3))
    with CS.no_plain_on_card() as calls, torch.no_grad():
        model(model.init(0), x, kps)
    assert calls == {"spiral_conv_plain": 0, "gather_rows_plain": 0}
    assert (sc.spiral_conv_plain, RG.gather_rows_plain) == saved


def test_device_ms_takes_the_larger_of_two_windows(monkeypatch):
    """An empty profiling window is taken again with twice the calls; the
    time is the larger of two windows' times a call (a window whose events
    the profiler dropped in part reads low)."""
    import types

    import torch.profiler as TP

    # events of 10 us per window, at 20, 20 and 40 calls
    windows = iter([10, 0, 80])

    class FakeProfile:
        def __init__(self, *a, **k):
            n = next(windows)
            self._events = [types.SimpleNamespace(
                device_type=torch.autograd.DeviceType.CUDA,
                time_range=types.SimpleNamespace(elapsed_us=lambda: 10.0))
                for _ in range(n)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(CS, "DEVICE", "cuda")
    monkeypatch.setattr(TP, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    # 0.005 ms a call in the first window, 0.02 in the third
    assert CS.device_ms(lambda: calls.append(1)) == pytest.approx(0.02)
    assert len(calls) == 1 + 20 + 20 + 40
    windows = iter([0, 0, 40])
    with pytest.raises(CS.SmokeFailure, match="device time in 1 of 3"):
        CS.device_ms(lambda: None, attempts=3)


def test_device_by_name_takes_the_larger_of_two_windows(monkeypatch):
    """Per kernel name, the larger of two windows' times a call; an empty
    window is taken again."""
    import types

    import torch.profiler as TP

    windows = iter([{"a": 2, "b": 3}, {}, {"a": 3, "b": 1}])

    class FakeProfile:
        def __init__(self, *a, **k):
            self._events = [types.SimpleNamespace(
                name=name, device_type=torch.autograd.DeviceType.CUDA,
                time_range=types.SimpleNamespace(elapsed_us=lambda: 10.0))
                for name, n in next(windows).items() for _ in range(n)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(TP, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = CS.device_by_name(lambda: None, reps=10)
    assert got == pytest.approx({"a": 0.003, "b": 0.003})


def test_deploy_paths_join_the_kernels_line():
    """Phase 10's four counted paths (one run_demo, the eager programs,
    the captures, cli.eval_reference on the card) go into the kernels
    line's launches_by_path beside the other phases' paths, which the
    kernels line holds to KERNEL_COUNTS."""
    import inspect

    deploy = inspect.getsource(CS.phase_deploy)
    counts = deploy[deploy.index('out["counts"] = {'):]
    counts = counts[:counts.index("}")]
    assert re.findall(r'"(\w+)":', counts) == [
        "edit", "export_serve", "graph_serve", "eval_reference"]
    main = inspect.getsource(CS.main)
    assert "**deploy_counts" in main
    assert "for k in KERNEL_COUNTS:" in main


def test_parallel_mode_parses():
    assert CS.parse_args(["--parallel"]).parallel
    assert not CS.parse_args([]).parallel
    with pytest.raises(SystemExit):
        CS.parse_args(["--parallel", "--deploy"])


def test_parallel_paths_join_the_kernels_line():
    """Phase 11's five counted paths (both DP runs' ranks, the traced
    fit, the geometry checks, the serving A/B) go into the kernels line's
    launches_by_path beside the other phases' paths."""
    import inspect

    dp = inspect.getsource(CS.phase_dp)
    assert re.findall(r'\{"(dp_\w+)": rank_counts', dp) == ["dp_gloo"]
    assert '"dp_nccl1": rank_counts' in dp
    par = inspect.getsource(CS.phase_parallel)
    assert re.findall(r'counts\["(\w+)"\]', par) == [
        "trace", "geometry", "serving_ab"]
    assert "**parallel_counts}" in inspect.getsource(CS.main)


def test_dp_run_is_the_paper_recipe_per_rank():
    """Phase 11's configuration: Config() but the global batches of 8
    (the paper recipe's batch on each of DP_WORLD ranks), the synthetic
    split of 24 / 16 (3 steps an epoch), the loop, every step logged and
    a checkpoint an epoch."""
    import dataclasses

    from semantichuman_torch.config import Config
    cfg, base = Config.from_dict(CS.dp_raw(2)), Config()
    assert cfg.model == base.model
    t = cfg.train
    assert (t.batch_train, t.batch_interp, t.batch_test) == (8, 8, 8)
    assert t.batch_train // CS.DP_WORLD == base.train.batch_train
    assert cfg.data.synthetic_train // t.batch_train == 3
    assert (t.n_epochs, t.epoch_scan, t.log_every, t.ck_frequency) == (
        2, False, 1, 1)
    changed = {f.name for f in dataclasses.fields(t)
               if getattr(t, f.name) != getattr(base.train, f.name)}
    assert changed == {"batch_train", "batch_interp", "batch_test",
                       "n_epochs", "epoch_scan", "log_every",
                       "ck_frequency", "save_recons"}


def test_trace_families_read_a_chrome_trace(tmp_path):
    """Kernel events are counted by family; operators are not."""
    events = [{"cat": "kernel", "name": "void sc_fwd_tile<float>(...)"},
              {"cat": "kernel", "name": "csr_rows_short_kernel"},
              {"cat": "kernel", "name": "csr_rows_short_kernel"},
              {"cat": "cpu_op", "name": "aten::index_add_"},
              {"cat": "kernel", "name": "gather_copy_kernel<16>"}]
    path = tmp_path / "t.json"
    path.write_text(__import__("json").dumps({"traceEvents": events}))
    fam = CS.trace_families(str(path))
    assert (fam["conv_fwd"], fam["csr_reduce"], fam["row_gather"],
            fam["index_add"], fam["part_dist"]) == (1, 2, 1, 0, 0)


def _ranks(params, grads, world=2, start=1, val=0.5):
    arrays = {**{f"param:{k}": v for k, v in params.items()},
              **{f"grad{i}:{k}": v for i, g in enumerate(grads, start=1)
                 for k, v in g.items()}}
    return [({"rank": r, "world": world, "start_epoch": start, "val": val,
              "device": "cpu"}, {k: v.copy() for k, v in arrays.items()})
            for r in range(world)]


def _log(workdir, losses):
    d = Path(workdir, "summaries")
    d.mkdir(parents=True)
    (d / "metrics.jsonl").write_text("".join(
        __import__("json").dumps({"step": s, "loss": v, "gnorm": 1.0,
                                  "time": 0.0}) + "\n"
        for s, v in losses.items()))


def test_dp_compare_holds_the_tolerances(tmp_path):
    """Equal runs pass (exact too); a loss beyond rtol 2e-4, a first-step
    gradient beyond 1e-5 of its tensor's largest entry, a val beyond rtol
    1e-4 and ranks that differ are each reported; a later step's gradient
    and a parameter beyond rtol 1e-4 / atol 1e-6 are reported (the
    parameter with the one-process run's gradients and the decay term at
    its largest difference) and fail only an exact comparison."""
    w = np.linspace(-1, 1, 11).astype(np.float32)
    g = [{"w": w * 1e-3}, {"w": w * 2e-3}]
    ref = {"metrics": {1: {"loss": 0.5, "gnorm": 1.0},
                       2: {"loss": 0.4, "gnorm": 1.0}},
           "params": {0: {"w": w}, 2: {"w": w + 1e-3}},
           "grads": dict(enumerate(g, start=1)), "val": {2: 0.5}}
    final = {"w": w + 1e-3}
    _log(tmp_path / "ok", {1: 0.5, 2: 0.4})
    for exact in (False, True):
        res = CS.dp_compare("t", _ranks(final, g), tmp_path / "ok", ref,
                            (1, 2), exact=exact)
        assert res["failures"] == [] and res["loss_max_rel"] == 0.0
    _log(tmp_path / "off", {1: 0.5, 2: 0.4 * (1 + 3e-4)})
    ranks = _ranks(final, g, val=0.5 * (1 + 2e-4))
    ranks[0][1]["grad1:w"][3] += 1e-7
    ranks[0][1]["grad2:w"][3] += 1e-7
    ranks[0][1]["param:w"][3] += 1e-3
    res = CS.dp_compare("t", ranks, tmp_path / "off", ref, (1, 2))
    fails = res["failures"]
    assert len(fails) == 4
    assert ["gradients" in fails[0], "losses" in fails[1],
            "val" in fails[2], "rank 1" in fails[3]] == [True] * 4
    at = res["params_beyond"]["w"]
    assert (at["n"], at["ref_grads"], at["decay_term"]) == (
        1, [float(g[0]["w"][3]), float(g[1]["w"][3])],
        float(CS.DP_DECAY * w[3]))
    ok = _ranks(final, g)
    for _j, a in ok:
        a["param:w"][3] += 1e-5
        a["grad1:w"][3] *= 1 + 5e-6
    assert CS.dp_compare("t", ok, tmp_path / "ok", ref,
                         (1, 2))["failures"] == []
    assert len(CS.dp_compare("t", ok, tmp_path / "ok", ref, (1, 2),
                             exact=True)["failures"]) == 2
    later = _ranks(final, g)
    for _j, a in later:
        a["grad2:w"][3] += 1e-7
    assert CS.dp_compare("t", later, tmp_path / "ok", ref,
                         (1, 2))["failures"] == []
    assert CS.dp_compare("t", ranks, tmp_path / "off", ref, (1, 2),
                         same_start=False)["failures"][0].startswith(
                             "t: step losses")


# --- phase 12: data-parallel serving and the drill ----------------------------

def test_drill_mode_parses():
    """--drill runs phase 1 and phase 12 alone and excludes the other
    modes."""
    assert CS.parse_args(["--drill"]).drill
    assert not CS.parse_args([]).drill
    with pytest.raises(SystemExit):
        CS.parse_args(["--drill", "--deploy"])


def test_dp_drill_paths_join_the_kernels_line():
    """Phase 12's two counted paths (the two copies' calls, the drill's
    stages) go into the kernels line's launches_by_path, and phase 12 runs
    last in the full run's shared directory."""
    import inspect

    src = inspect.getsource(CS.phase_dp_drill)
    assert re.findall(r'"(\w+)": (?:serve|drill)_counts', src) == [
        "serve_dp", "drill"]
    main = inspect.getsource(CS.main)
    assert "**dp_drill_counts, " in main
    assert main.index("phase_parallel(card, Path(tmp)") < main.index(
        "phase_dp_drill(card, Path(tmp)") < main.index(
        'dp_drill_counts = dp_drill.pop("counts")')


def test_drill_launch_literals():
    """Each drill stage's launches as the main paths' literals give them:
    none for the assets and the topology, one take-route forward for the
    import, the test batches and the train split's staging for the eval,
    one run_demo and the staging for the demo, and for the resumed epoch
    on the epoch path its warm-ups and capture, its evaluation batches and
    the staging; the stages are the drill's six; each artifact's per-shard
    launches add up to a forward."""
    from semantichuman_torch.tools.dfaust_drill import STAGES

    want = CS.drill_launches({"resume": {"eval_batches": 2}}, 1)
    assert set(want) == set(STAGES)
    assert want["assets"] == want["topology"] == CS.expect({})
    assert want["import"] == CS.expect(CS.SERVE_LAUNCHES["take"])
    assert want["eval"]["spiral_conv_fwd"] == 9
    assert want["eval"]["row_gather"] == 11 + CS.STAGE_GATHERS
    assert want["demo"]["row_gather"] == (CS.demo_launches()["row_gather"]
                                          + CS.STAGE_GATHERS)
    res = want["resume"]
    assert (res["spiral_conv_fwd"], res["spiral_conv_bwd_dw"],
            res["part_dist_fwd_grad"]) == (3 * 9 + 2 * 9, 27, 6)
    assert res["row_gather"] == 3 * 21 + 2 * 11 + CS.STAGE_GATHERS
    art = CS.ARTIFACT_LAUNCHES
    assert {k: CS.expect(art["encode"])[k] + CS.expect(art["decode"])[k]
            for k in CS.KERNEL_COUNTS} == CS.expect(art["forward"])
    assert all(b % CS.DP_SERVE_COPIES == 0 for b in CS.DP_SERVE_BATCHES)


def test_copy_probe_and_gaps_on_the_cpu(small_models, small_human, tmp_path,
                                        monkeypatch):
    """copy_probe records each copy's call with its shard batch and
    launches (none on the CPU), and gaps reads the largest absolute and
    relative difference of the gathered shards from the one-device call."""
    from semantichuman_torch.serving import ServingBundle, export_inference

    monkeypatch.setattr(CS, "DEVICE", "cpu")
    model, _ = small_models
    export_inference(model, model.init(0), small_human.J_regressor,
                     str(tmp_path))
    m = small_human.sample_meshes(4, seed=2).astype(np.float32)
    v = np.concatenate([m, np.zeros((4, 1, 3), np.float32)], 1)
    one = ServingBundle(str(tmp_path), device="cpu")
    two = ServingBundle(str(tmp_path), device=["cpu", "cpu"])
    with CS.copy_probe() as calls:
        got = two.forward(v)
    assert [(dev, name, b, graph) for _c, dev, name, b, graph, _n in calls] \
        == [("cpu", "forward", 2, None)] * 2
    assert len({c for c, *_rest in calls}) == 2
    assert all(n == CS.expect({}) for *_rest, n in calls)
    ab, rel = CS.gaps(got.gather(), one.forward(v))
    assert 0 <= ab <= 1e-6 and 0 <= rel
    assert CS.gaps(one.forward(v)[0] + 1.0, one.forward(v)[0])[0] == \
        pytest.approx(1.0)


def test_shard_diagnostic_mode_parses():
    """--shard-diagnostic runs phase 1 and the diagnostic alone and
    excludes the other modes."""
    assert CS.parse_args(["--shard-diagnostic"]).shard_diagnostic
    assert not CS.parse_args([]).shard_diagnostic
    with pytest.raises(SystemExit):
        CS.parse_args(["--shard-diagnostic", "--drill"])


def test_jax_rule_is_the_jax_tests_allclose():
    """jax_rule reads allclose(rtol 2e-6, atol 2e-7) output by output, the
    entries outside it and the largest share of the allowed error; a
    record fails where an eager or a captured reading does."""
    assert (CS.JAX_SERVE_RTOL, CS.JAX_SERVE_ATOL) == (2e-6, 2e-7)
    ref = torch.tensor([0.0, 1.0, -0.5, 1e-9])
    assert CS.jax_rule(ref.clone(), ref) == [True, 0, 4, 0.0]
    near = ref + torch.tensor([1e-7, 0.0, 0.0, 0.0])
    ok, bad, n, share = CS.jax_rule(near, ref)
    assert (ok, bad, n) == (True, 0, 4) and share == pytest.approx(0.5)
    off = ref + torch.tensor([0.0, 3e-6, 0.0, 0.0])
    ok, bad, n, share = CS.jax_rule((near, off), (ref, ref))
    assert (ok, bad, n) == (False, 1, 8) and share > 1
    assert torch.allclose(near, ref, rtol=2e-6, atol=2e-7)
    assert not torch.allclose(off, ref, rtol=2e-6, atol=2e-7)
    good, fail = [True, 0, 4, 0.0], [False, 1, 4, 2.0]
    rec = {"jax_rule": {"forward B=2": {"eager": good, "captured": good},
                        "encode B=2": {"eager": good, "captured": fail}}}
    assert CS.rule_fails(rec) == ["encode B=2"]


def test_shard_diagnostic_covers_every_op_on_the_cpu(small_models,
                                                     small_human):
    """The diagnostic walks the regressor, the kps gather and heads, every
    encoder conv (with its tile at b = 1 and 2) and pool, the part gather,
    both head products, the decode scatter, every unpool and decoder
    conv, in the forward's order; each op's row 0 is compared."""
    model, _ = small_models
    m = small_human.sample_meshes(2, seed=4).astype(np.float32)
    x = torch.from_numpy(np.concatenate([m, np.zeros((2, 1, 3),
                                                     np.float32)], 1))
    out = CS.shard_diagnostic(model, model.init(0), small_human.J_regressor,
                              x)
    names = [o["op"] for o in out["ops"]]
    n = model.tables.n_levels - 1
    assert names[:3] == ["regress (jv,bvc->bjc einsum)", "kps gather",
                         "kps heads (bpk,pkl->bpl einsum)"]
    assert sum(s.startswith("encoder conv") for s in names) == len(
        model.enc_plan)
    assert sum(s.startswith("decoder conv") for s in names) == len(
        model.dec_plan)
    assert sum(s.startswith("pool") for s in names) == n
    assert sum(s.startswith("unpool") for s in names) == n
    assert names.index("part gather") < names.index(
        "enc heads (bpk,pkl->bpl einsum)") < names.index(
        "dec heads (bpl,plk->bpk einsum)") < names.index("decode scatter")
    for o in out["ops"]:
        assert "conv" not in o["op"] or {"tile_b1", "tile_b2"} <= set(o)
        assert o["outside"] == 0 and 0 <= o["differ"] <= o["entries"]
    first = next((o["op"] for o in out["ops"] if o["differ"]), None)
    assert out["first"] == first
