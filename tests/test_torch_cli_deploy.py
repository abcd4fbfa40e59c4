"""The port's deployment CLIs on a tiny dataset the port's preprocessing
CLIs write (make_synthetic -> obj2npy -> data_generation -> cli.train):
cli.export without the dataset, cli.eval_reference on a reference-layout
`.pth.tar` against the torch reference model's own eval and the JAX CLI's
JSON line, cli.demo's five OBJs (mirrors tests/test_cli.py:104-183)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from semantichuman_torch.cli import (data_generation, demo,
                                     eval_reference, export,
                                     make_synthetic, obj2npy, train)
from semantichuman_torch.serving import ServingBundle

torch.set_num_threads(1)

CFG = """
model:
  filter_sizes_enc: [[3, 8, 8, 16, 16], [[], [], [], [], []]]
  filter_sizes_dec: [[16, 16, 8, 8, 8], [[], [], [], [], 3]]
  use_pallas: false
data:
  root_dir: {root}
  asset_dir: {root}/asset
  normalization: zeroroot
  measure: true
train:
  n_epochs: 1
  batch_train: 4
  batch_interp: 4
  batch_test: 4
  ck_frequency: 1
  save_recons: false
"""

SYNTH_CFG = """
model:
  filter_sizes_enc: [[3, 8, 8, 16, 16], [[], [], [], [], []]]
  filter_sizes_dec: [[16, 16, 8, 8, 8], [[], [], [], [], 3]]
data:
  synthetic_n_theta: 12
  synthetic_n_phi: 24
  synthetic_train: 8
  synthetic_test: 4
train:
  n_epochs: 1
  batch_train: 4
  batch_interp: 4
  batch_test: 4
  ck_frequency: 1
  save_recons: false
  eval_flag: false
"""

EDITS = {"sample0_rec.obj", "sample0_girth.obj", "sample0_style.obj",
         "sample0_ori.obj", "sample0_bonelen.obj"}


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The port's CLI chain once, on the CPU: a 12 x 24 synthetic dataset
    (10 train, 2 val, 4 test) and one epoch of cli.train."""
    base = tmp_path_factory.mktemp("deploy")
    root = base / "ds"
    make_synthetic.main(["--out_dir", str(root), "--n_train", "12",
                         "--n_test", "4", "--n_theta", "12", "--n_phi", "24"])
    obj2npy.main(["--save_path", str(root),
                  "--trainobj_path", str(root / "obj_train"),
                  "--testobj_path", str(root / "obj_test"),
                  "--asset_dir", str(root / "asset")])
    data_generation.main(["-r", str(root), "--n_val", "2"])
    cfg = base / "cfg.yaml"
    cfg.write_text(CFG.format(root=root))
    trainer = train.main(["--config", str(cfg), "--workdir",
                          str(base / "run"), "--device", "cpu"])
    return base, trainer


def test_export_needs_no_dataset(pipeline):
    """Serving export on a host with only the assets, the template and a
    checkpoint, no preprocessed/ dataset; the bundle's forward equals the
    Trainer's eval-step reconstruction (1e-5)."""
    base, trainer = pipeline
    host = base / "serving_host"
    (host / "ds" / "template").mkdir(parents=True)
    shutil.copytree(base / "ds" / "asset", host / "ds" / "asset")
    shutil.copy(base / "ds" / "template" / "template.obj",
                host / "ds" / "template" / "template.obj")
    work = host / "work"
    shutil.copytree(base / "run" / "checkpoints", work / "checkpoints")
    cfg = host / "cfg.yaml"
    cfg.write_text(CFG.format(root=host / "ds"))
    manifest = export.main(["--config", str(cfg), "--workdir", str(work),
                            "--batch_size", "2", "--device", "cpu"])
    assert manifest["symbolic_batch"] is True
    assert (work / "bundle" / "manifest.json").exists()
    served = ServingBundle(str(work / "bundle"), device="cpu")
    batch = next(iter(trainer.test_loader))
    with torch.no_grad():
        ref = trainer._get_eval_step()(trainer.params,
                                       trainer._step_view(batch))
    rec = served.forward(batch["verts"])[0]
    torch.testing.assert_close(rec, ref["rec"], rtol=0, atol=1e-5)


def _reference_checkpoint(base):
    """A reference-layout .pth.tar of benchmarks/torch_baseline.py's torch
    model on the dataset's topology, and that model's own eval of the test
    split (the reference's test_funcs.py recipe): (path, l1, mm)."""
    from benchmarks.torch_baseline import (build_torch_model,
                                           reference_state_dict)
    from semantichuman_tpu.constants import KPS_INDEX_LIST, KPS_KEEP
    from semantichuman_tpu.data.assets import BodyAssets
    from semantichuman_tpu.topology import compile_topology

    root = base / "ds"
    assets = BodyAssets.load(str(root / "asset"),
                             str(root / "template" / "template.obj"))
    hier = compile_topology(
        assets.template_verts, assets.template_faces,
        reference_vertex=min(414, len(assets.template_verts) - 1))
    torch.manual_seed(3)
    model = build_torch_model(
        hier, hier.downsample_part_indices(assets.part_dict), KPS_INDEX_LIST,
        enc_filters=[3, 8, 8, 16, 16], dec_filters=[16, 16, 8, 8, 8])
    ckpt = base / "checkpoint42.pth.tar"
    torch.save({"epoch": 42,
                "autoencoder_state_dict": reference_state_dict(model),
                "optimizer_state_dict": {},
                "scheduler_state_dict": {}}, ckpt)
    test_v = np.load(root / "preprocessed" / "test.npy").astype(np.float32)
    jr = assets.j_regressor.astype(np.float32)
    root_j = np.einsum("v,bvd->bd", jr[0], test_v)
    xn = np.nan_to_num(test_v - root_j[:, None, :])       # zeroroot
    x = np.concatenate([xn, np.zeros((len(xn), 1, 3), np.float32)], axis=1)
    kps = np.einsum("jv,bvd->bjd", jr, xn)[:, KPS_KEEP]
    with torch.no_grad():
        rec = model(torch.as_tensor(x), torch.as_tensor(kps))[0].numpy()
    d = rec[:, :-1] - x[:, :-1]
    return (str(ckpt), float(np.mean(np.abs(d))),
            float(np.mean(np.sqrt(np.sum((d * 1000.0) ** 2, axis=2)))))


def test_eval_reference_checkpoint(pipeline, capsys):
    """cli.eval_reference on a reference-layout checkpoint: within 0.5 % of
    the torch reference model's own eval (exit 0), and l1 and mm equal the
    JAX CLI's JSON line on the same files (rtol 1e-4)."""
    from semantichuman_tpu.cli import eval_reference as jax_eval_reference

    base, _trainer = pipeline
    ckpt, t_l1, t_mm = _reference_checkpoint(base)
    argv = ["--config", str(base / "cfg.yaml"), "--checkpoint", ckpt,
            "--batch_test", "4", "--torch_l1", str(t_l1),
            "--torch_mm", str(t_mm), "--max_delta_pct", "0.5"]
    capsys.readouterr()
    rc = eval_reference.main(argv + ["--workdir", str(base / "ref_torch"),
                                     "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, got
    assert jax_eval_reference.main(
        argv + ["--workdir", str(base / "ref_jax")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["epoch"] == want["epoch"] == 42
    assert got["n_test"] == want["n_test"] == 4
    assert abs(got["mm_delta_pct"]) < 0.5 and abs(got["l1_delta_pct"]) < 0.5
    for k in ("l1", "mm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4)


def test_eval_reference_fails_outside_the_budget(pipeline, capsys):
    """|mm delta| above --max_delta_pct exits 1 and still prints the
    line."""
    base, _trainer = pipeline
    ckpt, t_l1, t_mm = _reference_checkpoint(base)
    rc = eval_reference.main([
        "--config", str(base / "cfg.yaml"), "--checkpoint", ckpt,
        "--workdir", str(base / "ref_fail"), "--batch_test", "4",
        "--torch_mm", str(t_mm * 1.02), "--max_delta_pct", "0.5",
        "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and out["mm_delta_pct"] < -0.5


def test_demo_writes_the_five_objs(pipeline, tmp_path):
    """cli.demo off the pipeline's checkpoint (and the eval pass), then
    --synthetic --skip_eval off a synthetic run's checkpoint: the five
    edit OBJs each time."""
    base, _trainer = pipeline
    out = demo.main(["--config", str(base / "cfg.yaml"), "--workdir",
                     str(base / "run"), "--n_samples", "2", "--device",
                     "cpu", "--out", str(tmp_path / "edits")])
    assert set(out) == {name[8:-4] for name in EDITS}
    assert EDITS <= set(os.listdir(tmp_path / "edits"))
    assert (base / "run" / "predictions" / "predictions.npy").exists()

    cfg = tmp_path / "synth.yaml"
    cfg.write_text(SYNTH_CFG)
    wd = tmp_path / "synth"
    train.main(["--config", str(cfg), "--workdir", str(wd), "--synthetic",
                "--device", "cpu"])
    demo.main(["--config", str(cfg), "--workdir", str(wd), "--synthetic",
               "--skip_eval", "--n_samples", "2", "--device", "cpu"])
    assert EDITS <= set(os.listdir(wd / "edits"))


def test_demo_resume_flags_exclude_each_other(pipeline):
    base, _trainer = pipeline
    with pytest.raises(ValueError, match="mutually exclusive"):
        demo.main(["--workdir", str(base / "run"), "--resume", "x",
                   "--checkpoint_torch", "y.pth.tar", "--device", "cpu"])


def test_demo_from_a_reference_checkpoint(pipeline, tmp_path):
    """--checkpoint_torch runs the demo off a reference .pth.tar (the
    Trainer's resume_torch with finetune)."""
    base, _trainer = pipeline
    ckpt, _l1, _mm = _reference_checkpoint(base)
    demo.main(["--config", str(base / "cfg.yaml"), "--workdir",
               str(tmp_path / "w"), "--checkpoint_torch", ckpt,
               "--skip_eval", "--n_samples", "2", "--device", "cpu"])
    assert EDITS <= set(os.listdir(tmp_path / "w" / "edits"))


@pytest.mark.parametrize("cli", ["demo", "export", "eval_reference"])
def test_each_cli_defaults_to_the_card(pipeline, cli, tmp_path):
    """Without --device each CLI runs on the card, and on a host without
    one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    base, _trainer = pipeline
    cfg = str(base / "cfg.yaml")
    argv = {"demo": ["--config", cfg, "--workdir", str(base / "run"),
                     "--skip_eval"],
            "export": ["--config", cfg, "--workdir", str(base / "run"),
                       "--out", str(tmp_path / "b")],
            "eval_reference": ["--config", cfg, "--workdir",
                               str(tmp_path / "e"), "--checkpoint",
                               "unused.pth.tar"]}[cli]
    mod = {"demo": demo, "export": export,
           "eval_reference": eval_reference}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
