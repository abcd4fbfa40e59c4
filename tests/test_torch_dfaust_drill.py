"""The port's DFAUST first-contact drill (`semantichuman_torch/tools/
dfaust_drill.py`) against the JAX drill (`tools/dfaust_drill.py`) on the
same hostile-format files (the counterparts of tests/test_dfaust_drill.py
and tests/test_cli.py::test_dfaust_drill_stages): a scipy-sparse
J_regressor pickled inside a 0-d object array, ragged object-dtype girth
tables, a reference-layout checkpoint.  The port's drill also runs its
data stages (eval, demo, resume) on the CPU, on a tiny dataset its own
preprocessing CLIs write."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sp = pytest.importorskip("scipy.sparse")

from semantichuman_torch.cli import data_generation, make_synthetic, obj2npy
from semantichuman_torch.tools import dfaust_drill as TD

torch.set_num_threads(1)

MODEL_CFG = """
model:
  filter_sizes_enc: [[3, 8, 8, 16, 16], [[], [], [], [], []]]
  filter_sizes_dec: [[16, 16, 8, 8, 8], [[], [], [], [], 3]]
  part_shape_latent_size: 8
  part_kps_latent_size: 8
  use_pallas: false
data:
  normalization: zeroroot
  measure: true
train:
  batch_train: 4
  batch_interp: 4
  batch_test: 4
  save_recons: false
"""


@pytest.fixture(scope="module")
def drill_files(small_human, tmp_path_factory):
    """(asset dir, template, checkpoint, config, data root): a 16 x 36
    dataset from the port's CLIs (6 train, 2 val, 4 test), its first
    train frame the template; the same human's assets in their hostile
    on-disk formats; a reference-layout checkpoint of the torch reference
    model (one Adam step, so it carries optimizer state) on the hierarchy
    the drill compiles from those files and knobs."""
    from benchmarks.torch_baseline import (build_torch_model,
                                           reference_state_dict)
    from semantichuman_tpu.config import Config
    from semantichuman_tpu.constants import KPS_INDEX_LIST, KPS_KEEP
    from semantichuman_tpu.data.assets import BodyAssets
    from semantichuman_tpu.topology import compile_topology
    from semantichuman_tpu.topology.adjacency import unique_edges

    base = tmp_path_factory.mktemp("drill")
    root = base / "ds"
    make_synthetic.main(["--out_dir", str(root), "--n_train", "8",
                         "--n_test", "4", "--n_theta", "16", "--n_phi",
                         "36"])
    obj2npy.main(["--save_path", str(root),
                  "--trainobj_path", str(root / "obj_train"),
                  "--testobj_path", str(root / "obj_test"),
                  "--asset_dir", str(root / "asset")])
    data_generation.main(["-r", str(root), "--n_val", "2"])
    tpl = root / "template" / "template.obj"

    sh = small_human
    adir = base / "asset"
    adir.mkdir()
    wrapped = np.empty((), dtype=object)
    wrapped[()] = sp.csc_matrix(sh.J_regressor)
    np.save(adir / "J_regressor.npy", wrapped, allow_pickle=True)
    np.save(adir / "vert_part_index_dict.npy",
            np.asarray(sh.part_dict, dtype=object))
    np.save(adir / "factor_list.npy",
            np.asarray([[float(x) for x in np.ravel(f)]
                        for f in sh.girth_factors], dtype=object))
    np.save(adir / "edge_point_index_list.npy",
            np.asarray([np.asarray(e) for e in sh.girth_edges],
                       dtype=object))
    np.save(adir / "edge_verts_index.npy", unique_edges(sh.template_faces))
    cfg_path = base / "drill_model.yaml"
    cfg_path.write_text(MODEL_CFG)

    a = BodyAssets.load(str(adir), str(tpl))
    cfg = Config.from_yaml(str(cfg_path))
    hier = compile_topology(
        a.template_verts, a.template_faces,
        ds_factors=cfg.model.ds_factors, step_sizes=cfg.model.step_sizes,
        dilation=cfg.model.dilation,
        reference_vertex=min(414, len(a.template_verts) - 1),
        cache_path=str(base / "ckpt_topo.npz"))
    torch.manual_seed(7)
    tmodel = build_torch_model(hier, hier.downsample_part_indices(
        a.part_dict), KPS_INDEX_LIST, enc_filters=[3, 8, 8, 16, 16],
        dec_filters=[16, 16, 8, 8, 8])
    opt = torch.optim.Adam(tmodel.parameters(), lr=1e-3, weight_decay=5e-5)
    x = np.zeros((1, len(a.template_verts) + 1, 3), np.float32)
    x[0, :-1] = a.template_verts
    kps = np.einsum("jv,bvd->bjd", a.j_regressor.astype(np.float32),
                    x[:, :-1])[:, KPS_KEEP]
    rec = tmodel(torch.from_numpy(x), torch.from_numpy(kps))[0]
    torch.mean(torch.abs(rec - torch.from_numpy(x))).backward()
    opt.step()
    ckpt = base / "checkpoint42.pth.tar"
    torch.save({"epoch": 42,
                "autoencoder_state_dict": reference_state_dict(tmodel),
                "optimizer_state_dict": opt.state_dict(),
                "scheduler_state_dict": {"gamma": 0.99, "last_epoch": 42}},
               str(ckpt))
    return str(adir), str(tpl), str(ckpt), str(cfg_path), str(root)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_drill_summaries_match_jax_and_the_data_stages_run(
        drill_files, tmp_path, capsys):
    """The JAX drill and the port's drill on the same files: equal
    assets, topology and import summaries (V, joints, parts, girths; the
    level sizes; the checkpoint's epoch); the port's drill, given the
    dataset, runs all six stages on the CPU: eval through
    cli.eval_reference, the demo's five OBJs, one resumed epoch with a
    finite loss; each stage in its record."""
    from tools.dfaust_drill import main as jax_drill

    adir, tpl, ckpt, cfg, root = drill_files
    common = ["--asset_dir", adir, "--template", tpl, "--checkpoint", ckpt,
              "--config", cfg]
    rc = jax_drill(common + ["--workdir", str(tmp_path / "jax")])
    want = _last_json(capsys.readouterr().out)
    assert rc == 0 and want["drill"] == "ok"

    wd = tmp_path / "port"
    rc = TD.main(common + ["--workdir", str(wd), "--data_root", root,
                           "--device", "cpu"])
    out = capsys.readouterr().out
    got = _last_json(out)
    assert rc == 0, out
    assert got["drill"] == "ok"
    assert list(got["stages"]) == list(TD.STAGES)
    for name in ("assets", "topology", "import"):
        assert got["stages"][name] == want["stages"][name]
    assert got["stages"]["import"] == "epoch=42 forward finite"
    assert all(got["stages"][s] == "ok" for s in ("eval", "demo", "resume"))
    evals = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"checkpoint"')]
    assert len(evals) == 1 and evals[0]["epoch"] == 42
    assert np.isfinite([evals[0]["l1"], evals[0]["mm"]]).all()
    assert sorted(os.listdir(wd / "demo" / "edits")) == sorted(
        f"sample0_{k}.obj" for k in ("rec", "ori", "bonelen", "girth",
                                     "style"))
    record = json.loads((wd / TD.RECORD).read_text())
    assert list(record) == list(TD.STAGES)
    res = record["resume"]
    assert res["epoch"] == 43 and np.isfinite(res["loss"])
    assert res["steps"] == 1 and res["eval_batches"] == 2
    # on the CPU the wrappers take the plain versions: nothing launches
    assert not any(n for r in record.values()
                   for n in r["launches"].values())


def test_imported_forward_matches_jax(drill_files, tmp_path):
    """The import stage's forward of the template, port against JAX on the
    same checkpoint and files (rtol = atol = 1e-4)."""
    from semantichuman_tpu.config import Config as JaxConfig
    from semantichuman_tpu.constants import KPS_KEEP
    from semantichuman_tpu.data.assets import BodyAssets as JaxAssets
    from semantichuman_tpu.models import build_model
    from semantichuman_tpu.topology import compile_topology as jax_compile
    from semantichuman_tpu.utils.import_torch import \
        load_reference_checkpoint
    from semantichuman_torch.config import Config
    from semantichuman_torch.data.assets import BodyAssets
    from semantichuman_torch.topology import compile_topology

    adir, tpl, ckpt, cfg_path, _root = drill_files
    a, ja = BodyAssets.load(adir, tpl), JaxAssets.load(adir, tpl)
    cfg, jcfg = Config.from_yaml(cfg_path), JaxConfig.from_yaml(cfg_path)
    ref_v = min(414, len(a.template_verts) - 1)
    hier = compile_topology(a.template_verts, a.template_faces,
                            reference_vertex=ref_v,
                            cache_path=str(tmp_path / "port.npz"))
    jhier = jax_compile(ja.template_verts, ja.template_faces,
                        reference_vertex=ref_v,
                        cache_path=str(tmp_path / "jax.npz"))
    epoch, rec = TD.import_forward(cfg, a, hier, ckpt, "cpu")

    model = build_model(jcfg, jhier, ja.part_dict)
    params, jepoch = load_reference_checkpoint(ckpt, model)
    x = np.zeros((1, len(ja.template_verts) + 1, 3), np.float32)
    x[0, :-1] = ja.template_verts
    kps = np.einsum("jv,bvd->bjd", ja.j_regressor.astype(np.float32),
                    x[:, :-1])[:, KPS_KEEP]
    want = jax.jit(model)(params, jnp.asarray(x), jnp.asarray(kps))[0]
    assert epoch == jepoch == 42
    np.testing.assert_allclose(rec, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_widened_part_head_fails_at_import(drill_files, tmp_path, capsys):
    """A checkpoint whose first part head is widened (its encoder fan-in
    doubled) fails the drill at the import stage, rc 1, with assets and
    topology through (tests/test_cli.py:353)."""
    adir, tpl, ckpt, cfg, _root = drill_files
    ck = torch.load(ckpt, map_location="cpu", weights_only=False)
    sd = ck["autoencoder_state_dict"]
    w = sd["fc_latent_enc_list.0.weight"]
    sd["fc_latent_enc_list.0.weight"] = torch.cat([w, w], dim=1)
    bad = tmp_path / "drill_bad.pth.tar"
    torch.save(ck, str(bad))
    rc = TD.main(["--asset_dir", adir, "--template", tpl, "--checkpoint",
                  str(bad), "--config", cfg, "--workdir",
                  str(tmp_path / "bad"), "--device", "cpu"])
    got = _last_json(capsys.readouterr().out)
    assert rc == 1 and got["drill"] == "failed"
    assert got["stages"]["import"] == "FAILED"
    assert got["stages"]["assets"] != "FAILED"
    assert got["stages"]["topology"] != "FAILED"
    assert list(got["stages"]) == ["assets", "topology", "import"]
