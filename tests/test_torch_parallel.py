"""The port's data parallelism (`semantichuman_torch/parallel/`) on the CPU:
two processes joined by gloo, each on its rows of every global batch.

  * the step: three steps of the two-rank make_train_step at a global B = 8
    against JAX make_train_step at B = 8 (tests/test_parallel.py's setup
    and tolerances), the two ranks' parameters equal, and for each loss
    term the all-reduced gradient against the port's single-process
    gradient at B = 8 (the exchange pairing and the distance loss's
    counts are global, or these cases fail);
  * BatchLoader(process_slice) against the JAX package's, rank by rank;
  * the Trainer: two ranks through `cli.train --distributed`
    (`tools/dp_fit.py`) against the port's single-process Trainer, for
    PartAE and neural3DMM, with the final test batch's padding on the
    last rank; rank 0 alone writes the run's files.
"""

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.config import ModelConfig
from semantichuman_torch.data.dataset import ArraySource as TorchSource
from semantichuman_torch.data.dataset import BatchLoader as TorchLoader
from semantichuman_torch.data.device_data import DeviceDataSource
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.parallel import mesh as M
from semantichuman_torch.parallel.distributed import (
    initialize_distributed, process_local_batch_slice)
from semantichuman_torch.topology import MeshHierarchy as TorchHier
from semantichuman_torch.train import losses as TL
from semantichuman_torch.train import step as TS
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils.params import (params_from_jax,
                                              params_to_numpy, tree_leaves)
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.data.dataset import ArraySource as JaxSource
from semantichuman_tpu.data.dataset import BatchLoader as JaxLoader
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.train import losses as JL
from semantichuman_tpu.train import step as JS
from semantichuman_tpu.train.edits import EditSampler
from semantichuman_tpu.train.optim import make_optimizer

from tests.conftest import SMALL_MODEL_OVERRIDES
from tests.test_torch_trainer import topology_dir  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "helpers" / "torch_dp_step.py"
WORLD = 2
B = 8
TIMEOUT = 300           # seconds a rank may take before the test fails


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(argvs, cwd) -> list:
    """Start one process per argv, wait for all (a hung rank fails the
    test after TIMEOUT), require exit 0; -> their stdout."""
    procs = [subprocess.Popen(a, cwd=cwd, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# --- the step -----------------------------------------------------------------

# name -> (StepFlags overrides, exchange variant, metric, spec overrides)
GRAD_CASES = {
    "rec": ({}, "ori", "rec", {}),
    "edgereg": ({}, "ori", "edgereg", {}),
    "zpartreg": ({}, "ori", "zpartreg", {}),
    "interp_kps": ({}, "ori", "interp_kps", {}),
    "exc_kps-ori": ({}, "ori", "exc_kps", {}),
    "exc_kps-m": ({}, "m", "exc_kps", {}),
    "exc_kps-ori_m": ({}, "ori_m", "exc_kps", {}),
    "exc_kps-dynamic": ({}, "dynamic", "exc_kps",
                        {"exc_is_ori": np.float32(0.0)}),
    "interp_euc": ({}, "ori", "interp_euc", {}),
    "interp_euc-rand_num": ({"w_part_mode": "1/rand_num"}, "ori",
                            "interp_euc", {}),
    "exc_euc": ({}, "ori", "exc_euc", {}),
    # exc_kps under 'ori_m' sums a function of the swapped keypoints alone
    # over a permutation of the batch, the same sum whatever the pairing:
    # the exchanged decode's distance term holds that variant's pairing
    "exc_euc-ori_m": ({}, "ori_m", "exc_euc", {}),
    "vol": ({}, "ori", "vol", {}),
}


@pytest.fixture(scope="module")
def dp_step(small_hierarchy, small_human, tmp_path_factory):
    """The two-rank step's results (rank by rank), the inputs, and the
    port's single-process model and tables."""
    tmp = tmp_path_factory.mktemp("dp_step")
    hier_path = str(tmp / "hier.npz")
    small_hierarchy.save(hier_path)
    model_over = dict(SMALL_MODEL_OVERRIDES, banded_conv=False)
    jm = jax_build(JaxConfig.from_dict({"model": model_over}),
                   small_hierarchy, small_human.part_dict)
    params = jax.tree.map(np.asarray, jm.init(0))

    def host_batch(seed):
        v = small_human.sample_meshes(B, seed=seed).astype(np.float32)
        return {"verts": np.concatenate(
                    [v, np.zeros((B, 1, 3), np.float32)], axis=1),
                "measure": small_human.measures(v).astype(np.float32)}

    steps = [(host_batch(i), host_batch(100 + i), host_batch(200 + i))
             for i in range(3)]
    spec = EditSampler(seed=0).sample_interp(epoch=200, batch_size=B)
    case = {"hier": hier_path, "model": model_over,
            "part_dict": small_human.part_dict,
            "faces": small_human.template_faces,
            "j_regressor": small_human.J_regressor, "params": params,
            "steps": steps, "spec": spec, "grad_cases": GRAD_CASES}
    with open(tmp / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    port = _free_port()
    _run_ranks([[sys.executable, str(HELPER), "--case", str(tmp / "case.pkl"),
                 "--rank", str(r), "--world", str(WORLD), "--port",
                 str(port), "--out", str(tmp / f"rank{r}.pkl")]
                for r in range(WORLD)], cwd=str(tmp))
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    tm = torch_build(ModelConfig(**{k: v for k, v in model_over.items()
                                    if k in fields}),
                     TorchHier.load(hier_path), small_human.part_dict,
                     device="cpu")
    tt = TL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict,
                              device="cpu")
    return ranks, case, jm, tm, tt


def test_two_rank_step_matches_jax(dp_step, small_human):
    """Three steps at a global B = 8 against JAX make_train_step on one
    device at B = 8 (its reference math, no Pallas): metrics to rtol 2e-4
    (atol 1e-6), parameters to rtol 1e-4, atol 1e-6, the tolerances of
    tests/test_parallel.py for the JAX package's own mesh."""
    ranks, case, jm, _tm, _tt = dp_step
    jt = JL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict)
    opt = make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    params = jax.tree.map(jnp.asarray, case["params"])
    opt_state = opt.init(params)
    step = JS.make_train_step(jm, jt, opt, JS.StepFlags(fused_dist=False),
                              exc_variant="ori", donate=False)
    spec = jax.tree.map(jnp.asarray, case["spec"])
    for i, segs in enumerate(case["steps"]):
        params, opt_state, metrics = step(
            params, opt_state, *[jax.tree.map(jnp.asarray, s) for s in segs],
            spec)
        got = ranks[0]["metrics"][i]
        assert sorted(got) == sorted(metrics)
        for k, v in metrics.items():
            assert got[k] == pytest.approx(float(v), rel=2e-4, abs=1e-6), \
                f"step {i} metric {k}"
    for a, b in zip(tree_leaves(ranks[0]["params"]),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)


def test_two_ranks_hold_the_same_parameters(dp_step):
    """Each rank's local gradient differs (their rows differ): equal
    parameters and metrics after three steps show the all-reduce ran (the
    counterpart of test_parallel.py::test_grad_allreduce_happens)."""
    ranks = dp_step[0]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for a, b in zip(tree_leaves(ranks[0]["params"]),
                    tree_leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_term_gradient_is_global(dp_step, name):
    """One loss term's all-reduced gradient from two ranks of B = 4 against
    the port's single-process gradient at B = 8: rtol 1e-5, and within
    1e-5 of the gradient's largest entry (a leaf that the term does not
    reach, as the last bias under the translation-free edge term, holds
    rounding noise alone).  The exchange cases fail if the pairing flips
    the local batch, the distance cases if their counts stay local."""
    ranks, case, _jm, tm, tt = dp_step
    flags, variant, term, spec_over = GRAD_CASES[name]
    loss_fn = TS.make_loss_fn(tm, tt, TS.StepFlags(**flags), variant)

    def term_fn(p, *a):
        _, ms = loss_fn(p, *a)
        return ms[term], ms

    segs = [TS.to_device(s, "cpu") for s in case["steps"][0]]
    spec = TS.to_device({**case["spec"], **spec_over}, "cpu")
    _, _, g = TS.value_and_grad(term_fn, params_from_jax(case["params"],
                                                         "cpu"), *segs, spec)
    want = tree_leaves(params_to_numpy(g))
    got = ranks[0]["grads"][name]
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 0, "the term has no gradient"
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{name} leaf {i}")
    for a, b in zip(got, ranks[1]["grads"][name]):
        np.testing.assert_array_equal(a, b)


# --- the loaders and the mesh helpers, one process -----------------------------

LOADERS = {
    "train": dict(batch_size=8, shuffle=True, seed=3, drop_last=True),
    "test_padded": dict(batch_size=4, pad_final=True),
}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", sorted(LOADERS))
def test_batch_loader_process_slice_matches_jax(kind, world):
    """Every rank's rows of every batch, over two epochs, equal the JAX
    BatchLoader(process_slice)'s (verts, valid, the global pad count and
    index); the staged loader takes the same rows."""
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((22, 5, 3)).astype(np.float32)
    meas = rng.standard_normal((22, 32)).astype(np.float32)
    kw = LOADERS[kind]
    for rank in range(world):
        tl = TorchLoader(TorchSource(verts, meas), process_slice=(rank, world),
                         **kw)
        jl = JaxLoader(JaxSource(verts, meas), process_slice=(rank, world),
                       **kw)
        staged = DeviceDataSource(verts, meas, "No", device="cpu")
        for epoch in (0, 1):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            got, want = list(tl), list(jl)
            metas = list(tl.iter_indices())
            assert len(got) == len(want) == len(metas)
            for t, j, meta in zip(got, want, metas):
                for k in ("verts", "measure", "valid", "global_idx"):
                    np.testing.assert_array_equal(t[k], j[k], err_msg=k)
                assert t["pad"] == j["pad"]
                s = staged.take(meta, tl)
                np.testing.assert_array_equal(s["verts"].numpy(), t["verts"])
                np.testing.assert_array_equal(s["valid"].numpy(), t["valid"])
    with pytest.raises(ValueError, match="not divisible"):
        TorchLoader(TorchSource(verts), batch_size=6, process_slice=(0, 4))


def test_mesh_helpers_without_a_group():
    """Outside a process group each collective returns its input: the
    single-process Trainer runs the same code with nothing to reduce; the
    slices follow rank r owning rows [r*per, (r+1)*per)."""
    assert not torch.distributed.is_initialized()
    initialize_distributed()        # nothing asks for a group: stays alone
    assert not torch.distributed.is_initialized()
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(M.all_reduce_sum(x), x)
    assert torch.equal(M.all_reduce_mean(x), x)
    assert torch.equal(M.fully_replicate(x), x)
    g = [x, x[0], x.double()]
    assert all(a is b for a, b in zip(M.all_reduce_grads(g), g))
    assert M.put_replicated({"a": x})["a"] is x
    np.testing.assert_array_equal(M.local_rows(np.arange(8), 1, 4), [2, 3])
    spec = {"a_full": np.arange(8)[:, None], "edited_mask": np.arange(17),
            "n_edited": np.float32(3)}
    cut = M.shard_spec(spec, 1, 2)
    np.testing.assert_array_equal(cut["a_full"][:, 0], [4, 5, 6, 7])
    assert cut["edited_mask"] is spec["edited_mask"]
    cut = M.shard_batch({"verts": np.arange(8), "pad": 1}, 3, 4)
    np.testing.assert_array_equal(cut["verts"], [6, 7])
    assert cut["pad"] == 1
    assert process_local_batch_slice(8) == (0, 8)
    with pytest.raises(ValueError, match="--num_processes"):
        initialize_distributed("localhost:1", device="cpu")


def test_trainer_refuses_a_batch_the_world_does_not_divide(
        tmp_path, topology_dir, monkeypatch):   # noqa: F811
    """As the JAX Trainer's multi-host rule: a batch size that the number
    of processes does not divide raises before any collective."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    cfg = TorchConfig.from_dict(_trainer_raw("partae"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_test=3))
    with pytest.raises(ValueError, match=r"divisible by 2; got \[3\]"):
        TorchTrainer(cfg, str(tmp_path), device="cpu")


# --- the Trainer -----------------------------------------------------------------

MODELS = {
    "partae": dict(SMALL_MODEL_OVERRIDES),
    "n3dmm": dict(SMALL_MODEL_OVERRIDES, model_type="neural3DMM", nz=16,
                  banded_conv=False),
}


def _trainer_raw(model: str) -> dict:
    """One epoch of 2 steps at global batch 8; a test split of 6 at batch 4,
    so the final batch's two pad rows are the last rank's two rows."""
    return {
        "model": MODELS[model],
        "data": {"synthetic": True, "synthetic_train": 16,
                 "synthetic_test": 6, "synthetic_n_theta": 16,
                 "synthetic_n_phi": 36, "normalization": "zeroroot"},
        "train": {"n_epochs": 1, "batch_train": 8, "batch_interp": 8,
                  "batch_test": 4, "ck_frequency": 1, "log_every": 1,
                  "save_recons": False, "epoch_scan": False, "seed": 2},
    }


def _workdir(base: Path, topo: Path) -> Path:
    base.mkdir(parents=True)
    for name in ("topology_2222.npz", "topology_2222.npz.meta"):
        (base / name).write_bytes((topo / name).read_bytes())
    return base


def _jsonl(workdir) -> list:
    with open(Path(workdir, "summaries", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def dp_trainers(tmp_path_factory, topology_dir):  # noqa: F811
    """Per model: the two ranks' results (tools/dp_fit.py through
    cli.train --distributed on gloo) and the single-process Trainer's."""
    base = tmp_path_factory.mktemp("dp_trainer")
    argvs, out = [], {}
    for model in MODELS:
        cfg_path = base / f"{model}.yaml"
        cfg_path.write_text(yaml.safe_dump(_trainer_raw(model)))
        wd = _workdir(base / f"{model}_dp", topology_dir)
        port = _free_port()
        for r in range(WORLD):
            argvs.append([
                sys.executable, "-m", "semantichuman_torch.tools.dp_fit",
                "--out", str(base / f"{model}_out"), "--",
                "--config", str(cfg_path), "--workdir", str(wd),
                "--device", "cpu", "--distributed", "--coordinator",
                f"tcp://localhost:{port}", "--num_processes", str(WORLD),
                "--process_id", str(r)])
        out[model] = {"workdir": wd}
    procs = [subprocess.Popen(a, cwd=str(ROOT), env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    try:
        for model in MODELS:
            # the single-process Trainer, while the ranks run
            wd = _workdir(base / f"{model}_single", topology_dir)
            tr = TorchTrainer(TorchConfig.from_dict(_trainer_raw(model)),
                              str(wd), device="cpu")
            tr.fit()
            out[model]["single"] = {
                "trainer": tr, "workdir": wd, "val": tr.validate(),
                "eval": tr.evaluate()}
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for model in MODELS:
        d = base / f"{model}_out"
        out[model]["ranks"] = [
            (json.loads((d / f"rank{r}.json").read_text()),
             dict(np.load(d / f"rank{r}.npz"))) for r in range(WORLD)]
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_two_rank_trainer_matches_one_process(dp_trainers, model):
    """Per-step losses (rank 0's log) to rtol 2e-4, the final parameters to
    rtol 1e-4 (atol 1e-6) and bit-equal on both ranks, the val loss and
    evaluate's L1 and mm to rtol 1e-4, and evaluate's predictions (the
    global rows, the last rank's pad rows dropped) to atol 1e-5."""
    run = dp_trainers[model]
    single = run["single"]
    (j0, a0), (j1, a1) = run["ranks"]
    assert (j0["world"], j1["world"], j0["rank"], j1["rank"]) == (2, 2, 0, 1)
    assert j0["data_parallel"] and j1["data_parallel"]
    steps_dp = [r["loss"] for r in _jsonl(run["workdir"]) if "loss" in r]
    steps_1 = [r["loss"] for r in _jsonl(single["workdir"]) if "loss" in r]
    assert len(steps_dp) == len(steps_1) == 3   # 2 steps, then the epoch's
    np.testing.assert_allclose(steps_dp, steps_1, rtol=2e-4, atol=1e-6)
    params = single["trainer"].params
    for (path, t) in zip(_param_keys(params), tree_leaves(params)):
        np.testing.assert_allclose(a0[path], t.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=path)
        np.testing.assert_array_equal(a0[path], a1[path])
    preds, _z, _zk, _tx, l1, mm = single["eval"]
    for j in (j0, j1):
        assert j["val"] == pytest.approx(single["val"], rel=1e-4)
        assert j["l1"] == pytest.approx(l1, rel=1e-4)
        assert j["mm"] == pytest.approx(mm, rel=1e-4)
    assert a0["preds"].shape == preds.shape == (6,) + preds.shape[1:]
    np.testing.assert_allclose(a0["preds"], preds, atol=1e-5)
    np.testing.assert_array_equal(a0["preds"], a1["preds"])


def _param_keys(params) -> list:
    from semantichuman_torch.utils.params import tree_paths
    return ["param:" + "/".join(map(str, p)) for p in tree_paths(params)]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_rank_zero_alone_writes_the_run(dp_trainers, model):
    """One configuration dump, one log line per record, one checkpoint and
    the predictions, as the single-process run writes them."""
    run = dp_trainers[model]
    wd, single = run["workdir"], run["single"]["workdir"]
    dumps = Path(wd, "checkpoints", "train_params.txt").read_text()
    assert dumps.count('"git_sha"') == 1
    assert "autoencoder: L1 loss" in dumps       # export_predictions
    assert len(_jsonl(wd)) == len(_jsonl(single))
    assert sorted(os.listdir(Path(wd, "checkpoints"))) == ["1",
                                                           "train_params.txt"]
    preds = np.load(Path(wd, "predictions", "predictions.npy"))
    assert preds.shape[0] == 6
