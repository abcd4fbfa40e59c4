"""The port's epoch path (train.epoch_scan, `Trainer._run_scan_chunk` with
`make_epoch_scan_step`, and the neural3DMM baseline's
`make_baseline_epoch_scan_step`) on the CPU, where it runs uncaptured:
against the port's loop bit for bit, against the JAX Trainer's epoch scan
(the baseline: against the JAX Trainer's loop), under chunking; its Adam
scalars and in-place update against `Adam.update`; and the convergence
CLI at a tiny size."""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.train.optim import global_norm, make_optimizer
from semantichuman_torch.utils.params import (params_to_numpy, tree_leaves,
                                              tree_map, tree_unflatten)
from semantichuman_torch.utils.testing import \
    band_gate_patches as torch_band_patches
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.train.loop import Trainer as JaxTrainer
from semantichuman_tpu.utils.testing import \
    band_gate_patches as jax_band_patches

from tests.test_torch_trainer import (_port_cfg, _raw_cfg, _workdir,
                                      topology_dir)  # noqa: F401

torch.set_num_threads(1)

# the neural3DMM baseline as configs/train_neural3dmm.yaml builds it, at
# the small filters
N3DMM = {"model_type": "neural3DMM", "nz": 16, "banded_conv": False}

SCAN_CASES = [{},                                       # ori_or_m, dynamic
              {"edit_mode": "rand", "editskl_flag": True,  # skl stacking,
               "log_every": 3},                            # step logging
              {"edit_mode": "exc"},                     # host measures
              {"model": N3DMM, "log_every": 3}]         # the baseline
SCAN_IDS = ["default", "rand_editskl_logevery", "exc_measures", "neural3DMM"]


def _raw(model=None, **train):
    raw = _raw_cfg(**train)
    raw["model"].update(model or {})
    return raw


def _trainer(tmp_path, topology_dir, name, model=None, **train):
    return TorchTrainer(TorchConfig.from_dict(_raw(model, **train)),
                        _workdir(tmp_path / name, topology_dir),
                        device="cpu")


def _assert_same_state(a, b):
    assert a.global_step == b.global_step
    assert a.opt_state.count == b.opt_state.count
    assert a.opt_state.notfinite_count == b.opt_state.notfinite_count
    assert [h["train"] for h in a.history] == [h["train"] for h in b.history]
    for t in ("mu", "nu"):
        for x, y in zip(getattr(a.opt_state, t), getattr(b.opt_state, t)):
            assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def _step_logs(workdir):
    recs = [json.loads(line) for line in
            open(os.path.join(workdir, "summaries", "metrics.jsonl"))]
    return {r["step"]: r for r in recs
            if "rec" in r and "epoch_train" not in r}


@pytest.mark.parametrize("overrides", SCAN_CASES, ids=SCAN_IDS)
def test_epoch_path_matches_loop(tmp_path, topology_dir, overrides):
    """Two epochs on the epoch path equal two on the loop bit for bit:
    parameters, Adam moments and count, epoch losses, validation; the
    'ori_or_m' draws ride in the staged spec ('dynamic' variant, the
    volume term times exc_is_ori), and log_every logs the same step
    metrics.  The neural3DMM baseline takes the epoch path too, staging
    its batch indices alone."""
    scan = _trainer(tmp_path, topology_dir, "scan", epoch_scan=True,
                    **overrides)
    loop = _trainer(tmp_path, topology_dir, "loop", **overrides)
    assert scan._epoch_scan_ok() and not loop._epoch_scan_ok()
    scan.fit(2)
    loop.fit(2)
    if not scan.is_part_model:
        assert sorted(scan._epoch_buffers.sched) == ["idx_tr"]
    assert scan.global_step == 8
    _assert_same_state(scan, loop)
    assert scan.validate() == loop.validate()
    if overrides.get("log_every"):
        got, want = _step_logs(scan.workdir), _step_logs(loop.workdir)
        # the epoch-end lines (steps 4, 8) differ by design: the epoch
        # path logs the chunk's largest gnorm, the loop the last step's
        assert sorted(got) == sorted(want) == [3, 4, 6, 8]
        for step in (3, 6):
            for name, value in want[step].items():
                if name != "time":
                    assert got[step][name] == value, (step, name)


def test_epoch_path_matches_loop_fast_recipe_options(tmp_path, topology_dir):
    """The options train_fast.yaml turns on (global-norm clip, b2 0.95,
    warm-up and cosine lr, skip_nonfinite on the device) keep the epoch
    path equal to the loop bit for bit."""
    over = dict(epoch_scan=True, grad_clip=0.05, adam_b2=0.95,
                lr_schedule="cosine", lr_warmup_epochs=1, skip_nonfinite=2)
    scan = _trainer(tmp_path, topology_dir, "scan", **over)
    loop = _trainer(tmp_path, topology_dir, "loop",
                    **dict(over, epoch_scan=False))
    scan.fit(2)
    loop.fit(2)
    _assert_same_state(scan, loop)


def test_epoch_path_chunking_matches_per_epoch(tmp_path, topology_dir):
    """scan_epochs 3 with val_every 4 fuses epochs into chunks clipped at
    the epoch-2 checkpoint, and equals one chunk per epoch bit for bit;
    both checkpoints are written."""
    one = _trainer(tmp_path, topology_dir, "one", epoch_scan=True)
    many = _trainer(tmp_path, topology_dir, "many", epoch_scan=True,
                    scan_epochs=3, val_every=4)
    chunks = []
    run = many._run_scan_chunk

    def record(e0, e1):
        chunks.append((e0, e1))
        return run(e0, e1)

    many._run_scan_chunk = record
    one.fit(4)
    many.fit(4)
    assert chunks == [(1, 2), (3, 4)]
    _assert_same_state(one, many)
    assert [h["val"] is None for h in many.history] == [True, True,
                                                         True, False]
    for e in ("2", "4"):
        assert os.path.isdir(os.path.join(many.workdir, "checkpoints", e))


@pytest.mark.parametrize("writer", [False, True],
                         ids=["loop_to_epoch_path", "epoch_path_to_loop"])
def test_checkpoint_resumes_across_paths(tmp_path, topology_dir, writer):
    """A checkpoint one path wrote resumes on the other, and the resumed
    epoch 2 equals the uninterrupted run's bit for bit."""
    first = _trainer(tmp_path, topology_dir, "first", ck_frequency=1,
                     epoch_scan=writer)
    first.fit(2)
    ck = tmp_path / "ck1"
    os.makedirs(ck)
    os.symlink(os.path.join(first.workdir, "checkpoints", "1"), ck / "1")
    second = _trainer(tmp_path, topology_dir, "second",
                      epoch_scan=not writer, resume=str(ck))
    assert second._epoch_scan_ok() == (not writer)
    assert (second.start_epoch, second.global_step) == (2, 4)
    second.fit(2)
    assert second.history[0]["train"] == first.history[1]["train"]
    for x, y in zip(tree_leaves(second.params), tree_leaves(first.params)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def jax_scan_runs(tmp_path_factory, topology_dir):
    """The JAX Trainer's epoch scan and the port's epoch path, band gates
    forced on both sides (the JAX set without its pool band, which the
    port does not have), seed 2, two epochs from one hierarchy file."""
    base = tmp_path_factory.mktemp("scan_parity")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, val in jax_band_patches():
            if name != "_pool_band_ok":
                mp.setattr(mod, name, val)
        jt = JaxTrainer(JaxConfig.from_dict(_raw_cfg(epoch_scan=True)),
                        _workdir(base / "jax", topology_dir))
        assert jt._epoch_scan_ok()
        jt.fit()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, val in torch_band_patches():
            mp.setattr(mod, name, val)
        tt = TorchTrainer(_port_cfg(epoch_scan=True),
                          _workdir(base / "torch", topology_dir),
                          device="cpu")
        assert tt._epoch_scan_ok()
        assert all(b is not None for b in tt.model.tables.bands)
        tt.fit()
    return jt, tt


def test_epoch_path_losses_match_jax_scan(jax_scan_runs):
    """Per-epoch train and val loss to rtol 1e-4, as the loop's parity
    test holds them."""
    jt, tt = jax_scan_runs
    assert jt.global_step == tt.global_step == 8
    for jh, th in zip(_jax_epoch_history(jt), tt.history):
        np.testing.assert_allclose(th["train"], jh["train"], rtol=1e-4)
        np.testing.assert_allclose(th["val"], jh["val"], rtol=1e-4)


def _jax_epoch_history(jt):
    recs = [json.loads(line) for line in open(os.path.join(
        jt.workdir, "summaries", "metrics.jsonl"))]
    return [{"train": r["epoch_train"], "val": r.get("epoch_val")}
            for r in recs if "epoch_train" in r]


def test_epoch_path_params_match_jax_scan(jax_scan_runs):
    """Final parameters to atol 1e-4 after 8 Adam steps."""
    jt, tt = jax_scan_runs
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")


def test_epoch_path_eval_matches_jax_scan(jax_scan_runs):
    """evaluate() after the two epochs: predictions atol 1e-4, L1 and mm
    rtol 1e-4."""
    jt, tt = jax_scan_runs
    jp, _jz, _jzk, _jtx, jl1, jmm = jt.evaluate()
    tp, _tz, _tzk, _ttx, tl1, tmm = tt.evaluate()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    np.testing.assert_allclose([tl1, tmm], [jl1, jmm], rtol=1e-4)


@pytest.fixture(scope="module")
def jax_baseline_runs(tmp_path_factory, topology_dir):
    """The neural3DMM baseline: the JAX Trainer's loop (its epoch scan
    takes the part model alone) and the port's epoch path, seed 2, two
    epochs from one hierarchy file.  The paths differ, the numbers do
    not (ROADMAP.md, the port's own departures, item 1)."""
    base = tmp_path_factory.mktemp("baseline_parity")
    raw = _raw(N3DMM, epoch_scan=True)
    jt = JaxTrainer(JaxConfig.from_dict(raw),
                    _workdir(base / "jax", topology_dir))
    assert not jt._epoch_scan_ok()
    jt.fit()
    tt = TorchTrainer(TorchConfig.from_dict(raw),
                      _workdir(base / "torch", topology_dir), device="cpu")
    assert tt._epoch_scan_ok()
    tt.fit()
    return jt, tt


def test_baseline_epoch_path_matches_jax_loop(jax_baseline_runs):
    """Per-epoch train and val loss to rtol 1e-5.  After 8 Adam steps
    every parameter agrees to atol 1e-4 (the Trainers' parity tolerance)
    and all but 0.5 % of the entries to atol 1e-5, the tolerance of
    test_baseline_step_matches_jax's one step: where Adam divides a
    gradient near 0 by its own size, a last-bit difference of the sums
    moves an entry by up to a step's lr (measured: 73 of 28,955 entries
    beyond 1e-5, the largest 5.0e-5; the port's loop reads the same, bit
    for bit equal to its epoch path)."""
    jt, tt = jax_baseline_runs
    assert jt.global_step == tt.global_step == 8
    for jh, th in zip(_jax_epoch_history(jt), tt.history):
        np.testing.assert_allclose(th["train"], jh["train"], rtol=1e-5)
        np.testing.assert_allclose(th["val"], jh["val"], rtol=1e-5)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl) == 22
    beyond = total = 0
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")
        beyond += int(np.sum(np.abs(a - b) > 1e-5))
        total += a.size
    assert beyond <= 0.005 * total, (beyond, total)


@pytest.mark.parametrize("train,data", [
    ({}, {}), ({"epoch_scan": False}, {}), ({}, {"device_resident": False}),
    ({"scan_epochs": 4}, {})], ids=["default", "off", "host_data", "chunks"])
def test_epoch_scan_ok_matches_jax(tmp_path, topology_dir, train, data):
    """The epoch path's prerequisites decide as the JAX Trainer's do."""
    raw = _raw_cfg(**dict({"epoch_scan": True}, **train))
    raw["data"].update(data)
    jt = JaxTrainer(JaxConfig.from_dict(raw),
                    _workdir(tmp_path / "jax", topology_dir))
    tt = TorchTrainer(TorchConfig.from_dict(raw),
                      _workdir(tmp_path / "torch", topology_dir),
                      device="cpu")
    assert tt._epoch_scan_ok() == jt._epoch_scan_ok()


def test_scan_chunk_end_matches_jax():
    """The chunk boundaries (checkpoint, val, sample dump, flag change) of
    the JAX Trainer's `_scan_chunk_end`, on its own probe cases and a
    loss-gate change."""
    cases = [(105, dict(scan_epochs=4, ck_frequency=5, val_every=1000,
                        save_recons=False)),
             (106, dict(scan_epochs=4, ck_frequency=5, val_every=1000,
                        save_recons=False)),
             (107, dict(scan_epochs=4, ck_frequency=5, val_every=1000,
                        save_recons=False)),
             (101, dict(scan_epochs=4, ck_frequency=1000,
                        save_recons=False)),
             (150, dict(scan_epochs=4, ck_frequency=1000, val_every=1000,
                        save_recons=True)),
             (148, dict(scan_epochs=4, ck_frequency=1000, val_every=1000,
                        save_recons=True)),
             (3, dict(scan_epochs=6, ck_frequency=1000, val_every=1000,
                      save_recons=False, vol_epoch=5)),
             (998, dict(scan_epochs=8, ck_frequency=1000, val_every=1000,
                        save_recons=False))]
    for e0, kw in cases:
        ends = []
        for config, trainer in ((JaxConfig, JaxTrainer),
                                (TorchConfig, TorchTrainer)):
            cfg = config()
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, **kw))
            ends.append(trainer._scan_chunk_end(
                types.SimpleNamespace(cfg=cfg), e0, 1000))
        assert ends[0] == ends[1], (e0, kw, ends)


SCHEDULES = {
    "exp": dict(lr=1e-3, weight_decay=5e-5, lr_decay=0.99,
                steps_per_epoch=3),
    "cosine_warmup": dict(lr=3.5e-3, weight_decay=5e-5, lr_decay=0.99,
                          steps_per_epoch=3, warmup_epochs=2,
                          schedule_kind="cosine", n_epochs=5, adam_b2=0.95),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_step_scalars_are_the_loops_values(name):
    """Each row of step_scalars is (-lr, 1 - b1^t, 1 - b2^t) of the step
    as Adam.update computes them in double, rounded once to float32 (the
    rounding its float arguments get), and a chunk's rows are the rows of
    a longer chunk that starts earlier."""
    opt = make_optimizer(**SCHEDULES[name])
    rows = opt.step_scalars(0, 17)
    assert rows.dtype == np.float32 and rows.shape == (17, 3)
    for c in range(17):
        want = np.asarray([-opt.schedule(c), 1.0 - opt.B1 ** (c + 1),
                           1.0 - opt.b2 ** (c + 1)], np.float64)
        np.testing.assert_array_equal(rows[c], want.astype(np.float32))
    np.testing.assert_array_equal(opt.step_scalars(5, 12), rows[5:])


OPTIMIZERS = {
    "default": dict(lr=1e-3, weight_decay=5e-5, lr_decay=0.99,
                    steps_per_epoch=2),
    "clip_b2_cosine": dict(lr=3.5e-3, weight_decay=5e-5, lr_decay=0.99,
                           steps_per_epoch=2, warmup_epochs=1,
                           schedule_kind="cosine", n_epochs=4,
                           grad_clip=0.5, adam_b2=0.95),
    "no_decay": dict(lr=1e-2, weight_decay=0.0, lr_decay=0.9,
                     steps_per_epoch=1),
}


def _tree(rng):
    return {"conv": [{"w": rng.standard_normal((6, 5)),
                      "b": rng.standard_normal(5)}],
            "heads": {"w": rng.standard_normal((3, 4, 2))}}


def _tensors(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), tree)


def _run_both(opt, grads_seq, rng):
    """Adam.update (the loop) and Adam.update_ on static tensors with the
    staged scalars and the gradients' norm, over the same gradients:
    after each step, (the loop's state, its parameters, update_'s
    parameters, moments, updates applied and bad-step count)."""
    params = _tensors(_tree(rng))
    state = opt.init(params)
    leaves = [p.clone() for p in tree_leaves(params)]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    bad = torch.zeros((), dtype=torch.int64)
    scalars = torch.from_numpy(opt.step_scalars(0, len(grads_seq)))
    applied = 0
    out = []
    for grads in grads_seq:
        g = _tensors(grads)
        upd, state = opt.update(g, state, params)
        params = tree_unflatten(params, [
            p + u for p, u in zip(tree_leaves(params), tree_leaves(upd))])
        row = torch.cat((scalars[applied], global_norm(tree_leaves(g))))
        keep = opt.update_(tree_leaves(g), leaves, mu, nu, row, bad)
        applied += 1 if keep is None else int(keep)
        out.append((state, tree_leaves(params),
                    *([t.clone() for t in ts] for ts in (leaves, mu, nu)),
                    applied, int(bad)))
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_in_place_equals_update(name):
    """Adam.update_ with the staged float32 scalars gives Adam.update's
    parameters, moments and count bit for bit, step after step."""
    rng = np.random.default_rng(7)
    opt = make_optimizer(**OPTIMIZERS[name])
    grads = [_tree(rng) for _ in range(6)]
    for state, want, got, mu, nu, applied, _bad in _run_both(opt, grads,
                                                              rng):
        assert applied == state.count
        for a, b in zip(want + list(state.mu) + list(state.nu),
                        got + mu + nu):
            assert torch.equal(a, b)


def test_skip_nonfinite_on_device_equals_host():
    """skip_nonfinite 2 with NaN and Inf gradients injected: the device
    rule (optax.apply_if_finite: skip, keep the moments and the count,
    until more than 2 bad steps in a row) gives the host version's
    parameters, moments, count and bad-step count after every step."""
    rng = np.random.default_rng(3)
    opt = make_optimizer(lr=1e-3, weight_decay=5e-5, lr_decay=0.99,
                         steps_per_epoch=2, skip_nonfinite=2)
    grads = [_tree(rng) for _ in range(8)]
    for j, bad in ((1, np.nan), (2, np.nan), (3, np.inf), (5, np.nan)):
        grads[j]["conv"][0]["w"][0, 1] = bad
    seen = []
    for state, want, got, mu, nu, applied, n_bad in _run_both(opt, grads,
                                                              rng):
        seen.append((state.count, state.notfinite_count))
        assert (applied, n_bad) == (state.count, state.notfinite_count)
        for a, b in zip(want + list(state.mu) + list(state.nu),
                        got + mu + nu):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    # steps 2-3 skipped, the third bad step in a row goes through
    assert seen == [(1, 0), (1, 1), (1, 2), (2, 3), (3, 0), (3, 1),
                    (4, 0), (5, 0)]


def test_convergence_run_cli_cpu(tmp_path, topology_dir):
    """cli.convergence_run at a tiny size on the CPU: two epochs in
    segments of one, a curve line after each as run_segments writes it,
    then a resumed third epoch appended to the same curve, and the
    prediction export."""
    from semantichuman_torch.cli.convergence_run import main

    raw = _raw_cfg(epoch_scan=True, ck_frequency=1)
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(raw))
    wd = _workdir(tmp_path / "run", topology_dir)
    main(["--workdir", wd, "--config", str(config), "--epochs", "2",
          "--eval_every", "1", "--device", "cpu", "--banded", "1"])
    ck = os.path.join(wd, "checkpoints")
    main(["--workdir", wd, "--config", str(config), "--epochs", "3",
          "--eval_every", "1", "--device", "cpu", "--banded", "1",
          "--resume", ck])
    lines = [json.loads(line) for line in open(os.path.join(wd,
                                                            "curve.jsonl"))]
    assert [rec["epoch"] for rec in lines] == [1, 2, 3]
    for rec in lines:
        assert sorted(rec) == ["epoch", "l1", "mm", "sec_per_epoch"]
        assert np.isfinite(rec["mm"]) and rec["mm"] > 0
    assert os.path.exists(os.path.join(wd, "predictions", "predictions.npy"))
    assert os.path.isdir(os.path.join(ck, "3"))
