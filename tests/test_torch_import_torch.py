"""Reference checkpoints in the port (`utils/import_torch.py`) against the
JAX package's importer, on `.pth.tar` files written in the reference's
layout from `benchmarks/torch_baseline.py`'s torch model (the reference's
recipe) and from torch.optim.Adam: the imported weights, Adam moments and
both counters; the imported forward against the torch model; one resumed
step against the JAX and torch steps; the Trainer's resume_torch against
the JAX Trainer's, the epoch path against the loop after it, and the
training CLI's --resume_torch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke as CS
from benchmarks.torch_baseline import build_torch_model, reference_state_dict
from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.config import ModelConfig
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.topology import MeshHierarchy as TorchHier
from semantichuman_torch.train import optim as TO
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils import import_torch as TI
from semantichuman_torch.utils.params import (params_to_numpy, tree_leaves,
                                              tree_paths, tree_unflatten)
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.constants import KPS_INDEX_LIST, KPS_KEEP
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.topology.compiler import MeshHierarchy as JaxHier
from semantichuman_tpu.train import optim as JO
from semantichuman_tpu.train.loop import Trainer as JaxTrainer
from semantichuman_tpu.utils import import_torch as JI

from tests.conftest import SMALL_MODEL_OVERRIDES
from tests.test_torch_epoch_scan import _assert_same_state
from tests.test_torch_trainer import (_epoch_losses, _raw_cfg, _workdir,
                                      topology_dir)  # noqa: F401

torch.set_num_threads(1)

ENC, DEC = [3, 8, 8, 16, 16], [16, 16, 8, 8, 8]


def _port_model_cfg(**kw):
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    over = dict(SMALL_MODEL_OVERRIDES, banded_conv=False, **kw)
    return ModelConfig(**{k: v for k, v in over.items() if k in fields})


def _jax_model_cfg(**kw):
    return JaxConfig.from_dict({"model": dict(SMALL_MODEL_OVERRIDES,
                                              banded_conv=False, **kw)})


def _fixture_model(hier, part_dict, seed):
    """The torch reference-recipe PartAE (nz = nk = 8) on `hier`."""
    torch.manual_seed(seed)
    return build_torch_model(hier, hier.downsample_part_indices(part_dict),
                             KPS_INDEX_LIST, enc_filters=ENC, dec_filters=DEC)


def _adam_steps(model, x, kps, n, lr=1e-3, wd=5e-5):
    """n rec-loss steps of the reference's optimizer (main.py:262)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=wd)
    for _ in range(n):
        opt.zero_grad()
        rec = model(torch.as_tensor(x), torch.as_tensor(kps))[0]
        torch.mean(torch.abs(rec - torch.as_tensor(x))).backward()
        opt.step()
    return opt


def _save(path, model, opt, epoch, gamma):
    sd = reference_state_dict(model)
    assert len(list(model.parameters())) == len(sd)
    torch.save({"epoch": epoch, "autoencoder_state_dict": sd,
                "optimizer_state_dict": {} if opt is None
                else opt.state_dict(),
                "scheduler_state_dict": {"gamma": gamma,
                                         "last_epoch": epoch}}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def models(small_hierarchy, small_human, tmp_path_factory):
    """(JAX PartAE, port PartAE, JAX SpiralAE, port SpiralAE) on one
    hierarchy."""
    path = tmp_path_factory.mktemp("import_torch") / "hier.npz"
    small_hierarchy.save(str(path))
    th = TorchHier.load(str(path))
    pd = small_human.part_dict
    return (jax_build(_jax_model_cfg(), small_hierarchy, pd),
            torch_build(_port_model_cfg(), th, pd, device="cpu"),
            jax_build(_jax_model_cfg(model_type="neural3DMM", nz=16),
                      small_hierarchy),
            torch_build(_port_model_cfg(model_type="neural3DMM", nz=16), th,
                        device="cpu"))


@pytest.fixture(scope="module")
def batch(small_human):
    meshes = small_human.sample_meshes(3, seed=11).astype(np.float32)
    x = np.concatenate([meshes, np.zeros((3, 1, 3), np.float32)], axis=1)
    kps = np.einsum("jv,bvd->bjd",
                    small_human.J_regressor.astype(np.float32), meshes)
    return x, kps[:, KPS_KEEP].astype(np.float32)


def _spiral_state(model, seed):
    """A neural3DMM state dict in the reference's layout and order
    (chip_smoke.py's writer) from the model's init at `seed`."""
    return CS.reference_state_dict(model.init(seed), model)


def _assert_tree_equal(got, want):
    """A port tree (tensors) equals a JAX tree exactly, in the same
    structure."""
    jl, jtree = jax.tree.flatten(jax.tree.map(np.asarray, want))
    tl, ttree = jax.tree.flatten(params_to_numpy(got))
    assert ttree == jtree
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_import_part_ae_state_equals_jax(models, small_hierarchy,
                                         small_human):
    jm, tm, _, _ = models
    sd = reference_state_dict(_fixture_model(small_hierarchy,
                                             small_human.part_dict, 0))
    got = TI.import_part_ae_state(sd, tm)
    _assert_tree_equal(got, JI.import_part_ae_state(sd, jm))
    assert tree_paths(got) == tree_paths(tm.init(0))
    # a DataParallel 'module.' prefix is dropped
    pre = {f"module.{k}": v for k, v in sd.items()}
    _assert_tree_equal(TI.import_part_ae_state(pre, tm),
                       JI.import_part_ae_state(sd, jm))


def test_import_spiral_ae_state_equals_jax(models):
    _, _, jm, tm = models
    sd = _spiral_state(tm, 1)
    got = TI.import_spiral_ae_state(sd, tm)
    _assert_tree_equal(got, JI.import_spiral_ae_state(sd, jm))
    assert tree_paths(got) == tree_paths(tm.init(0))


def test_imported_forward_matches_torch(models, batch, small_hierarchy,
                                        small_human, tmp_path):
    """The port's forward from imported weights (through a `.pth.tar` and
    load_reference_checkpoint) against the torch model: z and z_kps atol
    2e-5, rec 2e-4 (the JAX package's tolerances)."""
    _, tm, _, _ = models
    fixture = _fixture_model(small_hierarchy, small_human.part_dict, 0)
    path = _save(tmp_path / "checkpoint7.pth.tar", fixture, None, 7, 0.99)
    params, epoch = TI.load_reference_checkpoint(path, tm)
    assert epoch == 7
    x, kps = batch
    with torch.no_grad():
        want = fixture(torch.as_tensor(x), torch.as_tensor(kps))
        got = tm(params, torch.as_tensor(x), torch.as_tensor(kps))
    for g, w, atol in zip(got, want, (2e-4, 2e-5, 2e-5)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol)


def _part_ckpt(tmp_path, hier, human, batch, n_steps, epoch, gamma):
    fixture = _fixture_model(hier, human.part_dict, 2)
    opt = _adam_steps(fixture, *batch, n_steps)
    return _save(tmp_path / f"checkpoint{epoch}.pth.tar", fixture, opt,
                 epoch, gamma), fixture, opt


def _spiral_ckpt(tmp_path, model, n_steps, epoch, gamma):
    """A neural3DMM checkpoint whose moments come from torch.optim.Adam on
    the reference-layout state (a sum-of-squares loss)."""
    sd = _spiral_state(model, 3)
    ps = [torch.nn.Parameter(v.clone()) for v in sd.values()]
    opt = torch.optim.Adam(ps, lr=1e-3, weight_decay=5e-5)
    for _ in range(n_steps):
        opt.zero_grad()
        sum((p * p).sum() for p in ps).backward()
        opt.step()
    path = str(tmp_path / f"n3dmm{epoch}.pth.tar")
    torch.save({"epoch": epoch,
                "autoencoder_state_dict": {k: p.detach() for k, p in
                                           zip(sd, ps)},
                "optimizer_state_dict": opt.state_dict(),
                "scheduler_state_dict": {"gamma": gamma}}, path)
    return path


def _optax_counts(opt_state):
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    sched = [s for s in jax.tree.leaves(
        opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)][0]
    return adam, int(sched.count)


@pytest.mark.parametrize("family", ["part_ae", "neural3dmm"])
@pytest.mark.parametrize("n_steps,epoch,spe", [(3, 3, 1), (5, 7, 4)],
                         ids=["counters_equal", "counters_differ"])
def test_training_state_equals_jax(models, batch, small_hierarchy,
                                   small_human, tmp_path, family, n_steps,
                                   epoch, spe):
    """load_reference_training_state against the JAX function on the same
    file: params, mu and nu exactly; Adam's count the torch step and the
    schedule's position epoch x steps_per_epoch, as optax's two counters,
    also where the two differ; a scheduler gamma other than lr_decay
    warns; a weights-only checkpoint gives no optimizer state."""
    jm, tm = models[:2] if family == "part_ae" else models[2:]
    if family == "part_ae":
        path = _part_ckpt(tmp_path, small_hierarchy, small_human, batch,
                          n_steps, epoch, 0.9)[0]
    else:
        path = _spiral_ckpt(tmp_path, tm, n_steps, epoch, 0.9)
    jopt = JO.make_optimizer(1e-3, 5e-5, lr_decay=0.9, steps_per_epoch=spe)
    with pytest.warns(UserWarning, match="gamma"):
        jp, js, je = JI.load_reference_training_state(
            path, jm, jopt, steps_per_epoch=spe, lr_decay=0.95)
    with pytest.warns(UserWarning, match="gamma"):
        tp, ts, te = TI.load_reference_training_state(
            path, tm, steps_per_epoch=spe, lr_decay=0.95)
    assert te == je == epoch
    _assert_tree_equal(tp, jp)
    adam, sched_count = _optax_counts(js)
    _assert_tree_equal(tree_unflatten(tp, ts.mu), adam.mu)
    _assert_tree_equal(tree_unflatten(tp, ts.nu), adam.nu)
    assert ts.count == int(adam.count) == n_steps
    assert ts.count + ts.schedule_offset == sched_count == epoch * spe
    assert float(ts.mu[0].abs().max()) > 0

    # weights only: no optimizer state
    ck = torch.load(path, weights_only=True)
    ck["optimizer_state_dict"] = {}
    torch.save(ck, str(tmp_path / "weights.pth.tar"))
    _, none, _ = TI.load_reference_training_state(
        str(tmp_path / "weights.pth.tar"), tm, steps_per_epoch=spe)
    assert none is None


def test_missing_optimizer_entries_get_zero_moments(models, tmp_path):
    """A parameter torch never stepped has no optimizer entry: its moments
    import as zeros, as in the JAX package."""
    _, _, jm, tm = models
    path = _spiral_ckpt(tmp_path, tm, 2, 1, 0.99)
    ck = torch.load(path, weights_only=True)
    del ck["optimizer_state_dict"]["state"][len(tree_leaves(tm.init(0))) - 1]
    torch.save(ck, path)
    jopt = JO.make_optimizer(1e-3, 5e-5, lr_decay=0.99, steps_per_epoch=1)
    _, js, _ = JI.load_reference_training_state(path, jm, jopt, 1)
    tp, ts, _ = TI.load_reference_training_state(path, tm, 1)
    adam, _ = _optax_counts(js)
    _assert_tree_equal(tree_unflatten(tp, ts.mu), adam.mu)
    last = ("dconv", len(tm.dec_plan) - 1, "b")
    for moments in (ts.mu, ts.nu):
        assert torch.count_nonzero(dict(zip(tree_paths(tp), moments))[last]) \
            == 0


def _entry(shape, step=1):
    return {"step": torch.tensor(float(step)),
            "exp_avg": torch.zeros(shape), "exp_avg_sq": torch.zeros(shape)}


@pytest.mark.parametrize("case", ["part_layout", "order", "range", "steps"])
def test_import_rejects(case, models, small_hierarchy, small_human):
    """A part head whose fan-in is not the model's, moments whose shapes
    are not their parameters' (the optimizer's order is not the state
    dict's), an optimizer index past the parameters, and per-parameter
    step counts that differ each raise ValueError."""
    if case == "part_layout":
        _, tm, _, _ = models
        sd = reference_state_dict(_fixture_model(
            small_hierarchy, small_human.part_dict, 0))
        w = sd["fc_latent_enc_list.0.weight"]
        sd["fc_latent_enc_list.0.weight"] = torch.cat([w, w], dim=1)
        with pytest.raises(ValueError, match="part layout mismatch"):
            TI.import_part_ae_state(sd, tm)
        return
    params_sd = {"a.weight": np.zeros((3, 2), np.float32),
                 "b.weight": np.zeros((4, 5), np.float32)}
    good = {"state": {0: _entry((3, 2)), 1: _entry((4, 5))}}
    ea, _, step = TI._moment_dicts(good, params_sd)
    assert step == 1 and set(ea) == {"a.weight", "b.weight"}
    bad, match = {
        "order": ({0: _entry((4, 5)), 1: _entry((3, 2))}, "order mismatch"),
        "range": ({5: _entry((3, 2))}, "out of range"),
        "steps": ({0: _entry((3, 2)), 1: _entry((4, 5), 2)}, "differ"),
    }[case]
    with pytest.raises(ValueError, match=match):
        TI._moment_dicts({"state": bad}, params_sd)


def test_resumed_step_matches_jax_and_torch(models, batch, small_hierarchy,
                                            small_human, tmp_path):
    """One more rec-loss Adam step from a mid-training reference
    checkpoint (weights, moments, step 3): the port's parameters against
    the JAX step's and torch's own next step, atol 3e-5."""
    jm, tm, _, _ = models
    path, fixture, opt = _part_ckpt(tmp_path, small_hierarchy, small_human,
                                    batch, 3, 3, 1.0)
    x, kps = batch
    topt = TO.make_optimizer(1e-3, 5e-5, lr_decay=1.0, steps_per_epoch=1)
    jopt = JO.make_optimizer(1e-3, 5e-5, lr_decay=1.0, steps_per_epoch=1)
    tp, ts, _ = TI.load_reference_training_state(path, tm, 1, lr_decay=1.0)
    jp, js, _ = JI.load_reference_training_state(path, jm, jopt, 1,
                                                 lr_decay=1.0)
    assert ts.count == 3 and ts.schedule_offset == 0

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    xt, kt = torch.as_tensor(x), torch.as_tensor(kps)
    rec = tm(tree_unflatten(tp, leaves), xt, kt)[0]
    grads = torch.autograd.grad(torch.mean(torch.abs(rec - xt)), leaves)
    updates, ts1 = topt.update(tree_unflatten(tp, list(grads)), ts, tp)
    assert ts1.count == 4
    got = params_to_numpy(tree_unflatten(
        tp, [p + u for p, u in zip(tree_leaves(tp), tree_leaves(updates))]))

    def loss_fn(p):
        r = jm(p, jnp.asarray(x), jnp.asarray(kps))[0]
        return jnp.mean(jnp.abs(r - jnp.asarray(x)))

    jupd, _ = jopt.update(jax.grad(loss_fn)(jp), js, jp)
    want_jax = jax.tree.map(lambda p, u: np.asarray(p + u), jp, jupd)

    opt.zero_grad()
    r = fixture(xt, kt)[0]
    torch.mean(torch.abs(r - xt)).backward()
    opt.step()
    want_torch = params_to_numpy(TI.import_part_ae_state(
        reference_state_dict(fixture), tm))
    for want in (want_jax, want_torch):
        for i, (a, b) in enumerate(zip(jax.tree.leaves(got),
                                       jax.tree.leaves(want))):
            np.testing.assert_allclose(a, b, atol=3e-5, err_msg=f"leaf {i}")


# --- the Trainer --------------------------------------------------------------

def _raw(**train):
    raw = _raw_cfg(**train)
    raw["model"]["banded_conv"] = False
    return raw


@pytest.fixture(scope="module")
def trainer_ckpt(tmp_path_factory, topology_dir, small_human):
    """A reference checkpoint of the Trainers' small PartAE (their
    hierarchy file): epoch 1 after 3 torch Adam steps, so Adam's count (3)
    and the schedule's position (1 x 4 steps an epoch) differ."""
    hier = JaxHier.load(str(topology_dir / "topology_2222.npz"))
    fixture = _fixture_model(hier, small_human.part_dict, 4)
    # a part with no coarse vertex gets a zero bias from torch's init, and
    # the relative zpartreg of a z that is 0 is NaN: draw it as the port's
    # init does (the bound of a fan-in of 1)
    with torch.no_grad():
        for head in fixture.enc_heads:
            if head.in_features == 0:
                head.bias.uniform_(-1.0, 1.0)
    meshes = small_human.sample_meshes(4, seed=21).astype(np.float32)
    x = np.concatenate([meshes, np.zeros((4, 1, 3), np.float32)], axis=1)
    kps = np.einsum("jv,bvd->bjd", small_human.J_regressor.astype(
        np.float32), meshes)[:, KPS_KEEP].astype(np.float32)
    opt = _adam_steps(fixture, x, kps, 3)
    d = tmp_path_factory.mktemp("trainer_ckpt")
    return _save(d / "checkpoint1.pth.tar", fixture, opt, 1, 0.99)


def test_trainer_resume_torch_matches_jax(tmp_path, topology_dir,
                                          trainer_ckpt):
    """Both Trainers resumed from one reference checkpoint train epoch 2:
    its train and val loss to rtol 1e-4 and the parameters to atol 1e-4,
    as the Trainer's parity tests."""
    jd = _workdir(tmp_path / "jax", topology_dir)
    td = _workdir(tmp_path / "torch", topology_dir)
    jt = JaxTrainer(JaxConfig.from_dict(_raw(resume_torch=trainer_ckpt)), jd)
    tt = TorchTrainer(TorchConfig.from_dict(_raw(resume_torch=trainer_ckpt)),
                      td, device="cpu")
    assert (tt.start_epoch, tt.global_step) == (jt.start_epoch,
                                                jt.global_step) == (2, 4)
    assert (tt.opt_state.count, tt.opt_state.schedule_offset) == (3, 1)
    jt.fit()
    tt.fit()
    want, got = _epoch_losses(jd), _epoch_losses(td)
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == [2]
    assert np.all(np.isfinite(got[0][1:]))
    np.testing.assert_allclose(got[0][1:], want[0][1:], rtol=1e-4)
    assert tt.opt_state.count == 7 and tt.global_step == 8
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")


def test_epoch_path_matches_loop_after_resume_torch(tmp_path, topology_dir,
                                                    trainer_ckpt):
    """After a resume_torch whose two counters differ, the epoch path
    (its Adam scalars staged from count and the schedule's offset) equals
    the loop bit for bit over two epochs; the part heads' zero pads and
    their moments stay exactly 0."""
    runs = []
    for scan in (True, False):
        tr = TorchTrainer(TorchConfig.from_dict(_raw(
            resume_torch=trainer_ckpt, epoch_scan=scan, n_epochs=3)),
            _workdir(tmp_path / f"scan{scan}", topology_dir), device="cpu")
        assert tr._epoch_scan_ok() == scan
        tr.fit()
        runs.append(tr)
    _assert_same_state(*runs)
    assert np.all(np.isfinite([h["train"] for h in runs[0].history]))
    assert runs[0].opt_state.schedule_offset == 1
    tr = runs[0]
    for leaves in (tree_leaves(tr.params), tr.opt_state.mu, tr.opt_state.nu):
        pads = CS.part_pads(tree_unflatten(tr.params, leaves), tr.model)
        assert sum(int(torch.count_nonzero(t)) for t in pads) == 0


def test_cli_resume_torch_cpu(tmp_path, topology_dir, trainer_ckpt):
    """`cli.train --resume_torch P.pth.tar` resumes at epoch 2 with the
    checkpoint's Adam state; with --finetune it keeps the weights alone
    and starts at epoch 1; --resume with it raises."""
    import yaml

    from semantichuman_torch.cli import train as train_cli
    cfg = tmp_path / "c.yaml"
    raw = _raw(eval_flag=False)
    cfg.write_text(yaml.safe_dump(raw))
    args = ["--config", str(cfg), "--device", "cpu", "--epochs", "2",
            "--resume_torch", trainer_ckpt]
    tr = train_cli.main(args + ["--workdir",
                                _workdir(tmp_path / "a", topology_dir)])
    assert [h["epoch"] for h in tr.history] == [2]
    assert tr.opt_state.count == 7
    tr = train_cli.main(args + ["--finetune", "--epochs", "1", "--workdir",
                                _workdir(tmp_path / "b", topology_dir)])
    assert [h["epoch"] for h in tr.history] == [1]
    assert (tr.opt_state.count, tr.opt_state.schedule_offset) == (4, 0)
    with pytest.raises(ValueError, match="resume_torch"):
        TorchTrainer(TorchConfig.from_dict(_raw(resume="x",
                                                resume_torch="y")),
                     _workdir(tmp_path / "c", topology_dir), device="cpu")
