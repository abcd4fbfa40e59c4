"""The port's neural3DMM baseline against the JAX package's: SpiralAE init,
forward, encode and decode (the VAE's mean path and its sampled path), the
baseline loss and its gradient, the baseline train and eval steps, and the
Trainer with model_type neural3DMM against the JAX Trainer."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.config import ModelConfig
from semantichuman_torch.models import SpiralAE
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.topology import MeshHierarchy as TorchHier
from semantichuman_torch.train import losses as TL
from semantichuman_torch.train import optim as TO
from semantichuman_torch.train import step as TS
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils.params import (params_from_jax,
                                              params_to_numpy, tree_leaves)
from semantichuman_tpu.config import Config
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.ops.distance import face_edge_lengths
from semantichuman_tpu.train import losses as JL
from semantichuman_tpu.train import optim as JO
from semantichuman_tpu.train import step as JS
from semantichuman_tpu.train.loop import Trainer as JaxTrainer

from tests.conftest import SMALL_MODEL_OVERRIDES
from tests.test_torch_trainer import (_epoch_losses, _raw_cfg, _workdir,
                                      topology_dir)  # noqa: F401

torch.set_num_threads(1)

# f32 sums in another order through nine convs and two dense layers
RTOL = ATOL = 1e-4
NZ = 16
B = 3


def _overrides(**kw):
    return dict(SMALL_MODEL_OVERRIDES, model_type="neural3DMM", nz=NZ,
                banded_conv=False, **kw)


def _models(hier, path, human, **kw):
    """(JAX model, port model) of the small baseline on one hierarchy."""
    jm = jax_build(Config.from_dict({"model": _overrides(**kw)}), hier)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    tcfg = ModelConfig(**{k: v for k, v in _overrides(**kw).items()
                          if k in fields})
    return jm, torch_build(tcfg, TorchHier.load(str(path)), device="cpu")


@pytest.fixture(scope="module")
def hier_path(small_hierarchy, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_spiral_ae") / "hier.npz"
    small_hierarchy.save(str(path))
    return path


@pytest.fixture(scope="module", params=[False, True], ids=["ae", "vae"])
def pair(request, small_hierarchy, small_human, hier_path):
    jm, tm = _models(small_hierarchy, hier_path, small_human,
                     vae=request.param)
    return jm, jax.tree.map(np.asarray, jm.init(0)), tm


def _verts(human, b, seed):
    m = human.sample_meshes(b, seed=seed).astype(np.float32)
    return np.concatenate([m, np.zeros((b, 1, 3), np.float32)], axis=1)


def test_build_model_needs_no_part_dict(pair):
    _jm, _jp, tm = pair
    assert isinstance(tm, SpiralAE)
    assert len(tm.enc_plan) == 4 and len(tm.dec_plan) == 5


def test_init_equals_jax(pair):
    """SpiralAE.init(0) gives the JAX package's arrays exactly, leaf for
    leaf, in the same tree."""
    _jm, jp, tm = pair
    jl, jtree = jax.tree.flatten(jp)
    tl, ttree = jax.tree.flatten(params_to_numpy(tm.init(0)))
    assert ttree == jtree
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    z_out = 2 * NZ if tm.vae else NZ
    assert tuple(tm.init(0)["fc_enc"]["w"].shape) == (
        tm.coarse_rows * tm.enc_out_c, z_out)


@pytest.mark.parametrize("fn", ["forward", "encode", "decode"])
def test_spiral_ae_matches_jax(pair, small_human, fn):
    """From the same params: forward, encode (the VAE's mean) and decode
    to rtol = atol = 1e-4; the decoded dummy row exactly 0."""
    jm, jp, tm = pair
    tp, jpj = params_from_jax(jp, "cpu"), jax.tree.map(jnp.asarray, jp)
    verts = _verts(small_human, B, seed=5)
    z = np.random.default_rng(5).standard_normal((B, NZ)).astype(np.float32)
    arg = z if fn == "decode" else verts
    call = {"forward": lambda m, p, a: m(p, a),
            "encode": lambda m, p, a: m.encode(p, a),
            "decode": lambda m, p, a: m.decode(p, a)}[fn]
    want = call(jm, jpj, jnp.asarray(arg))
    with torch.no_grad():
        got = call(tm, tp, torch.from_numpy(arg))
    if fn != "forward":
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=fn)
    if fn != "encode":
        assert torch.count_nonzero(got[0][:, -1]) == 0


def test_vae_samples_with_a_generator(small_hierarchy, small_human,
                                      hier_path):
    """The VAE samples mu + eps * std only when given a torch.Generator
    (jax.random's draws cannot be matched bit for bit): over 2000 draws
    for one mesh the sample mean is mu and the sample spread exp(logvar /
    2), each to 4 standard errors; the same generator seed repeats the
    draw."""
    _jm, tm = _models(small_hierarchy, hier_path, small_human, vae=True)
    tp = tm.init(4)
    x = torch.from_numpy(_verts(small_human, 1, seed=9))
    n = 2000
    with torch.no_grad():
        plain = copy.copy(tm)
        plain.vae = False
        full = plain.encode(tp, x)[0]
        mu, std = full[:NZ], torch.exp(full[NZ:] / 2.0)
        assert torch.equal(tm.encode(tp, x)[0], mu)
        h = x.expand(n, -1, -1)
        draws = tm.encode(tp, h, torch.Generator().manual_seed(3))
        again = tm.encode(tp, h[:4], torch.Generator().manual_seed(3))
    assert torch.equal(again, draws[:4])
    se = std / np.sqrt(n)
    assert torch.all((draws.mean(0) - mu).abs() < 4 * se)
    assert torch.all((draws.std(0) / std - 1).abs() < 4 / np.sqrt(2 * n))


@pytest.fixture(scope="module")
def loss_case(small_hierarchy, small_human, hier_path):
    jm, tm = _models(small_hierarchy, hier_path, small_human)
    jp = jax.tree.map(np.asarray, jm.init(1))
    jt = JL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict)
    tt = TL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict,
                              device="cpu")
    verts = _verts(small_human, 4, seed=6)
    edges = np.asarray(face_edge_lengths(jnp.asarray(verts[:, :-1]),
                                         jnp.asarray(jt.faces)))
    return jm, jp, tm, jt, tt, verts, edges


def _max_rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("edgereg", [True, False])
@pytest.mark.parametrize("with_gt", [False, True],
                         ids=["gt_in_step", "gt_staged"])
def test_baseline_step_matches_jax(loss_case, edgereg, with_gt):
    """make_baseline_loss_fn against the JAX one: loss and metrics to rtol
    1e-5, per-leaf gradients to 1e-4 of the leaf's largest entry; then one
    make_baseline_train_step (parameters to atol 1e-5, every update
    bounded by lr = 1e-3; gnorm rtol 1e-5)."""
    jm, jp, tm, jt, tt, verts, edges = loss_case
    batch = {"verts": verts}
    if with_gt:
        batch["gt_face_edges"] = edges
    jflags = JS.StepFlags(edgereg=edgereg)
    tflags = TS.StepFlags(edgereg=edgereg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jpj, tp = jax.tree.map(jnp.asarray, jp), params_from_jax(jp, "cpu")
    (_, jmet), jg = jax.value_and_grad(
        JS.make_baseline_loss_fn(jm, jt, jflags), has_aux=True)(jpj, jb)
    _, tmet, tg = TS.value_and_grad(
        TS.make_baseline_loss_fn(tm, tt, tflags), tp, tb)
    assert sorted(tmet) == sorted(jmet)
    assert ("edgereg" in tmet) == edgereg
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(params_to_numpy(tg))
    assert len(jleaves) == len(tleaves) == 22
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a.shape == b.shape
        assert _max_rel(a, np.asarray(b)) <= 1e-4, f"leaf {i}"

    jopt = JO.make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    topt = TO.make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    jstep = JS.make_baseline_train_step(jm, jt, jopt, jflags, donate=False)
    tstep = TS.make_baseline_train_step(tm, tt, topt, tflags)
    jp1, _, jm1 = jstep(jpj, jopt.init(jpj), jb)
    tp1, tstate, tm1 = tstep(tp, topt.init(tp), tb)
    assert tstate.count == 1
    for k in ("gnorm", "loss"):
        np.testing.assert_allclose(float(tm1[k]), float(jm1[k]), rtol=1e-5)
    for a, b in zip(tree_leaves(params_to_numpy(tp1)),
                    jax.tree.leaves(jp1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_baseline_eval_step_matches_jax(loss_case):
    """The eval step's baseline branch: rec, z and the per-sample metrics
    to rtol 1e-4; z_kps [B, 0, 0] as in the JAX package."""
    jm, jp, tm, jt, tt, verts, _ = loss_case
    want = JS.make_eval_step(jm, jt)(jax.tree.map(jnp.asarray, jp),
                                     {"verts": jnp.asarray(verts)})
    got = TS.make_eval_step(tm, tt)(params_from_jax(jp, "cpu"),
                                    {"verts": torch.from_numpy(verts)})
    assert tuple(got["z_kps"].shape) == want["z_kps"].shape == (4, 0, 0)
    for k in ("rec", "z", "l1", "l2_mm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _n3dmm_raw(**train):
    raw = _raw_cfg(**train)
    raw["model"] = _overrides()
    return raw


@pytest.fixture(scope="module")
def n3dmm_runs(tmp_path_factory, topology_dir):
    """Both Trainers with model_type neural3DMM, seed 2, two epochs from
    the same hierarchy file."""
    base = tmp_path_factory.mktemp("n3dmm")
    jax_dir = _workdir(base / "jax", topology_dir)
    torch_dir = _workdir(base / "torch", topology_dir)
    jt = JaxTrainer(Config.from_dict(_n3dmm_raw()), jax_dir)
    jt.fit()
    tt = TorchTrainer(TorchConfig.from_dict(_n3dmm_raw()), torch_dir,
                      device="cpu")
    assert isinstance(tt.model, SpiralAE) and not tt._epoch_scan_ok()
    tt.fit()
    return jt, tt, jax_dir, torch_dir


def test_trainer_matches_jax(n3dmm_runs):
    """Per-epoch train and val loss to rtol 1e-4, the final parameters to
    atol 1e-4 after 8 Adam steps, and evaluate()'s predictions and metrics
    to the PartAE Trainer's parity tolerances."""
    jt, tt, jax_dir, torch_dir = n3dmm_runs
    want, got = _epoch_losses(jax_dir), _epoch_losses(torch_dir)
    assert [e for e, _, _ in got] == [e for e, _, _ in want] == [1, 2]
    for (e, jtr, jval), (_, ttr, tval) in zip(want, got):
        np.testing.assert_allclose(ttr, jtr, rtol=1e-4, err_msg=f"train {e}")
        np.testing.assert_allclose(tval, jval, rtol=1e-4, err_msg=f"val {e}")
    assert tt.global_step == jt.global_step == 8
    jl = jax.tree.leaves(jax.tree.map(np.asarray, jt.params))
    tl = jax.tree.leaves(params_to_numpy(tt.params))
    assert len(jl) == len(tl) == 22
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                   err_msg=f"leaf {i}")
    jp, jz, jzk, jtx, jl1, jmm = jt.evaluate()
    tp, tz, tzk, ttx, tl1, tmm = tt.evaluate()
    assert tzk.shape == jzk.shape == (len(ttx), 0, 0)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    # z sums 624 products with trained fc_enc weights that agree to ~1e-5
    # each (1.5e-4 apart at most, measured): atol 1e-3
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-3)
    np.testing.assert_allclose([tl1, tmm], [jl1, jmm], rtol=1e-4)
