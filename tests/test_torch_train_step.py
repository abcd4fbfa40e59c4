"""The port's training step against the JAX package's: the edit sampler,
the optimizer and its schedules, the epoch gates, one full train step
(loss, metrics, per-leaf gradients, parameters after one Adam step) and
the eval step, from the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semantichuman_torch.config import ModelConfig, TrainConfig
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.topology import MeshHierarchy as TorchHier
from semantichuman_torch.train import edits as TE
from semantichuman_torch.train import losses as TL
from semantichuman_torch.train import optim as TO
from semantichuman_torch.train import step as TS
from semantichuman_torch.utils.params import (params_from_jax,
                                              params_to_numpy, tree_leaves)
from semantichuman_tpu.config import Config
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.ops.distance import (face_edge_lengths,
                                            signed_part_volumes)
from semantichuman_tpu.train import edits as JE
from semantichuman_tpu.train import losses as JL
from semantichuman_tpu.train import optim as JO
from semantichuman_tpu.train import step as JS

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

B = 4


# --- edit sampler ------------------------------------------------------------

SAMPLERS = [
    dict(edit_mode="equal"),
    dict(edit_mode="equal", editskl_flag=True),
    dict(edit_mode="rand"),
    dict(edit_mode="rand", rand_mode="warm_up", editskl_flag=True),
    dict(edit_mode="rand", noleaf_flag=False, factor=(0.2, 0.9)),
    dict(edit_mode="exc"),
]


@pytest.mark.parametrize("kw", SAMPLERS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_edit_sampler_equals_jax(kw):
    """Same seed, same arrays, step after step, across a reseed, and the
    same exc-variant coin flips."""
    measure = np.random.default_rng(0).uniform(0.5, 2.0, (B, 32)).astype(
        np.float32)
    t = TE.EditSampler(seed=3, exc_mode="ori_or_m", **kw)
    j = JE.EditSampler(seed=3, exc_mode="ori_or_m", **kw)
    for epoch in (1, 30, 60, 80, 150, 150):
        if epoch == 60:
            t.reseed(epoch)
            j.reseed(epoch)
        got = t.sample_interp(epoch, B, measure=measure)
        want = j.sample_interp(epoch, B, measure=measure)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert t.sample_exc_variant() == j.sample_exc_variant()


def test_edit_sampler_rejects_like_jax():
    with pytest.raises(ValueError, match="needs the batch measures"):
        TE.EditSampler(edit_mode="exc").sample_interp(1, B)
    with pytest.raises(ValueError, match="edit_mode"):
        TE.EditSampler(edit_mode="nope").sample_interp(1, B)
    for mode in ("ori", "m", "ori_m"):
        assert TE.EditSampler(exc_mode=mode).sample_exc_variant() == mode


# --- optimizer ----------------------------------------------------------------

OPTIMIZERS = {
    "exp": dict(lr=1e-3, weight_decay=5e-5, lr_decay=0.9, steps_per_epoch=2),
    "cosine_warmup": dict(lr=4e-3, weight_decay=5e-5, lr_decay=0.0,
                          steps_per_epoch=1, warmup_epochs=3,
                          schedule_kind="cosine", n_epochs=6),
    "clip": dict(lr=1e-3, weight_decay=5e-5, lr_decay=0.99,
                 steps_per_epoch=1, grad_clip=0.5),
    "adam_b2": dict(lr=1e-3, weight_decay=0.0, lr_decay=0.99,
                    steps_per_epoch=1, adam_b2=0.95),
    "skip_nonfinite": dict(lr=1e-3, weight_decay=5e-5, lr_decay=0.99,
                           steps_per_epoch=1, skip_nonfinite=2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Six updates of the port's Adam against the optax chain on the same
    gradients (one holds NaN under skip_nonfinite, three in a row exhaust
    it): updates to f32 rounding (rtol 1e-5, atol 1e-9)."""
    kw = OPTIMIZERS[name]
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": [(4,), (2, 2)]}
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(s).astype(np.float32)
                    for s in shapes["b"]]}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 3.0, params) for _ in range(6)]
    if name == "skip_nonfinite":
        for k in (1, 3, 4, 5):
            grads[k]["a"][0, 0] = np.nan if k != 5 else 1.0
    jopt = JO.make_optimizer(**kw)
    topt = TO.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(params_from_jax(g, "cpu"), ts, tp)
        for a, b in zip(tree_leaves(params_to_numpy(tu)),
                        jax.tree.leaves(ju)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-9)
        jp = optax.apply_updates(jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu,
                          is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, lr_decay=0.9, steps_per_epoch=2),
    dict(lr=4e-3, lr_decay=0.0, steps_per_epoch=2, schedule_kind="cosine",
         n_epochs=100),
    dict(lr=4e-3, lr_decay=1.0, steps_per_epoch=2, warmup_epochs=10),
    dict(lr=4e-3, lr_decay=0.95, steps_per_epoch=3, warmup_epochs=2,
         schedule_kind="cosine", n_epochs=5),
])
def test_schedule_matches_jax(kw):
    t, j = TO.make_schedule(**kw), JO.make_schedule(**kw)
    for step in (0, 1, 2, 5, 9, 19, 40, 200, 201):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                   atol=1e-12)


def test_schedule_rejects_like_jax():
    with pytest.raises(ValueError, match="n_epochs"):
        TO.make_schedule(1e-3, 0.9, 2, schedule_kind="cosine")
    with pytest.raises(ValueError, match="schedule_kind"):
        TO.make_schedule(1e-3, 0.9, 2, schedule_kind="linear")


# --- epoch gates --------------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1, 3, 7])
def test_flags_for_epoch_match_jax(epoch):
    from semantichuman_tpu.config import TrainConfig as JaxTrain
    over = dict(edgereg_epoch=2, vol_epoch=5, interp_epoch=0, exc_epoch=1,
                zpartreg_w=0.0, w_mode="sin", relat_flag=False)
    got = TS.flags_for_epoch(TrainConfig(**over), epoch)
    want = JS.flags_for_epoch(JaxTrain(**over), epoch)
    want = {f.name: getattr(want, f.name)
            for f in dataclasses.fields(want) if f.name != "fused_dist"}
    assert dataclasses.asdict(got) == want


# --- one full train step ------------------------------------------------------

@pytest.fixture(scope="module")
def step_case(small_hierarchy, small_human, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_step") / "hier.npz"
    small_hierarchy.save(str(path))
    jcfg = Config.from_dict({"model": dict(SMALL_MODEL_OVERRIDES,
                                           banded_conv=False)})
    jm = jax_build(jcfg, small_hierarchy, small_human.part_dict)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    tm = torch_build(ModelConfig(**{k: v for k, v in
                                    SMALL_MODEL_OVERRIDES.items()
                                    if k in fields}),
                     TorchHier.load(str(path)), small_human.part_dict,
                     device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(0))
    jt = JL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict)
    tt = TL.build_loss_tables(small_human.template_faces,
                              small_human.J_regressor, small_human.part_dict,
                              device="cpu")
    meshes = small_human.sample_meshes(3 * B, seed=5).astype(np.float32)
    measure = small_human.measures(meshes).astype(np.float32)
    verts = np.concatenate([meshes, np.zeros((3 * B, 1, 3), np.float32)], 1)
    faces = jnp.asarray(jt.faces)
    edges = np.asarray(face_edge_lengths(jnp.asarray(meshes), faces))
    vols = np.asarray(signed_part_volumes(
        jnp.asarray(meshes), faces, jnp.asarray(jt.face_part_mask)))
    segs = []
    for k in range(3):
        sl = slice(k * B, (k + 1) * B)
        segs.append({"verts": verts[sl], "measure": measure[sl],
                     "gt_face_edges": edges[sl], "gt_part_vols": vols[sl]})
    spec = JE.EditSampler(edit_mode="rand", seed=0).sample_interp(200, B)
    return jm, jp, tm, jt, tt, segs, spec


def _inputs(segs, spec, with_gt: bool, to):
    keep = ("verts", "measure") + (("gt_face_edges", "gt_part_vols")
                                   if with_gt else ())
    batches = [{k: to(np.array(s[k])) for k in keep} for s in segs]
    return batches + [{k: to(v) for k, v in spec.items()}]


def _max_rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("with_gt", [False, True], ids=["gt_in_step",
                                                         "gt_staged"])
@pytest.mark.parametrize("exc_variant", ["ori", "m"])
def test_train_step_matches_jax(step_case, exc_variant, with_gt):
    """One step of the full loss stack from identical params, batches and
    edit spec.  Loss and metrics to rtol 1e-5 (f32 sums in another order
    through nine convs and the losses); per-leaf gradients to 1e-4 of the
    leaf's largest entry; parameters after one Adam step to atol 1e-5
    (every update is bounded by lr = 1e-3)."""
    jm, jp, tm, jt, tt, segs, spec = step_case
    flags = JS.StepFlags(fused_dist=False)
    jloss = JS.make_loss_fn(jm, jt, flags, exc_variant)
    tflags = TS.StepFlags()
    tloss = TS.make_loss_fn(tm, tt, tflags, exc_variant)

    jargs = _inputs(segs, spec, with_gt, jnp.asarray)
    targs = _inputs(segs, spec, with_gt, torch.as_tensor)
    jpj = jax.tree.map(jnp.asarray, jp)
    tp = params_from_jax(jp, "cpu")
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jpj, *jargs)
    tl, tmet, tg = TS.value_and_grad(tloss, tp, *targs)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    jleaves = jax.tree.leaves(jg)
    tleaves = tree_leaves(params_to_numpy(tg))
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        assert a.shape == b.shape
        assert _max_rel(a, np.asarray(b)) <= 1e-4, f"leaf {i}"

    # the whole step: Adam from a fresh state
    jopt = JO.make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    topt = TO.make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    jstep = JS.make_train_step(jm, jt, jopt, flags, exc_variant,
                               donate=False)
    tstep = TS.make_train_step(tm, tt, topt, tflags, exc_variant)
    jp1, _, jm1 = jstep(jpj, jopt.init(jpj), *jargs)
    tp1, tstate, tm1 = tstep(tp, topt.init(tp), *targs)
    assert tstate.count == 1
    np.testing.assert_allclose(float(tm1["gnorm"]), float(jm1["gnorm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm1["loss"]), float(jm1["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(params_to_numpy(tp1)),
                    jax.tree.leaves(jp1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    # the step returns new tensors and leaves its inputs alone
    for a, b in zip(tree_leaves(params_to_numpy(tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_exchanged_and_edited_kps_match_jax(step_case):
    """The exc branch's skeleton swaps (every variant, 'dynamic' both
    ways) and the editskl re-integration (atol 1e-6)."""
    *_, segs, spec = step_case
    kps = np.einsum("jv,bvd->bjd", np.random.default_rng(1).uniform(
        0, 0.1, (35, segs[0]["verts"].shape[1] - 1)), segs[0]["verts"][:, :-1]
    ).astype(np.float32)
    tk, jk = torch.as_tensor(kps), jnp.asarray(kps)
    for variant, is_ori in (("ori", None), ("m", None), ("ori_m", None),
                            ("dynamic", 1.0), ("dynamic", 0.0)):
        got = TS._exchanged_kps(tk, variant, None if is_ori is None
                                else torch.tensor(is_ori))
        want = JS._exchanged_kps(jk, variant, None if is_ori is None
                                 else jnp.float32(is_ori))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   err_msg=f"{variant} {is_ori}")
    fac = np.linspace(0.8, 1.2, 31).astype(np.float32)
    np.testing.assert_allclose(
        TS._edited_kps(tk, torch.as_tensor(fac)).numpy(),
        np.asarray(JS._edited_kps(jk, jnp.asarray(fac))), atol=1e-6)


def test_eval_step_matches_jax(step_case):
    jm, jp, tm, jt, tt, segs, _spec = step_case
    batch = {"verts": segs[0]["verts"]}
    want = JS.make_eval_step(jm, jt)(jax.tree.map(jnp.asarray, jp),
                                     {"verts": jnp.asarray(batch["verts"])})
    got = TS.make_eval_step(tm, tt)(params_from_jax(jp, "cpu"),
                                    {"verts": torch.as_tensor(
                                        batch["verts"])})
    for k in ("l1", "l2_mm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, err_msg=k)
    assert got["rec"].shape == tuple(want["rec"].shape)
