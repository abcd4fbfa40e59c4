"""The port's editing suite against the JAX package's on the same inputs:
the five edit ops, the skeleton edit and orientation weights, the body
measures, the Editor and run_demo (mirrors tests/test_edit.py, one
counterpart per test there, plus JAX parity)."""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.config import ModelConfig
from semantichuman_torch.constants import (MEASURE_SKL_LIST, NEWSKL_LIST,
                                           PART_LIST, SKL_LIST)
from semantichuman_torch.data.assets import BodyAssets as TorchAssets
from semantichuman_torch.edit import Editor, run_demo
from semantichuman_torch.edit import ops as TE
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.ops import measure as TM
from semantichuman_torch.ops import skeleton as TK
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_torch.topology.obj_io import load_obj
from semantichuman_torch.utils.params import params_from_jax
from semantichuman_tpu.data.assets import BodyAssets as JaxAssets
from semantichuman_tpu.edit import Editor as JaxEditor
from semantichuman_tpu.edit import ops as JE
from semantichuman_tpu.edit import run_demo as jax_run_demo
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.ops import measure as JM
from semantichuman_tpu.ops import skeleton as JK

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

CFG = ModelConfig(**{k: v for k, v in SMALL_MODEL_OVERRIDES.items()
                     if k in {f.name for f in dataclasses.fields(ModelConfig)}})
N_BONES = len(NEWSKL_LIST)


def _assets(cls, human):
    return cls(template_verts=human.template_verts,
               template_faces=human.template_faces,
               j_regressor=human.J_regressor, part_dict=human.part_dict,
               girth_edges=human.girth_edges,
               girth_factors=human.girth_factors)


@pytest.fixture(scope="module")
def editors(small_cfg, small_hierarchy, small_human, tmp_path_factory):
    """(port Editor, JAX Editor) over the same parameters."""
    path = tmp_path_factory.mktemp("torch_edit") / "hier.npz"
    small_hierarchy.save(str(path))
    hier = MeshHierarchy.load(str(path))
    jm = jax_build(small_cfg, small_hierarchy, small_human.part_dict)
    jp = jm.init(0)
    tm = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (Editor(tm, tp, _assets(TorchAssets, small_human), device="cpu"),
            JaxEditor(jm, jp, _assets(JaxAssets, small_human)))


@pytest.fixture(scope="module")
def editor(editors):
    return editors[0]


@pytest.fixture(scope="module")
def meshes(small_human):
    return small_human.sample_meshes(4, seed=7).astype(np.float32)


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# --- the edit ops against JAX ------------------------------------------------

EDIT_CASES = {
    "orientation": lambda m, a, b: m.transplant_orientation(a, b, [3, 5, 14]),
    "bonelen_scalar": lambda m, a, b: m.scale_bone_length(a, [2, 4], 1.5),
    "bonelen_per_bone": lambda m, a, b: m.scale_bone_length(
        a, [2, 4, 30], np.asarray([1.1, 0.8, 1.3], np.float32)),
    "bonelen_per_sample": lambda m, a, b: m.scale_bone_length(
        a, [1, 7], np.asarray([[1.1, 0.9], [1.2, 0.7], [0.5, 2.0]],
                              np.float32)),
    "girth_names": lambda m, a, b: m.scale_girth(
        a[..., :17, :], ["chest", "hip"], 1.2),
    "girth_indices": lambda m, a, b: m.scale_girth(
        a[..., :17, :], [0, 16, 4], 0.7),
    "girth_per_part": lambda m, a, b: m.scale_girth(
        a[..., :17, :], ["neck", "head"],
        np.asarray([[1.5], [0.5]], np.float32)),
    "style_all": lambda m, a, b: m.style_transfer_z(a[..., :17, :],
                                                    b[..., :17, :]),
    "style_parts": lambda m, a, b: m.style_transfer_z(
        a[..., :17, :], b[..., :17, :], [11, 2]),
    "interp_scalar": lambda m, a, b: m.interpolate_z(a, b, 0.3),
    "interp_array": lambda m, a, b: m.interpolate_z(
        a, b, np.asarray([0.0, 0.5, 1.0], np.float32)[:, None, None]),
}


@pytest.mark.parametrize("case", sorted(EDIT_CASES))
def test_edit_ops_match_jax(case):
    """Each edit op equals the JAX op on the same arrays (1e-6), and leaves
    its inputs as they were."""
    a, b = _rng_arrays(1, (3, N_BONES, 4), (3, N_BONES, 4))
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    got = EDIT_CASES[case](TE, ta, tb)
    want = EDIT_CASES[case](JE, jnp.asarray(a), jnp.asarray(b))
    _close(got.numpy(), want, 1e-6)
    assert np.array_equal(ta.numpy(), a) and np.array_equal(tb.numpy(), b)


@pytest.mark.parametrize("call, match", [
    (lambda m, z: m.scale_girth(z, ["tail"], 2.0), "unknown part"),
    (lambda m, z: m.scale_girth(z, [17], 2.0), "out of range"),
    (lambda m, z: m.scale_girth(z, [-1], 2.0), "out of range"),
    (lambda m, z: m.style_transfer_z(z, z, ["wing"]), "unknown part"),
    (lambda m, z: m.scale_bone_length(z, [N_BONES], 1.2), "bone index"),
    (lambda m, z: m.transplant_orientation(z, z, [-1]), "bone index"),
])
def test_edit_ops_raise_as_jax(call, match):
    """The same ValueErrors, with the same messages, as the JAX ops."""
    z = np.ones((1, N_BONES, 4), np.float32)
    with pytest.raises(ValueError, match=match) as want:
        call(JE, jnp.asarray(z))
    with pytest.raises(ValueError, match=match) as got:
        call(TE, torch.from_numpy(z))
    assert str(got.value) == str(want.value)


# --- skeleton and measures against JAX ---------------------------------------

@pytest.mark.parametrize("kps_index, length", [
    (4, 1.2), (16, np.asarray([0.8, 1.5], np.float32)), (12, 1.0)])
def test_edit_skl_matches_jax(kps_index, length):
    (kps,) = _rng_arrays(2, (2, 35, 3))
    got = TK.edit_skl(torch.from_numpy(kps), kps_index, length)
    want = JK.edit_skl(jnp.asarray(kps), kps_index, length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("skl_list", [SKL_LIST, MEASURE_SKL_LIST,
                                      NEWSKL_LIST])
def test_bone_lengths_match_jax(skl_list):
    (kps,) = _rng_arrays(3, (3, 35, 3))
    got = TK.bone_lengths(torch.from_numpy(kps), skl_list)
    want = JK.bone_lengths(jnp.asarray(kps), skl_list)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_angle_weights_match_jax_with_the_nan_guard(small_human):
    """Per-part angles equal JAX's; a coincident vertex pair (0/0 -> NaN)
    maps to angle 0 on both sides."""
    verts = small_human.sample_meshes(2, seed=3).astype(np.float32)
    parts = [np.asarray(v) for v in small_human.part_dict.values()][:4]
    a, b = parts[1][0], parts[1][1]
    verts[:, b] = verts[:, a]                    # a coincident pair
    kps = np.einsum("jv,bvd->bjd", small_human.J_regressor.astype(np.float32),
                    verts)
    got = TK.angle_weights(torch.from_numpy(verts), torch.from_numpy(kps),
                           parts, SKL_LIST)
    want = JK.angle_weights(jnp.asarray(verts), jnp.asarray(kps), parts,
                            SKL_LIST)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert float(got[1][0, 0, 1]) == 0.0 == float(np.asarray(want[1])[0, 0, 1])


def test_girth_tables_and_measures_match_jax(small_human):
    idx, fac, mask = TM.pack_girth_tables(small_human.girth_edges,
                                          small_human.girth_factors)
    for got, want in zip((idx, fac, mask), JM.pack_girth_tables(
            small_human.girth_edges, small_human.girth_factors)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    verts = small_human.sample_meshes(3, seed=5).astype(np.float32)
    jr = small_human.J_regressor.astype(np.float32)
    got = TM.measure_body(torch.from_numpy(verts), torch.from_numpy(jr),
                          torch.from_numpy(idx), torch.from_numpy(fac),
                          MEASURE_SKL_LIST)
    want = JM.measure_body(jnp.asarray(verts), jnp.asarray(jr), idx, fac,
                           MEASURE_SKL_LIST)
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_padded_girth_segments_have_length_zero():
    """A short polyline's pads repeat its last point: its girth is the
    closed polyline's length alone."""
    edges = [np.asarray([[0, 1], [1, 2], [2, 3]]), np.asarray([[0, 2]])]
    factors = [np.full((3, 1), 0.25), np.zeros((1, 1))]
    idx, fac, mask = TM.pack_girth_tables(edges, factors)
    assert idx.shape == (2, 3, 2) and mask[1].tolist() == [1.0, 0.0, 0.0]
    verts = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]])
    g = TM.girths(verts, torch.from_numpy(idx), torch.from_numpy(fac))
    pts = np.asarray([[0.25, 0], [1, 0.25], [0.75, 1]])
    ring = np.r_[pts, pts[:1]]
    np.testing.assert_allclose(
        float(g[0, 0]), np.linalg.norm(np.diff(ring, axis=0), axis=1).sum(),
        rtol=1e-6)
    assert float(g[0, 1]) == 0.0


# --- the Editor against the JAX Editor ---------------------------------------

EDITOR_CALLS = {
    "reconstruct": lambda e, m: e.reconstruct(m),
    "orientation": lambda e, m: e.edit_orientation(
        m, np.roll(m, 1, axis=0), [14, 15, 16, 17]),
    "bone_length": lambda e, m: e.edit_bone_length(m, [14, 15, 16, 17], 1.2),
    "girth": lambda e, m: e.edit_girth(m, ["chest", "abdomen", "hip"], 1.2),
    "style": lambda e, m: e.style_transfer(m, np.roll(m, 1, axis=0)),
    "style_parts": lambda e, m: e.style_transfer(m, np.roll(m, 2, axis=0),
                                                 ["chest", "abdomen"]),
    "interpolate": lambda e, m: e.interpolate(m[:2], np.roll(m, 1, 0)[:2],
                                              [0.0, 0.5, 1.0]),
    "measure": lambda e, m: e.measure(m),
    "decode_zero_dummy": lambda e, m: e.decode(
        np.asarray(e.encode(m)["z"]), np.asarray(e.encode(m)["z_kps"])),
}


@pytest.mark.parametrize("call", sorted(EDITOR_CALLS))
def test_editor_matches_jax(editors, meshes, call):
    """Every public computation of the Editor equals the JAX Editor's on the
    same parameters and meshes (rtol = atol = 1e-4)."""
    te, je = editors
    got = EDITOR_CALLS[call](te, meshes)
    want = EDITOR_CALLS[call](je, meshes)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    _close(got, want, 1e-4)


def test_editor_encode_matches_jax(editors, meshes):
    te, je = editors
    got, want = te.encode(meshes), je.encode(meshes)
    assert set(got) == set(want) == {"z", "z_kps", "dummy", "kps_full"}
    for k in got:
        assert isinstance(got[k], torch.Tensor)
        _close(got[k].numpy(), want[k], 1e-4)
    assert torch.count_nonzero(got["dummy"]) == 0


def test_identity_girth_edit_is_reconstruction_bit_for_bit(editor, meshes):
    """x1.0 on every part, decoded with a zero dummy, gives reconstruct's
    bits: the encoder's dummy row is exactly zero."""
    rec = editor.reconstruct(meshes)
    assert np.array_equal(editor.edit_girth(meshes, PART_LIST, 1.0), rec)


def test_run_demo_writes_the_jax_files(editors, meshes, tmp_path):
    """The same five files as the JAX run_demo, vertices within 1e-4 (the
    skeleton strips included), the same faces."""
    te, je = editors
    got = run_demo(te, meshes, str(tmp_path / "torch"))
    want = jax_run_demo(je, meshes, str(tmp_path / "jax"))
    assert set(got) == set(want)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names and len(names) == 5
    for name in names:
        vg, fg = load_obj(str(tmp_path / "torch" / name))
        vw, fw = load_obj(str(tmp_path / "jax" / name))
        np.testing.assert_allclose(vg, vw, atol=1e-4)
        assert np.array_equal(fg, fw)
    for k in got:
        _close(got[k], want[k], 1e-4)


def test_editor_defaults_to_the_card(editor):
    """Editor(device=...) defaults to "cuda" and never falls back to the
    CPU; from_trainer takes the trainer's device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Editor(editor.model, editor.params, editor.assets)
    trainer = SimpleNamespace(model=editor.model, params=editor.params,
                              assets=editor.assets,
                              device=torch.device("cpu"))
    assert Editor.from_trainer(trainer).device == torch.device("cpu")


def test_editor_ops_leave_the_latents_untouched(editor, meshes):
    lat = editor.encode(meshes)
    z = lat["z"].clone()
    TE.scale_girth(lat["z"], ["chest"], 3.0)
    TE.style_transfer_z(lat["z"], lat["z"].flip(0), ["hip"])
    assert torch.equal(lat["z"], z)


# --- counterparts of tests/test_edit.py --------------------------------------

def test_scale_girth_touches_only_chosen_parts():
    out = TE.scale_girth(torch.ones((2, 17, 8)), ["chest", "hip"], 2.0)
    chest, hip = PART_LIST.index("chest"), PART_LIST.index("hip")
    for p in range(17):
        expected = 2.0 if p in (chest, hip) else 1.0
        np.testing.assert_allclose(out[:, p].numpy(), expected)


def test_transplant_orientation_swaps_dirs_keeps_lengths():
    skl, donor = (torch.from_numpy(a) for a in _rng_arrays(
        0, (2, N_BONES, 4), (2, N_BONES, 4)))
    bones = [3, 5]
    out = TE.transplant_orientation(skl, donor, bones).numpy()
    np.testing.assert_allclose(out[:, bones, :3], donor.numpy()[:, bones, :3])
    np.testing.assert_allclose(out[..., 3], skl.numpy()[..., 3])
    keep = [i for i in range(N_BONES) if i not in bones]
    np.testing.assert_allclose(out[:, keep], skl.numpy()[:, keep])


def test_scale_bone_length():
    out = TE.scale_bone_length(torch.ones((1, N_BONES, 4)), [2, 4], 1.5)
    assert float(out[0, 2, 3]) == pytest.approx(1.5)
    assert float(out[0, 3, 3]) == pytest.approx(1.0)
    np.testing.assert_allclose(out[..., :3].numpy(), 1.0)  # dirs untouched


def test_style_transfer_keeps_norm_takes_direction():
    z, donor = _rng_arrays(1, (3, 17, 8), (3, 17, 8))
    out = TE.style_transfer_z(torch.from_numpy(z),
                              torch.from_numpy(donor)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1),
                               np.linalg.norm(z, axis=-1), rtol=1e-5)
    cos = np.sum(out * donor, axis=-1) / (
        np.linalg.norm(out, axis=-1) * np.linalg.norm(donor, axis=-1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)


def test_interpolate_endpoints():
    a, b = torch.zeros((1, 17, 8)), torch.ones((1, 17, 8))
    for t in (0.0, 1.0, 0.25):
        np.testing.assert_allclose(TE.interpolate_z(a, b, t).numpy(), t)


def test_editor_reconstruct_shape(editor, meshes):
    rec = editor.reconstruct(meshes)
    assert rec.shape == meshes.shape and np.all(np.isfinite(rec))


def test_editor_identity_edit_matches_reconstruction(editor, meshes):
    np.testing.assert_allclose(editor.edit_girth(meshes, ["chest"], 1.0),
                               editor.reconstruct(meshes), atol=1e-5)


def test_editor_girth_edit_changes_output(editor, meshes):
    rec = editor.reconstruct(meshes)
    edited = editor.edit_girth(meshes, ["chest", "abdomen", "hip"], 1.5)
    assert np.max(np.abs(edited - rec)) > 1e-6


def test_editor_orientation_transplant_runs(editor, meshes):
    out = editor.edit_orientation(meshes, np.roll(meshes, 1, axis=0),
                                  [14, 15])
    assert out.shape == meshes.shape and np.all(np.isfinite(out))


def test_editor_bone_length_scales_kps(editor, meshes):
    """The keypoint-space edit itself scales bone lengths exactly."""
    lat = editor.encode(meshes)
    skl = TK.kps2skl(lat["kps_full"], "ori_m")
    edited = TE.scale_bone_length(skl, [4, 7], 1.2)
    np.testing.assert_allclose(edited[:, 4, 3].numpy(),
                               skl[:, 4, 3].numpy() * 1.2, rtol=1e-6)
    out = editor.edit_bone_length(meshes, [4, 7], 1.2)
    assert out.shape == meshes.shape and np.all(np.isfinite(out))


def test_editor_interpolation_sequence(editor, meshes):
    seq = editor.interpolate(meshes[:2], np.roll(meshes[:2], 1, axis=0),
                             [0.0, 0.5, 1.0])
    assert seq.shape == (3, 2) + meshes.shape[1:]
    assert np.all(np.isfinite(seq))


def test_run_demo_exports_objs(editor, meshes, tmp_path):
    out = run_demo(editor, meshes, str(tmp_path))
    assert set(out) == {"rec", "ori", "bonelen", "girth", "style"}
    for name in out:
        path = tmp_path / f"sample0_{name}.obj"
        assert path.exists()
        v, f = load_obj(str(path))
        # mesh vertices + skeleton strip points; faces reference the mesh
        assert len(v) >= meshes.shape[1]
        assert f.max() < meshes.shape[1]


def test_editor_measure(editor, meshes):
    m = editor.measure(meshes)
    assert m.shape == (len(meshes), 32)
    assert np.all(m > 0) and np.all(np.isfinite(m))
    # girths of a uniformly scaled body scale linearly
    np.testing.assert_allclose(editor.measure(meshes * 2.0), 2.0 * m,
                               rtol=1e-5)
