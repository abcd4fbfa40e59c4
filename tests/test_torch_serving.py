"""Port serving bundle: export -> load -> call must match the live port
model and the JAX model (mirrors tests/test_serving.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.config import ModelConfig
from semantichuman_torch.constants import KPS_KEEP
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.serving import ServingBundle, export_inference
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_torch.utils.params import params_from_jax
from semantichuman_tpu.models import build_model as jax_build

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

CFG = ModelConfig(**{k: v for k, v in SMALL_MODEL_OVERRIDES.items()
                     if k in {f.name for f in dataclasses.fields(ModelConfig)}})


@pytest.fixture(scope="module")
def hier(small_hierarchy, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_serving") / "hier.npz"
    small_hierarchy.save(str(path))
    return MeshHierarchy.load(str(path))


@pytest.fixture(scope="module")
def jax_model(small_cfg, small_hierarchy, small_human):
    return jax_build(small_cfg, small_hierarchy, small_human.part_dict)


@pytest.fixture(scope="module")
def bundle(hier, small_human, tmp_path_factory):
    model = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    params = model.init(0)
    out = str(tmp_path_factory.mktemp("torch_bundle"))
    manifest = export_inference(model, params, small_human.J_regressor, out)
    return model, params, ServingBundle(out, device="cpu"), manifest, out


def _verts(human, b, seed):
    m = human.sample_meshes(b, seed=seed).astype(np.float32)
    return np.concatenate([m, np.zeros((b, 1, 3), np.float32)], axis=1)


def _kps(human, verts):
    return np.einsum("jv,bvd->bjd", human.J_regressor.astype(np.float32),
                     verts[:, :-1])[:, KPS_KEEP]


def test_manifest(bundle, small_human):
    _m, _p, _b, manifest, _out = bundle
    assert set(manifest["artifacts"]) == {"forward", "encode", "decode"}
    assert manifest["n_parts"] == 17
    assert manifest["n_vertices"] == len(small_human.template_verts)
    assert (manifest["nz"], manifest["nk"]) == (8, 8)
    assert manifest["trunk_dtype"] == "float32"
    assert manifest["artifacts"]["forward"]["in_shapes"][0][0] == "b"


@pytest.mark.parametrize("b", [1, 2, 5])
def test_forward_matches_live_and_jax(bundle, jax_model, small_human, b):
    """Any batch size: the bundle equals the live port model exactly and
    the JAX model to f32 summation order (1e-4)."""
    model, params, served, _man, _out = bundle
    v = _verts(small_human, b, seed=b)
    k = _kps(small_human, v)
    rec, z, zk = served.forward(v)
    with torch.no_grad():
        live = model(params, torch.from_numpy(v), torch.from_numpy(k))
    for got, ref in zip((rec, z, zk), live):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    jref = jax_model(jax_model.init(0), jnp.asarray(v), jnp.asarray(k))
    for got, ref in zip((rec, z, zk), jref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
    assert rec.shape == (b, v.shape[1], 3)
    assert torch.count_nonzero(rec[:, -1]) == 0


def test_encode_decode_roundtrip(bundle, small_human):
    _m, _p, served, _man, _out = bundle
    v = _verts(small_human, 2, seed=4)
    z, z_kps, dummy = served.encode(v)
    assert dummy.shape == (2, 1, _m.enc_out_c)
    out = served.decode(z, z_kps)
    assert out.shape == (2, v.shape[1] - 1, 3)
    rec = served.forward(v)[0]
    assert torch.isfinite(out).all() and torch.isfinite(rec).all()


def test_unknown_artifact_raises(bundle):
    _m, _p, served, _man, _out = bundle
    with pytest.raises(AttributeError, match="no artifact"):
        served.nonexistent


def test_bundle_from_jax_params(jax_model, hier, small_human, tmp_path):
    """A JAX-trained parameter tree moved across with params_from_jax serves
    the JAX model's reconstruction."""
    jm = jax_model
    jp = jm.init(3)
    tm = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    export_inference(tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                     small_human.J_regressor, str(tmp_path))
    v = _verts(small_human, 2, seed=9)
    rec = ServingBundle(str(tmp_path), device="cpu").forward(v)[0]
    ref = jm(jp, jnp.asarray(v), jnp.asarray(_kps(small_human, v)))[0]
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_bf16_trunk_bundle(hier, small_human, tmp_path):
    """A bf16-trunk bundle records its dtype, exports from the same f32
    params, returns f32 and stays within bf16 rounding of the f32 bundle."""
    m32 = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    m16 = torch_build(dataclasses.replace(CFG, trunk_dtype="bfloat16"), hier,
                      small_human.part_dict, device="cpu")
    params = m32.init(0)
    man32 = export_inference(m32, params, small_human.J_regressor,
                             str(tmp_path / "f32"))
    man16 = export_inference(m16, params, small_human.J_regressor,
                             str(tmp_path / "bf16"))
    assert man32["trunk_dtype"] == "float32"
    assert man16["trunk_dtype"] == "bfloat16"
    v = _verts(small_human, 2, seed=4)
    r32 = ServingBundle(str(tmp_path / "f32"), device="cpu").forward(v)[0]
    r16 = ServingBundle(str(tmp_path / "bf16"), device="cpu").forward(v)[0]
    assert r16.dtype == torch.float32 and torch.isfinite(r16).all()
    scale = max(1e-3, float(r32.abs().max()))
    assert float((r16 - r32).abs().max()) < 0.05 * scale


def test_default_device_is_cuda(bundle):
    """Entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    _m, _p, _served, _man, out = bundle
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingBundle(out)
