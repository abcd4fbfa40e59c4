"""The port's exported bundle: `torch.export` programs with a symbolic
batch, against the live port model and the JAX package's exported
artifacts on the same inputs (counterparts of tests/test_serving.py:28-127).

tests/test_serving.py::test_sharded_batch_serving_dp8's counterpart, one
batch served over several devices, is tests/test_torch_serving_dp.py.  The
captured forward (a CUDA graph per batch) runs only on the card:
tests/test_torch_kernels_cuda.py holds its replays to the eager program.
"""

import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch import serving as TSV
from semantichuman_torch.config import ModelConfig
from semantichuman_torch.constants import KPS_KEEP
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.serving import ServingBundle, export_inference
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.serving import ServingBundle as JaxBundle
from semantichuman_tpu.serving import export_inference as jax_export

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

CFG = ModelConfig(**{k: v for k, v in SMALL_MODEL_OVERRIDES.items()
                     if k in {f.name for f in dataclasses.fields(ModelConfig)}})


@pytest.fixture(scope="module")
def hier(small_hierarchy, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_export") / "hier.npz"
    small_hierarchy.save(str(path))
    return MeshHierarchy.load(str(path))


@pytest.fixture(scope="module")
def bundle(hier, small_human, tmp_path_factory):
    model = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    params = model.init(0)
    out = str(tmp_path_factory.mktemp("torch_export_bundle"))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)   # no fixed fallback
        manifest = export_inference(model, params, small_human.J_regressor,
                                    out, batch_size=2)
    return model, params, ServingBundle(out, device="cpu"), manifest, out


@pytest.fixture(scope="module")
def jax_bundle(small_cfg, small_hierarchy, small_human, tmp_path_factory):
    model = jax_build(small_cfg, small_hierarchy, small_human.part_dict)
    out = str(tmp_path_factory.mktemp("jax_export_bundle"))
    jax_export(model, model.init(0), small_human.J_regressor, out,
               batch_size=2)
    return JaxBundle(out)


def _verts(human, b, seed):
    m = human.sample_meshes(b, seed=seed).astype(np.float32)
    return np.concatenate([m, np.zeros((b, 1, 3), np.float32)], axis=1)


def _live(model, params, human, v):
    kps = np.einsum("jv,bvd->bjd", human.J_regressor.astype(np.float32),
                    v[:, :-1])[:, KPS_KEEP]
    with torch.no_grad():
        return model(params, torch.from_numpy(v), torch.from_numpy(kps))


def test_manifest(bundle, small_human):
    """The JAX manifest's keys: a symbolic batch (batch_size null), per
    artifact its file, platforms and in_shapes; plus the payload, the trunk
    dtype and the banded_conv flag."""
    _m, _p, _b, manifest, out = bundle
    assert set(manifest["artifacts"]) == {"forward", "encode", "decode"}
    assert manifest["n_parts"] == 17 and (manifest["nz"], manifest["nk"]) \
        == (8, 8)
    assert manifest["symbolic_batch"] is True
    assert manifest["batch_size"] is None
    assert manifest["trunk_dtype"] == "float32"
    assert manifest["banded_conv"] is CFG.banded_conv is True
    v1 = len(small_human.template_verts) + 1
    assert manifest["n_vertices"] == v1 - 1
    shapes = {"forward": [["b", v1, 3]], "encode": [["b", v1, 3]],
              "decode": [["b", 17, 8], ["b", 17, 8]]}
    for name, meta in manifest["artifacts"].items():
        assert meta["file"] == f"{name}.pt2"
        assert meta["platforms"] == ["cpu"]
        assert meta["in_shapes"] == shapes[name]
        assert os.path.exists(os.path.join(out, meta["file"]))
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert os.path.exists(os.path.join(out, manifest["payload"]))


@pytest.mark.parametrize("b", [2, 3])
def test_exported_forward_matches_live_and_jax(bundle, jax_bundle,
                                               small_human, b):
    """The exported forward equals the live port model (1e-6) and the JAX
    exported forward (rtol = atol = 1e-4)."""
    model, params, served, _man, _out = bundle
    v = _verts(small_human, b, seed=b)
    got = served.forward(v)
    live = _live(model, params, small_human, v)
    jref = jax_bundle.forward(jnp.asarray(v))
    for g, ref, jr in zip(got, live, jref):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jr), rtol=1e-4,
                                   atol=1e-4)
    assert torch.count_nonzero(got[0][:, -1]) == 0


def test_exported_encode_decode_roundtrip(bundle, jax_bundle, small_human):
    """encode -> decode (zero dummy) gives forward without its dummy row;
    both equal the JAX artifacts' (1e-4)."""
    _m, _p, served, _man, _out = bundle
    v = _verts(small_human, 2, seed=4)
    z, z_kps, dummy = served.encode(v)
    assert dummy.shape == (2, 1, _m.enc_out_c)
    out = served.decode(z, z_kps)
    assert out.shape == (2, v.shape[1] - 1, 3)
    rec = served.forward(v)[0]
    np.testing.assert_allclose(out.numpy(), rec[:, :-1].numpy(), atol=1e-6)
    jz, jzk, _jd = jax_bundle.encode(jnp.asarray(v))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_bundle.decode(jz, jzk)), rtol=1e-4,
        atol=1e-4)


def test_unknown_artifact_raises(bundle):
    _m, _p, served, _man, _out = bundle
    with pytest.raises(AttributeError, match="no artifact"):
        served.nonexistent
    with pytest.raises(AttributeError, match="no artifact"):
        served.live("nonexistent")


def test_symbolic_batch_one_program_many_sizes(bundle, small_human):
    """ONE exported program serves every batch size (a torch.export Dim on
    the batch), each equal to the live model and to the payload's rebuilt
    live model."""
    model, params, served, manifest, _out = bundle
    assert manifest["artifacts"]["forward"]["in_shapes"][0][0] == "b"
    for b in (1, 3, 5):
        v = _verts(small_human, b, seed=b)
        rec, z, zk = served.forward(v)
        assert rec.shape[0] == b
        live = _live(model, params, small_human, v)
        np.testing.assert_allclose(rec.numpy(), live[0].numpy(), atol=1e-6)
        for g, ref in zip((rec, z, zk), served.live("forward", v)):
            np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-6)


def test_programs_call_the_custom_ops(bundle):
    """The conv forward and the row gather enter each program as the two
    custom ops, one node per call: 9 convs, 6 encode gathers (4 pools, the
    part and keypoint heads) and 4 unpools for the forward."""
    _m, _p, _served, manifest, out = bundle
    want = {"forward": (9, 10), "encode": (4, 6), "decode": (5, 4)}
    for name, meta in manifest["artifacts"].items():
        ep = torch.export.load(os.path.join(out, meta["file"]))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        got = (sum("semantichuman.spiral_conv_fwd" in t for t in targets),
               sum("semantichuman.gather_rows" in t for t in targets))
        assert got == want[name], name


def test_fixed_batch_flag(hier, small_human, tmp_path):
    """symbolic_batch=False writes fixed-shape programs, recorded in the
    manifest; they refuse another batch."""
    model = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    out = str(tmp_path / "fixed")
    manifest = export_inference(model, model.init(0),
                                small_human.J_regressor, out, batch_size=2,
                                symbolic_batch=False)
    assert manifest["symbolic_batch"] is False
    assert manifest["batch_size"] == 2
    assert manifest["artifacts"]["forward"]["in_shapes"][0][0] == 2
    served = ServingBundle(out, device="cpu")
    assert served.forward(_verts(small_human, 2, seed=1))[0].shape[0] == 2
    with pytest.raises(Exception):
        served.forward(_verts(small_human, 3, seed=1))


def test_failed_symbolic_export_falls_back_with_a_warning(
        hier, small_human, tmp_path, monkeypatch):
    """Where the symbolic trace fails, the export warns and writes the
    fixed batch, as the JAX export does."""
    model = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    export_all = TSV._export_all

    def no_symbolic(model, params, jreg, b, symbolic):
        if symbolic:
            raise RuntimeError("a guard on the batch")
        return export_all(model, params, jreg, b, symbolic)

    monkeypatch.setattr(TSV, "_export_all", no_symbolic)
    with pytest.warns(UserWarning, match="falling back to fixed batch 3"):
        manifest = export_inference(model, model.init(0),
                                    small_human.J_regressor,
                                    str(tmp_path / "fb"), batch_size=3)
    assert manifest["symbolic_batch"] is False
    assert manifest["batch_size"] == 3
    assert manifest["artifacts"]["decode"]["in_shapes"] == [[3, 17, 8],
                                                            [3, 17, 8]]


def test_bf16_trunk_export(hier, small_human, tmp_path):
    """A bf16-trunk bundle exports from the same f32 params (the cast is
    traced into the program), records its dtype, returns f32 and stays
    within bf16 rounding of the f32 bundle; its program equals its own
    live model."""
    m32 = torch_build(CFG, hier, small_human.part_dict, device="cpu")
    m16 = torch_build(dataclasses.replace(CFG, trunk_dtype="bfloat16"), hier,
                      small_human.part_dict, device="cpu")
    params = m32.init(0)
    man32 = export_inference(m32, params, small_human.J_regressor,
                             str(tmp_path / "f32"))
    man16 = export_inference(m16, params, small_human.J_regressor,
                             str(tmp_path / "bf16"))
    assert man32["trunk_dtype"] == "float32"
    assert man16["trunk_dtype"] == "bfloat16" and man16["symbolic_batch"]
    v = _verts(small_human, 2, seed=4)
    r32 = ServingBundle(str(tmp_path / "f32"), device="cpu").forward(v)[0]
    b16 = ServingBundle(str(tmp_path / "bf16"), device="cpu")
    r16 = b16.forward(v)[0]
    assert r16.dtype == torch.float32 and torch.isfinite(r16).all()
    scale = max(1e-3, float(r32.abs().max()))
    assert float((r16 - r32).abs().max()) < 0.05 * scale
    np.testing.assert_allclose(r16.numpy(), b16.live("forward", v)[0].numpy(),
                               atol=1e-6)


def test_a_cpu_bundle_refuses_the_card(bundle, monkeypatch):
    """The programs' constants live on the device they were exported on: a
    bundle exported on the CPU raises its platform error for
    device="cuda", before it loads anything."""
    _m, _p, _served, _man, out = bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"exported on \['cpu'\].*'cuda'"):
        ServingBundle(out, device="cuda")


def test_default_device_is_cuda(bundle):
    """ServingBundle defaults to the card and never falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    _m, _p, _served, _man, out = bundle
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingBundle(out)


def test_cpu_serves_the_program_eagerly(bundle, small_human):
    """No graph on the CPU: call() runs the program, and graph capture is
    the card's (graph=False and the default give the same bits)."""
    _m, _p, served, _man, _out = bundle
    v = _verts(small_human, 1, seed=2)
    a = served.call("forward", v)
    b = served.call("forward", v, graph=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert served._captured == {}
    assert 1 <= TSV._GRAPH_MAX_B
