"""Port models against the JAX package: synthetic assets, the loaded
hierarchy, PartAE init, and forward/encode/decode from the same params."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.config import ModelConfig
from semantichuman_torch.constants import KPS_KEEP
from semantichuman_torch.data.synthetic import SyntheticHuman as TorchHuman
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.topology import MeshHierarchy as TorchHier
from semantichuman_torch.utils.params import params_from_jax, params_to_numpy
from semantichuman_tpu.config import Config
from semantichuman_tpu.data.synthetic import SyntheticHuman as JaxHuman
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.topology.compiler import MeshHierarchy as JaxHier

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

FULL_TOPOLOGY = str(Path(__file__).resolve().parents[1]
                    / "assets" / "topology_synth_full_2222.npz")
# f32 sums in another order through 9 conv layers and the heads
RTOL = ATOL = 1e-4


def _torch_cfg(overrides=None, **kw):
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw.update({k: v for k, v in (overrides or {}).items() if k in fields})
    return ModelConfig(**kw)


def _jax_cfg(overrides=None, **kw):
    model = dict(overrides or {}, banded_conv=False, **kw)
    return Config.from_dict({"model": model})


@pytest.mark.parametrize("size", [(16, 36), (None, None)])
def test_synthetic_human_equals_jax(size):
    t, j = TorchHuman(*size), JaxHuman(*size)
    np.testing.assert_array_equal(t.template_verts, j.template_verts)
    np.testing.assert_array_equal(t.template_faces, j.template_faces)
    np.testing.assert_array_equal(t.J_regressor, j.J_regressor)
    assert list(t.part_dict) == list(j.part_dict)
    for k in j.part_dict:
        np.testing.assert_array_equal(t.part_dict[k], j.part_dict[k])
    np.testing.assert_array_equal(t.sample_meshes(3, seed=7),
                                  j.sample_meshes(3, seed=7))


def test_bundled_hierarchy_loads_like_jax():
    t, j = TorchHier.load(FULL_TOPOLOGY), JaxHier.load(FULL_TOPOLOGY)
    assert t.sizes == j.sizes == [6892, 3446, 1723, 862, 431]
    assert t.spiral_sizes == [15, 11, 8, 8, 9]
    for name in ("spirals", "pool_idx", "unpool_idx", "unpool_w"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_array_equal(a, b)
    parts = JaxHuman().part_dict
    tp, jp = t.downsample_part_indices(parts), j.downsample_part_indices(parts)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])


@pytest.fixture(scope="module")
def small_pair(small_hierarchy, small_human, tmp_path_factory):
    """(JAX model, JAX params as numpy, port model, JAX human) at the small
    test size, on one hierarchy saved by the JAX compiler."""
    path = tmp_path_factory.mktemp("torch_models") / "hier.npz"
    small_hierarchy.save(str(path))
    jm = jax_build(_jax_cfg(SMALL_MODEL_OVERRIDES), small_hierarchy,
                   small_human.part_dict)
    tm = torch_build(_torch_cfg(SMALL_MODEL_OVERRIDES),
                     TorchHier.load(str(path)), small_human.part_dict,
                     device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(0))
    return jm, jp, tm, small_human


def test_init_equals_jax(small_pair):
    """PartAE.init(0) gives the JAX package's arrays exactly."""
    _jm, jp, tm, _h = small_pair
    tp = params_to_numpy(tm.init(0))
    jl, jtree = jax.tree.flatten(jp)
    tl, ttree = jax.tree.flatten(tp)
    assert ttree == jtree
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_params_roundtrip(small_pair):
    _jm, jp, _tm, _h = small_pair
    back = params_to_numpy(params_from_jax(jp, "cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def _inputs(human, b, seed, model_c, n_parts=17):
    m = human.sample_meshes(b, seed=seed).astype(np.float32)
    verts = np.concatenate([m, np.zeros((b, 1, 3), np.float32)], axis=1)
    kps = np.einsum("jv,bvd->bjd", human.J_regressor.astype(np.float32),
                    verts[:, :-1])[:, KPS_KEEP]
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((b, n_parts, 8)).astype(np.float32)
    zk = rng.standard_normal((b, n_parts, 8)).astype(np.float32)
    dummy = rng.standard_normal((b, 1, model_c)).astype(np.float32)
    return verts, kps, z, zk, dummy


def _check_parity(jm, jp, tm, human, b, seed, fns, rtol=RTOL, atol=ATOL):
    tp = params_from_jax(jp, "cpu")
    jpj = jax.tree.map(jnp.asarray, jp)
    verts, kps, z, zk, dummy = _inputs(human, b, seed, jm.dec_in_c)
    calls = {
        "forward": (lambda m, p, a: m(p, *a), (verts, kps)),
        "encode": (lambda m, p, a: m.encode(p, *a), (verts, kps)),
        "decode": (lambda m, p, a: m.decode(p, *a), (z, zk, dummy)),
    }
    for name in fns:
        fn, args = calls[name]
        ref = fn(jm, jpj, [jnp.asarray(a) for a in args])
        with torch.no_grad():
            got = fn(tm, tp, [torch.from_numpy(a) for a in args])
        if name == "decode":
            ref, got = (ref,), (got,)
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=rtol, atol=atol, err_msg=name)
        if name != "encode":
            assert torch.count_nonzero(got[0][:, -1]) == 0


@pytest.mark.parametrize("fn", ["forward", "encode", "decode"])
def test_part_ae_matches_jax_small(small_pair, fn):
    jm, jp, tm, human = small_pair
    _check_parity(jm, jp, tm, human, b=3, seed=5, fns=[fn])


def test_part_ae_bf16_trunk_matches_jax_small(small_pair, small_hierarchy,
                                              tmp_path):
    """bf16 trunk: both sides cast x and W to bf16 before each conv; an f32
    value on a bf16 rounding edge may round one ulp apart (2^-8 relative),
    so the tolerance is bf16's, not f32's."""
    _jm, jp, _tm, human = small_pair
    path = tmp_path / "hier.npz"
    small_hierarchy.save(str(path))
    jm16 = jax_build(_jax_cfg(SMALL_MODEL_OVERRIDES, trunk_dtype="bfloat16"),
                     small_hierarchy, human.part_dict)
    tm16 = torch_build(_torch_cfg(SMALL_MODEL_OVERRIDES,
                                  trunk_dtype="bfloat16"),
                       TorchHier.load(str(path)), human.part_dict,
                       device="cpu")
    _check_parity(jm16, jp, tm16, human, b=2, seed=6, fns=["forward"],
                  rtol=1e-2, atol=1e-2)


def test_part_ae_matches_jax_full_width():
    """The default ModelConfig on the bundled 6892-vertex topology, B=2."""
    human = JaxHuman()
    jh = JaxHier.load(FULL_TOPOLOGY)
    jm = jax_build(_jax_cfg(), jh, human.part_dict)
    tm = torch_build(ModelConfig(), TorchHier.load(FULL_TOPOLOGY),
                     human.part_dict, device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(0))
    _check_parity(jm, jp, tm, human, b=2, seed=8,
                  fns=["forward", "encode", "decode"])


@pytest.mark.parametrize("mode", ["ori_m", "kps_ori_m", "vec_m", "vec", "m"])
def test_part_ae_kps2skl_matches_jax(small_pair, mode):
    """PartAE.kps2skl (a static method, callable on the class and on a
    model) against the JAX PartAE.kps2skl on the same seeded keypoints,
    32 kept and 35 full, at atol 1e-6."""
    jm, _jp, tm, _human = small_pair
    rng = np.random.default_rng(11)
    for n in (len(KPS_KEEP), 35):
        kps = rng.standard_normal((3, n, 3)).astype(np.float32)
        want = np.asarray(jm.kps2skl(jnp.asarray(kps), mode))
        for fn in (type(tm).kps2skl, tm.kps2skl):
            got = fn(torch.from_numpy(kps), mode)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_part_ae_kps2skl_rejects_an_unknown_mode(small_pair):
    _jm, _jp, tm, _human = small_pair
    with pytest.raises(ValueError, match="unknown skl mode"):
        tm.kps2skl(torch.zeros((1, len(KPS_KEEP), 3)), "quaternion")
