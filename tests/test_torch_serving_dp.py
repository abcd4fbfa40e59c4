"""Serving one batch over several devices from one exported bundle: the
counterpart of tests/test_serving.py::test_sharded_batch_serving_dp8.

The JAX test serves one symbolic-batch artifact on an input sharded over
an 8-device mesh in one process.  The port loads one copy of each program
per listed device (`ServingBundle(dir, device=[...])`, moved from the same
`.pt2` files, never exported again), splits the batch into contiguous
equal shards in device order and keeps each shard's outputs on its copy's
device.  Here the devices are CPU devices listed several times; the
copies on two cards are held by tests/test_torch_kernels_cuda.py."""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from semantichuman_torch import serving as TSV
from semantichuman_torch.config import ModelConfig
from semantichuman_torch.models import build_model as torch_build
from semantichuman_torch.serving import Shards, ServingBundle
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_torch.utils.params import params_from_jax
from semantichuman_tpu.models import build_model as jax_build
from semantichuman_tpu.serving import ServingBundle as JaxBundle
from semantichuman_tpu.serving import export_inference as jax_export

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

CFG = ModelConfig(**{k: v for k, v in SMALL_MODEL_OVERRIDES.items()
                     if k in {f.name for f in dataclasses.fields(ModelConfig)}})
B = 8


@pytest.fixture(scope="module")
def bundles(small_cfg, small_hierarchy, small_human, tmp_path_factory):
    """(port bundle dir, one-device port bundle, JAX bundle): both export
    the JAX model's init(0) parameters (the port's through
    params_from_jax)."""
    jmodel = jax_build(small_cfg, small_hierarchy, small_human.part_dict)
    jparams = jmodel.init(0)
    jdir = str(tmp_path_factory.mktemp("jax_dp_bundle"))
    jax_export(jmodel, jparams, small_human.J_regressor, jdir, batch_size=2)
    path = tmp_path_factory.mktemp("dp_hier") / "hier.npz"
    small_hierarchy.save(str(path))
    model = torch_build(CFG, MeshHierarchy.load(str(path)),
                        small_human.part_dict, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    out = str(tmp_path_factory.mktemp("torch_dp_bundle"))
    manifest = TSV.export_inference(model, params, small_human.J_regressor,
                                    out, batch_size=2)
    assert manifest["symbolic_batch"] is True
    return out, ServingBundle(out, device="cpu"), JaxBundle(jdir)


@pytest.fixture(scope="module")
def verts(small_human):
    m = small_human.sample_meshes(B, seed=13).astype(np.float32)
    return np.concatenate([m, np.zeros((B, 1, 3), np.float32)], axis=1)


def _close(got, ref, **tol):
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), **tol)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_batch_matches_one_device_and_jax(bundles, verts, n,
                                                  monkeypatch):
    """Over n copies: forward, encode and decode equal the one-device
    bundle (rtol 2e-6, atol 2e-7, the JAX test's tolerance), each shard
    B/n rows on its copy's device; the forward equals the JAX bundle's on
    the same batch sharded over jax.devices()[:8] (rtol = atol = 1e-4),
    whose output stays batch-sharded.  The copies come from the .pt2
    files: an export while loading raises."""
    out, one, jbundle = bundles

    def no_export(*a, **k):
        raise AssertionError("a copy exported the model again")

    monkeypatch.setattr(TSV, "export_inference", no_export)
    monkeypatch.setattr(TSV, "_export_all", no_export)
    dp = ServingBundle(out, device=["cpu"] * n)
    assert dp.devices == [torch.device("cpu")] * n
    assert len({id(c.programs["forward"]) for c in dp._copies}) == n

    got = dp.forward(verts)
    assert isinstance(got, Shards) and len(got) == n
    for shard, copy in zip(got, dp._copies):
        assert all(t.shape[0] == B // n and t.device == copy.device
                   for t in shard)
    ref = one.forward(verts)
    _close(got.gather(), ref, rtol=2e-6, atol=2e-7)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    jv = jax.device_put(verts, NamedSharding(mesh, PartitionSpec("dp")))
    jgot = jbundle.forward(jv)
    assert "dp" in str(jgot[0].sharding.spec)
    _close(got.gather(), jgot, rtol=1e-4, atol=1e-4)

    z, z_kps, dummy = one.encode(verts)
    _close(dp.encode(verts).gather(), (z, z_kps, dummy), rtol=2e-6,
           atol=2e-7)
    dec = dp.decode(z, z_kps)
    assert [t.shape[0] for t in dec] == [B // n] * n
    _close(dec.gather(), one.decode(z, z_kps), rtol=2e-6, atol=2e-7)


def test_a_batch_the_devices_do_not_divide_raises(bundles, verts):
    """6 meshes over 4 devices: a ValueError naming both numbers, as JAX's
    NamedSharding refuses an uneven batch."""
    out, _one, _j = bundles
    dp = ServingBundle(out, device=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"batch of 6 .* over 4 devices"):
        dp.forward(verts[:6])


def test_one_device_in_a_list_serves_as_one(bundles, verts):
    """device=["cpu"] returns the outputs themselves, bit for bit those
    of device="cpu"."""
    out, one, _j = bundles
    got = ServingBundle(out, device=["cpu"]).forward(verts)
    assert isinstance(got, tuple) and not isinstance(got, Shards)
    assert all(torch.equal(g, r) for g, r in zip(got, one.forward(verts)))


def test_a_moved_program_holds_nothing_off_its_device(bundles):
    """load_program moves a program whose tensors are elsewhere (here
    from the CPU to the meta device): every state tensor, constant and
    traced value then names the new device, and the program as saved has
    them all on the CPU."""
    out, _one, _j = bundles
    for name in ("forward", "encode", "decode"):
        path = os.path.join(out, f"{name}.pt2")
        saved = torch.export.load(path)
        assert TSV.off_device(saved, "cpu") == []
        assert len(TSV.off_device(saved, "meta")) > len(saved.state_dict)
        moved = TSV.load_program(path, "meta")
        assert TSV.off_device(moved, "meta") == []
        assert {t.device.type for t in moved.state_dict.values()} == {"meta"}
        assert {t.device.type for t in moved.constants.values()} == {"meta"}


def test_manifest_records_the_export_device_and_old_ones_load(bundles,
                                                              verts,
                                                              tmp_path):
    """The manifest names the export device as torch prints it ("cpu";
    on a card "cuda:0"); a manifest of an older export, which names the
    device type alone ("cuda" for a card), loads and serves as before."""
    out, one, _j = bundles
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert {m["platforms"][0] for m in manifest["artifacts"].values()} \
        == {"cpu"}
    old = tmp_path / "old"
    shutil.copytree(out, old)
    for meta in manifest["artifacts"].values():
        meta["platforms"] = [torch.device(meta["platforms"][0]).type]
    (old / "manifest.json").write_text(json.dumps(manifest))
    ref = one.forward(verts)
    got = ServingBundle(str(old), device="cpu").forward(verts)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    got = ServingBundle(str(old), device=["cpu", "cpu"]).forward(verts)
    _close(got.gather(), ref, rtol=2e-6, atol=2e-7)
