"""The port's band specs and banded routes against the JAX package: the
spec builders field for field, the banded spiral conv and unpool against
`spiral_conv_banded_pallas` / `unpool_banded_pallas` (Pallas interpret
mode) and the take forms, values and gradients, and the dispatch gates."""

import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.models import tables as TT
from semantichuman_torch.ops import banding as TB
from semantichuman_torch.ops import banded_gather as BG
from semantichuman_torch.ops import row_gather as RG
from semantichuman_torch.ops import sampling as TS
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_tpu.ops import banding as JB
from semantichuman_tpu.ops import sampling as JS
from semantichuman_tpu.ops.pallas import banded_gather_pallas as bgp

TC = importlib.import_module("semantichuman_torch.ops.spiral_conv")
JC = importlib.import_module("semantichuman_tpu.ops.spiral_conv")

torch.set_num_threads(1)

FULL_TOPOLOGY = str(Path(__file__).resolve().parents[1] / "assets"
                    / "topology_synth_full_2222.npz")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(bgp, "_INTERPRET", True)


def _local_table(rng, v1, s, spread=40, dummy_frac=0.2, far_frac=0.05):
    base = np.arange(v1)[:, None]
    sp = np.clip(base + rng.integers(-spread, spread, (v1, s)), 0, v1 - 1)
    sp[rng.random((v1, s)) < dummy_frac] = v1 - 1
    far = rng.random((v1, s)) < far_frac
    sp[far] = rng.integers(0, v1, far.sum())
    sp[-1] = v1 - 1
    return sp.astype(np.int32)


def _assert_same_spec(got, want):
    """Every field of a BandSpec (and its DiagBandSpec) equal."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "diag":
            assert (a is None) == (b is None)
            if b is not None:
                _assert_same_spec(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("v1,s,R,W,seed", [(517, 9, 64, 128, 3),
                                           (1201, 5, 128, 384, 4),
                                           (333, 7, 64, 192, 5)])
def test_spec_builders_equal_jax(v1, s, R, W, seed):
    sp = _local_table(np.random.default_rng(seed), v1, s)
    _assert_same_spec(TB.build_band_spec(sp, R, W), JB.build_band_spec(sp, R,
                                                                        W))
    _assert_same_spec(TB.build_diag_spec(sp, R, W // R + 1),
                      JB.build_diag_spec(sp, R, W // R + 1))
    _assert_same_spec(TB.pick_band_spec(sp, presets=((R, W),), max_oob=1.0),
                      JB.pick_band_spec(sp, presets=((R, W),), max_oob=1.0))


@pytest.fixture(scope="module")
def full_hier():
    return MeshHierarchy.load(FULL_TOPOLOGY)


# (kind, index, fix-ups) of the bundled topology's band tables
FULL_TABLES = [("conv", 0, 2368), ("conv", 1, 904), ("unpool", 0, 208),
               ("unpool", 1, 128), ("unpool", 2, 88), ("unpool", 3, 0)]


@pytest.mark.parametrize("kind,l,n_fix", FULL_TABLES,
                         ids=[f"{k}{l}" for k, l, _ in FULL_TABLES])
def test_full_topology_specs_equal_jax(full_hier, kind, l, n_fix):
    """The production presets on the bundled 6892-vertex topology: the same
    spec in both packages, and the band the kernels read at full width."""
    if kind == "conv":
        table, kw = full_hier.spirals[l], {}
    else:
        table = full_hier.unpool_idx[l]
        kw = dict(presets=TB.UNPOOL_BAND_PRESETS,
                  dummy=full_hier.sizes[l + 1])
    got = TB.pick_band_spec(table, **kw)
    want = JB.pick_band_spec(table, **kw)
    _assert_same_spec(got, want)
    assert len(got.diag.fix_pos) == n_fix          # padded to a multiple of 8


def test_pick_band_spec_raises_instead_of_swallowing(monkeypatch):
    """A failing companion build raises (the JAX package swallows it and
    keeps its XLA band, which the port does not have)."""
    sp = _local_table(np.random.default_rng(6), 300, 5)

    def broken(*a, **k):
        raise RuntimeError("spec build failure")

    monkeypatch.setattr(TB, "build_diag_spec", broken)
    with pytest.raises(RuntimeError, match="spec build failure"):
        TB.pick_band_spec(sp, presets=((64, 192),), max_oob=1.0)
    rng = np.random.default_rng(7)
    assert TB.pick_band_spec(rng.integers(0, 4096, (4096, 9))) is None


def _band(tbl, dummy, weights=None):
    jband = JB.pick_band_spec(tbl, presets=((64, 192),), max_oob=1.0,
                              dummy=dummy)
    tband = TB.pick_band_spec(tbl, presets=((64, 192),), max_oob=1.0,
                              dummy=dummy)
    return jband, BG.BandTable.build(tband, "cpu", weights)


def _conv_case(seed=4, v1=600, s=9, c_in=8, c_out=16, b=3):
    rng = np.random.default_rng(seed)
    tbl = _local_table(rng, v1, s, spread=80)
    x = rng.normal(size=(b, v1, c_in)).astype(np.float32)
    x[:, -1] = 0.0
    w = (rng.normal(size=(s * c_in, c_out)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    ct = (rng.normal(size=(b, v1, c_out)) * 0.1).astype(np.float32)
    return tbl, x, w, bias, ct


def _jax_vjp(fn, args, ct):
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.array(g) for g in vjp(jnp.asarray(ct))]


def _torch_vjp(fn, args, ct):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.tensor(ct))
    return y.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["elu", "identity"])
def test_banded_conv_matches_jax(dtype, activation):
    """spiral_conv_banded against spiral_conv_banded_pallas and
    spiral_conv_take: values and x/W/b gradients, atol 1e-5 in float32
    and 1e-2 in bfloat16 (times the largest entry where that is > 1; dx
    off the structurally zero dummy row).  One exception: in bfloat16 the
    take form's dx comes from a scatter-add that sums in bfloat16 (0.015
    from the float32 sum on these inputs), while the banded forms sum in
    float32 and round once, so dx against the take form is held to 2e-2."""
    tbl, x, w, bias, ct = _conv_case()
    jband, tband = _band(tbl, len(tbl) - 1)
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    atol = 1e-5 if dtype == "float32" else 1e-2
    sp_j, sp_t = jnp.asarray(tbl), torch.tensor(tbl)
    y_t, g_t = _torch_vjp(lambda a, b_, c: TC.spiral_conv_banded(
        a, sp_t, tband, b_, c, activation, compute_dtype=td),
        (x, w, bias), ct)
    refs = {"pallas": lambda a, b_, c: JC.spiral_conv_banded_pallas(
                a, sp_j, jband, b_, c, activation, compute_dtype=jd),
            "take": lambda a, b_, c: JC.spiral_conv_take(
                a, sp_j, b_, c, activation, compute_dtype=jd)}
    for form, ref in refs.items():
        y_j, g_j = _jax_vjp(ref, (x, w, bias), ct)
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=atol)
        g_j[0][:, -1] = 0
        g_t0 = g_t[0].copy()
        g_t0[:, -1] = 0
        for name, a, b_ in zip(("dx", "dw", "db"), [g_t0] + g_t[1:], g_j):
            scale = max(1.0, float(np.abs(b_).max()))
            tol = 2e-2 if (dtype, form, name) == ("bfloat16", "take",
                                                  "dx") else atol
            np.testing.assert_allclose(a, b_, rtol=0, atol=tol * scale,
                                       err_msg=f"{form} {name}")


def test_banded_unpool_matches_jax():
    """unpool_banded against unpool_banded_pallas and unpool_take: values
    and the input gradient, atol 1e-5."""
    rng = np.random.default_rng(6)
    vf1, vc1, c, b = 600, 300, 8, 3
    dummy = vc1 - 1
    idx = np.clip(np.arange(vf1)[:, None] // 2
                  + rng.integers(-20, 20, (vf1, 3)), 0, vc1 - 1)
    far = rng.random((vf1, 3)) < 0.03
    idx[far] = rng.integers(0, vc1, far.sum())
    idx[-1] = dummy
    idx = idx.astype(np.int32)
    w = rng.random((vf1, 3)).astype(np.float32)
    jband, tband = _band(idx, dummy, weights=w.reshape(-1))
    assert tband.fix is not None
    x = rng.normal(size=(b, vc1, c)).astype(np.float32)
    x[:, -1] = 0.0
    ct = rng.normal(size=(b, vf1, c)).astype(np.float32)
    y_t, (g_t,) = _torch_vjp(lambda a: TS.unpool_banded(a, tband), (x,), ct)
    for ref in (lambda a: JS.unpool_banded_pallas(
                    a, jnp.asarray(idx), jnp.asarray(w), jband),
                lambda a: JS.unpool_take(a, jnp.asarray(idx),
                                         jnp.asarray(w))):
        y_j, (g_j,) = _jax_vjp(ref, (x,), ct)
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g_t[:, :-1], g_j[:, :-1], rtol=0,
                                   atol=1e-5)


def test_gates_keep_take_on_cpu(monkeypatch):
    """On the CPU spiral_conv and unpool ignore their bands; with the gates
    open they route to the banded forms (same values)."""
    tbl, x, w, bias, _ = _conv_case(seed=8, b=4)
    _, tband = _band(tbl, len(tbl) - 1)
    args = [torch.tensor(a) for a in (x, tbl, w, bias)]
    calls = []
    real = TC.spiral_conv_banded
    monkeypatch.setattr(TC, "spiral_conv_banded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # the card's measurements closed both gates: no batch bands, on the
    # card or the CPU
    assert not TC._banded_ok(4, torch.device("cpu"))
    assert TC._BANDED_MAX_B == 0
    assert not TC._banded_ok(1, torch.device("cuda"))
    assert not TC._banded_ok(16, torch.device("cuda"))
    ref = TC.spiral_conv(*args, "elu", band=tband)
    assert calls == []
    monkeypatch.setattr(TC, "_banded_ok", lambda *a: True)
    got = TC.spiral_conv(*args, "elu", band=tband)
    assert calls == [1]
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    t32 = torch.zeros(2, 3, 4)
    assert not TS._unpool_band_ok(2, torch.device("cpu"))
    assert TS._UNPOOL_BAND_MAX_B == 0
    assert not TS._unpool_band_ok(1, torch.device("cuda"))
    assert not TS._unpool_band_ok(128, torch.device("cuda"))
    monkeypatch.setattr(TS, "unpool_banded",
                        lambda *a: calls.append(2) or "banded")
    table = RG.GatherTable.build(np.zeros((5, 3)), 3, "cpu",
                                 w=np.ones((5, 3)))
    TS.unpool(t32, table, band=object())
    assert calls == [1]
    monkeypatch.setattr(TS, "_unpool_band_ok", lambda *a: True)
    assert TS.unpool(t32, table, band=object()) == "banded"


def test_full_topology_tables(full_hier):
    """banded=True on the bundled topology: conv bands at the two fine
    levels, unpool bands at all four transitions; banded=False none."""
    tab = TT.device_tables(full_hier, "cpu", banded=True)
    assert [b is not None for b in tab.bands] == [True, True, False, False,
                                                  False]
    assert all(b is not None for b in tab.unpool_bands)
    assert tab.unpool_bands[3].fix is None
    assert tab.bands[0].bwd.long_rows.shape[0] == 1      # the dummy row
    plain = TT.device_tables(full_hier, "cpu")
    assert plain.bands == () and plain.band_for(0) is None


def test_banded_model_matches_take(small_hierarchy, small_human, tmp_path,
                                   monkeypatch):
    """A PartAE with every level banded (gates forced, small presets)
    reproduces the take model's forward and gradients; a serving bundle
    keeps banded_conv."""
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.constants import KPS_KEEP
    from semantichuman_torch.models import build_model
    from semantichuman_torch.serving import ServingBundle, export_inference
    from semantichuman_torch.utils.testing import band_gate_patches

    path = tmp_path / "hier.npz"
    small_hierarchy.save(str(path))
    hier = MeshHierarchy.load(str(path))
    kw = dict(filter_sizes_enc=[[3, 8, 8, 16, 16], [[]] * 5],
              filter_sizes_dec=[[16, 16, 8, 8, 8], [[], [], [], [], 3]])
    take = build_model(ModelConfig(banded_conv=False, **kw), hier,
                       small_human.part_dict, device="cpu")
    for mod, name, val in band_gate_patches():
        monkeypatch.setattr(mod, name, val)
    banded = build_model(ModelConfig(**kw), hier, small_human.part_dict,
                         device="cpu")
    assert all(b is not None for b in banded.tables.bands)
    params = take.init(0)
    meshes = small_human.sample_meshes(3, seed=3).astype(np.float32)
    x = torch.tensor(np.concatenate([meshes, np.zeros((3, 1, 3),
                                                      np.float32)], 1))
    kps = torch.einsum("jv,bvd->bjd", torch.tensor(
        small_human.J_regressor, dtype=torch.float32), x[:, :-1])[:, KPS_KEEP]
    outs, grads = [], []
    for model in (take, banded):
        xg = x.clone().requires_grad_(True)
        y = model(params, xg, kps)[0]
        grads.append(torch.autograd.grad((y * y).sum(), xg)[0][:, :-1])
        outs.append(y.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(grads[1], grads[0], rtol=0,
                               atol=1e-5 * float(grads[0].abs().max()))
    out = str(tmp_path / "bundle")
    manifest = export_inference(banded, params, small_human.J_regressor, out)
    assert manifest["banded_conv"] is True
    served = ServingBundle(out, device="cpu")
    assert served.model.tables.banded_conv
    assert all(b is not None for b in served.model.tables.bands)
    torch.testing.assert_close(served.forward(x)[0], outs[1], rtol=0,
                               atol=1e-6)
