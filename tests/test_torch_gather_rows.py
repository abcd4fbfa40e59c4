"""The port's batched, weighted row gather (`ops/row_gather.py:gather_rows`,
row 7's kernel forward and row 8's CSR reduce backward) against the JAX
package, from numpy inputs made from a seed: T = 1 on the bundled
topology's pool_idx_0, faces_0 and a padded part index, T = 3 weighted on
its unpool_idx_0 / unpool_w_0 against `semantichuman_tpu/ops/sampling.py:
unpool_take`, float32 and bfloat16; the weighted CSR reduce against a dense
reference; and the training step's gathers: none left on index_select
with a gradient, and as many per step as chip_smoke.py's launch literals
count.

Tolerances: copies bit-equal; float32 weighted sums within 2e-6 of the
largest entry (XLA's einsum may sum the three taps in another order);
gradients within 1e-5 of the largest entry in float32 and 1e-2 in bfloat16
(the CSR reduce sums each row in ascending entry order, XLA's scatter-add
in its own order).  A bfloat16 input's taps and cotangents are summed in
float32 and rounded once, so its reference is the JAX function in float32
on the bfloat16-rounded values, rounded to bfloat16."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from semantichuman_torch.ops import csr_reduce as TR
from semantichuman_torch.ops import row_gather as RG
from semantichuman_torch.ops import sampling as TS
from semantichuman_tpu.ops import sampling as JS

TOPOLOGY = Path(__file__).resolve().parents[1] / "assets" / \
    "topology_synth_full_2222.npz"
B, C = 2, 4


@pytest.fixture(scope="module")
def topo():
    z = np.load(TOPOLOGY)
    return {k: z[k] for k in ("pool_idx_0", "faces_0", "unpool_idx_0",
                              "unpool_w_0", "verts_0", "verts_1")}


def _part_index(n_verts: int, rng) -> np.ndarray:
    """Five ragged parts padded to a common length with vertex 0, as the
    distance loss stacks them."""
    perm = rng.permutation(n_verts)
    sizes = (400, 37, 250, 128, 9)
    idx = np.zeros((len(sizes), max(sizes)), np.int64)
    start = 0
    for p, n in enumerate(sizes):
        idx[p, :n] = perm[start:start + n]
        start += n
    return idx.reshape(-1)


def _cases(topo):
    """(name, index [R] or [R, 3], weights or None, source rows)."""
    n0 = len(topo["verts_0"])
    rng = np.random.default_rng(0)
    return [("pool_0", topo["pool_idx_0"], None, n0 + 1),
            ("faces_0", topo["faces_0"].reshape(-1), None, n0),
            ("parts", _part_index(n0, rng), None, n0),
            ("unpool_0", topo["unpool_idx_0"], topo["unpool_w_0"],
             len(topo["verts_1"]) + 1)]


def _jax_ref(idx, w, x, ct):
    """(forward, VJP) of the JAX package's gather: jnp.take, or unpool_take
    for the weighted taps."""
    if w is None:
        def fn(a):
            return jnp.take(a, jnp.asarray(idx), axis=1)
    else:
        def fn(a):
            return JS.unpool_take(a, jnp.asarray(idx), jnp.asarray(w))
    y, vjp = jax.vjp(fn, x)
    return np.asarray(y), np.asarray(vjp(ct)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["pool_0", "faces_0", "parts", "unpool_0"])
def test_gather_rows_matches_jax(topo, case, dtype):
    """gather_rows and its VJP (torch.autograd.grad) against jax.vjp of the
    JAX gather on the same numpy inputs."""
    name, idx, w, n_src = next(c for c in _cases(topo) if c[0] == case)
    rng = np.random.default_rng(len(idx))
    r = idx.shape[0]
    x = rng.standard_normal((B, n_src, C)).astype(np.float32)
    ct = rng.standard_normal((B, r, C)).astype(np.float32)
    table = RG.GatherTable.build(idx, n_src, "cpu", w=w)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = RG.gather_rows(xt, table)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(ct).to(tdt))
    assert y.dtype == tdt and dx.dtype == tdt
    y, dx = y.detach().float().numpy(), dx.float().numpy()
    # the port sums the taps and the cotangents of bf16 values in f32 (f32
    # weights) and rounds once, so the reference is the JAX function and
    # its VJP in f32 on the bf16-rounded values (XLA's bf16 scatter-add
    # rounds every partial sum)
    xr = xt.detach().float().numpy()
    ctr = torch.from_numpy(ct).to(tdt).float().numpy()
    y_j, dx_j = _jax_ref(idx, w, jnp.asarray(xr), jnp.asarray(ctr))
    if w is None:
        # a copy: bit-equal in either type
        np.testing.assert_array_equal(y, y_j)
    else:
        if dtype == "float32":
            np.testing.assert_allclose(y, y_j, rtol=0,
                                       atol=2e-6 * np.abs(y_j).max())
        else:
            # one rounding to bf16 of f32 sums in another order
            np.testing.assert_allclose(
                y, np.asarray(jnp.asarray(y_j, jnp.bfloat16), np.float32),
                rtol=2 ** -8, atol=0)
    dx_j = np.asarray(jnp.asarray(dx_j, getattr(jnp, dtype)), np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(dx, dx_j, rtol=0,
                               atol=tol * np.abs(dx_j).max(), err_msg=name)


def test_pool_and_unpool_take_match_jax(topo):
    """pool and unpool_take through the model's tables against the JAX
    forms at level 0: pool bit-equal, unpool within 2e-6 of the largest
    entry."""
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.topology import MeshHierarchy
    t = device_tables(MeshHierarchy.load(str(TOPOLOGY)), "cpu")
    rng = np.random.default_rng(1)
    xf = rng.standard_normal((B, t.sizes[0] + 1, C)).astype(np.float32)
    xc = rng.standard_normal((B, t.sizes[1] + 1, C)).astype(np.float32)
    np.testing.assert_array_equal(
        TS.pool(torch.from_numpy(xf), t.pool_gather[0]).numpy(),
        np.asarray(JS.pool_take(jnp.asarray(xf),
                                jnp.asarray(topo["pool_idx_0"]))))
    want = np.asarray(JS.unpool_take(jnp.asarray(xc),
                                     jnp.asarray(topo["unpool_idx_0"]),
                                     jnp.asarray(topo["unpool_w_0"])))
    got = TS.unpool_take(torch.from_numpy(xc), t.unpool_gather[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_reduce_plain_weighted_matches_dense(weighted):
    """The (weighted) CSR reduce over a gather's inverse equals the dense
    transpose of the gather matrix applied to g, to 1e-6 of the largest
    entry; rows nothing reads stay 0."""
    rng = np.random.default_rng(7)
    n_src, r = 60, 150
    idx = rng.integers(0, n_src - 5, (r, 3))
    idx[:40] = 3                                        # a long row
    w = rng.uniform(0, 1, idx.shape).astype(np.float32) if weighted \
        else None
    table = RG.GatherTable.build(idx, n_src, "cpu", w=w)
    g = rng.standard_normal((3, r, 5)).astype(np.float32)
    dense = np.zeros((n_src, r))
    for row in range(r):
        for t in range(3):
            dense[idx[row, t], row] += 1.0 if w is None else w[row, t]
    want = np.einsum("ur,brc->buc", dense, g)
    got = TR.csr_reduce_plain(torch.from_numpy(g), table.inverse,
                              table.inv_w).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert not got[:, n_src - 5:].any()


def test_gather_table_checks_and_cache():
    with pytest.raises(ValueError):
        RG.GatherTable.build(np.array([[0, 1]]), 5, "cpu")
    with pytest.raises(ValueError):
        RG.GatherTable.build(np.array([0, 5]), 5, "cpu")
    a = RG.constant_table([3, 1, 2], 4, "cpu")
    assert a is RG.constant_table(np.array([3, 1, 2]), 4, "cpu")
    assert a is not RG.constant_table([3, 1, 2], 5, "cpu")
    assert a.taps == 1 and a.n_rows == 3 and a.n_src == 4
    x = torch.arange(8.0).reshape(1, 4, 2).requires_grad_(True)
    with pytest.raises(ValueError):
        RG.gather_rows(x[:, :3], a)
    (dx,) = torch.autograd.grad(RG.gather_rows(x, a).sum(), x)
    assert dx[0, 0].tolist() == [0.0, 0.0]


# --- the training step's gathers ---------------------------------------------

@pytest.fixture(scope="module")
def step_setup(small_hierarchy, small_human, tmp_path_factory):
    """The small model's full training step at B = 2 per segment on the
    CPU (the take route, as on the card at trunk batch 384)."""
    import dataclasses
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.train import losses as TL
    from semantichuman_torch.train import step as TST
    from semantichuman_torch.train.edits import EditSampler
    from semantichuman_torch.train.optim import make_optimizer
    from tests.conftest import SMALL_MODEL_OVERRIDES

    path = tmp_path_factory.mktemp("gather_step") / "hier.npz"
    small_hierarchy.save(str(path))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    model = build_model(ModelConfig(**{k: v for k, v in
                                       SMALL_MODEL_OVERRIDES.items()
                                       if k in fields}),
                        MeshHierarchy.load(str(path)),
                        small_human.part_dict, device="cpu")
    tables = TL.build_loss_tables(small_human.template_faces,
                                  small_human.J_regressor,
                                  small_human.part_dict, device="cpu")
    meshes = small_human.sample_meshes(6, seed=5).astype(np.float32)
    verts = np.concatenate([meshes, np.zeros((6, 1, 3), np.float32)], 1)
    measure = small_human.measures(meshes).astype(np.float32)
    v = torch.from_numpy(verts)
    with torch.no_grad():
        from semantichuman_torch.ops.distance import (face_edge_lengths,
                                                      signed_part_volumes)
        edges = face_edge_lengths(v[:, :-1], tables.faces)
        vols = signed_part_volumes(v[:, :-1], tables.faces,
                                   tables.face_part_mask)
    segs = [{"verts": v[k:k + 2], "measure": torch.from_numpy(
        measure[k:k + 2]), "gt_face_edges": edges[k:k + 2],
        "gt_part_vols": vols[k:k + 2]} for k in (0, 2, 4)]
    spec = TST.to_device(EditSampler(seed=0).sample_interp(200, 2), "cpu")
    opt = make_optimizer(1e-3, 5e-5, 0.99, steps_per_epoch=1)
    step = TST.make_train_step(model, tables, opt, TST.StepFlags(), "ori")
    params = model.init(0)
    return step, params, opt.init(params), segs, spec


def test_train_step_has_no_index_select_with_a_gradient(step_setup,
                                                        monkeypatch):
    """Every gather of the step whose input takes a gradient goes through
    gather_rows: wrapping torch.Tensor.index_select records none with a
    gradient (gathers of data keep index_select)."""
    step, params, state, segs, spec = step_setup
    seen = []
    real = torch.Tensor.index_select

    def recording(self, dim, index):
        if torch.is_grad_enabled() and self.requires_grad:
            seen.append((tuple(self.shape), dim, int(index.numel())))
        return real(self, dim, index)

    monkeypatch.setattr(torch.Tensor, "index_select", recording)
    _p, _s, metrics = step(params, state, *segs, spec)
    assert np.isfinite(float(metrics["loss"]))
    assert seen == []


def test_train_step_gathers_match_the_launch_literals(step_setup,
                                                      monkeypatch):
    """One step runs as many row gathers and gather backwards as
    chip_smoke.py's STEP_LAUNCHES counts on the card (the row_gather
    launches, and the csr_reduce launches but the unfused dx half's)."""
    step, params, state, segs, spec = step_setup
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = RG.gather_rows_fwd, RG.csr_reduce

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(RG, "gather_rows_fwd", count("fwd", fwd))
    monkeypatch.setattr(RG, "csr_reduce", count("bwd", bwd))
    step(params, state, *segs, spec)
    assert calls["fwd"] == CS.STEP_LAUNCHES["row_gather"] == (
        CS.ENCODE_GATHERS + CS.UNPOOL_GATHERS + CS.LOSS_GATHERS)
    assert calls["bwd"] == CS.STEP_LAUNCHES["csr_reduce"] - 1 == (
        CS.ENCODE_GATHER_GRADS + CS.UNPOOL_GATHERS + CS.LOSS_GATHER_GRADS)


def test_gather_rows_mode_parses():
    args = CS.parse_args(["--gather-rows"])
    assert args.gather_rows and not (args.conv_forward or args.part_dist)


def test_profile_groups_hold_the_row_gather_kernels():
    """Each kernel of csrc/row_gather.cu falls in one family of the step's
    profile (row_gather or row_gather_sum) and in no other, so the
    index_add family the profile gate holds at 0 counts torch's kernels
    only."""
    import re
    src = (Path(__file__).resolve().parents[1] / "semantichuman_torch"
           / "csrc" / "row_gather.cu").read_text()
    names = [re.search(r"(\w+)\(", re.sub(r"__launch_bounds__\([^)]*\)", "",
                                          c)).group(1)
             for c in src.split("__global__")[1:]]
    assert sorted(names) == ["gather_copy_kernel", "gather_sum_kernel"]
    for name, family in zip(sorted(names), ("row_gather", "row_gather_sum")):
        label = f"void (anonymous namespace)::{name}<float, 4, 3, true>(int)"
        assert [g for g, key in CS.PROFILE_GROUPS.items()
                if key in label] == [family]
    assert CS.PROFILE_GROUPS["index_add"] == "indexFunc"
