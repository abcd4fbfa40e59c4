"""The spiral conv's backward against JAX: the gradients of x, W and bias
through SpiralConvFn (the plain versions of its kernels on CPU) against
jax.grad of spiral_conv_take, the inverse spiral tables, and the plain
CSR reduce against jax.grad of the gather.  The kernels against their
plain versions on the card are in test_torch_kernels_cuda.py."""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.models.tables import (device_tables,
                                               inverse_spiral_csr)
from semantichuman_torch.ops import csr_reduce as TR
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_tpu.ops.spiral_conv import spiral_conv_take, spiral_gather

# the module: `semantichuman_torch.ops.spiral_conv` is the function
TC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

torch.set_num_threads(1)

FULL_TOPOLOGY = str(Path(__file__).resolve().parents[1]
                    / "assets" / "topology_synth_full_2222.npz")
# (b, v1, s, c, co): the test_pallas.py shape, and a ragged one with the
# 3-channel input and output widths of the model's first and last convs
SHAPES = [(2, 40, 6, 8, 16), (3, 50, 9, 3, 3)]
ACTIVATIONS = ["elu", "relu", "leaky_relu", "sigmoid", "tanh", "identity"]


def _case(shape, seed=0):
    """Inputs, a cotangent and the inverse table; a fifth of the spiral
    entries are pads that point at the dummy row, as on a mesh border."""
    b, v1, s, c, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0
    idx = rng.integers(0, v1 - 1, (v1, s)).astype(np.int32)
    idx[rng.uniform(size=idx.shape) < 0.2] = v1 - 1
    idx[-1] = v1 - 1
    w = (rng.standard_normal((s * c, co)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    ct = (rng.standard_normal((b, v1, co)) * 0.1).astype(np.float32)
    return x, idx, w, bias, ct


def _csr(idx):
    return TR.CSRTable.build(*inverse_spiral_csr(idx), n_src=idx.size,
                             device="cpu")


def _port_grads(x, idx, w, bias, ct, activation, compute_dtype):
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    y = TC.spiral_conv(xt, torch.from_numpy(idx), wt, bt, activation,
                       compute_dtype=compute_dtype, csr=_csr(idx))
    y.backward(torch.from_numpy(ct))
    return y.detach().numpy(), [t.grad.numpy() for t in (xt, wt, bt)]


def _jax_grads(x, idx, w, bias, ct, activation, compute_dtype):
    def f(xx, ww, bb):
        return spiral_conv_take(xx, jnp.asarray(idx), ww, bb, activation,
                                compute_dtype=compute_dtype)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_grads_match_jax_f32(shape, activation):
    """x, W and bias gradients, dummy row included, atol 1e-5 (f32 sums
    of the same products in another order)."""
    args = _case(shape)
    y, got = _port_grads(*args, activation, None)
    y_ref, want = _jax_grads(*args, activation, None)
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    for name, g, r in zip(("x", "w", "b"), got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_conv_grads_match_jax_bf16(shape, activation):
    """compute_dtype=bfloat16: the gradients come back as float32 through
    the cast, as JAX's astype VJP gives them.  atol = rtol = 1e-2: both
    sides round x's and W's gradients to bf16, JAX after summing the
    gather's transpose in bf16, the port after summing it in f32."""
    args = _case(shape, seed=1)
    y, got = _port_grads(*args, activation, torch.bfloat16)
    y_ref, want = _jax_grads(*args, activation, jnp.bfloat16)
    np.testing.assert_allclose(y, y_ref, atol=1e-2, rtol=1e-2)
    for name, g, r in zip(("x", "w", "b"), got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-2, rtol=1e-2, err_msg=name)


def test_conv_without_x_grad_needs_no_table():
    """The first encoder conv's input is data: no dx, no table needed;
    asking for dx without the table raises."""
    x, idx, w, bias, ct = _case(SHAPES[0])
    wt = torch.tensor(w, requires_grad=True)
    y = TC.spiral_conv(torch.from_numpy(x), torch.from_numpy(idx), wt,
                       torch.from_numpy(bias))
    y.backward(torch.from_numpy(ct))
    assert wt.grad is not None
    with pytest.raises(ValueError, match="inverse spiral table"):
        TC.spiral_conv(torch.tensor(x, requires_grad=True),
                       torch.from_numpy(idx), wt, torch.from_numpy(bias))


def test_plain_conv_is_differentiable():
    """The plain version keeps its dummy row out of place, so autograd can
    run it (the plain route of the train step), and agrees with
    SpiralConvFn's gradients."""
    x, idx, w, bias, ct = _case(SHAPES[1], seed=2)
    for act in ("relu", "elu"):
        xt, wt, bt = (torch.tensor(a, requires_grad=True)
                      for a in (x, w, bias))
        y = TC.spiral_conv_plain(xt, torch.from_numpy(idx), wt, bt, act)
        y.backward(torch.from_numpy(ct))
        _, want = _port_grads(x, idx, w, bias, ct, act, None)
        for g, r in zip((xt.grad, wt.grad, bt.grad), want):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5)


# --- the inverse spiral tables -----------------------------------------------

def test_inverse_spiral_tables_round_trip():
    """Every flat (v, s) entry of every level of the bundled topology
    appears exactly once, in the row of the vertex it gathers, in
    ascending order; the dummy row is the one long row and its chunks
    cover it exactly."""
    hier = MeshHierarchy.load(FULL_TOPOLOGY)
    tables = device_tables(hier, "cpu")
    for l, sp in enumerate(hier.spirals):
        flat = np.asarray(sp).reshape(-1)
        t = tables.spiral_csr[l]
        offs, cols = t.offs.numpy(), t.cols.numpy()
        assert t.n_rows == sp.shape[0] and t.n_src == flat.size
        np.testing.assert_array_equal(np.sort(cols), np.arange(flat.size))
        rows = np.repeat(np.arange(t.n_rows), np.diff(offs))
        np.testing.assert_array_equal(flat[cols], rows)
        np.testing.assert_array_equal(t.rows.numpy(), rows)
        for u in range(t.n_rows):
            assert np.all(np.diff(cols[offs[u]:offs[u + 1]]) > 0)
        deg = np.diff(offs)
        dummy = sp.shape[0] - 1
        np.testing.assert_array_equal(t.long_rows.numpy(),
                                      np.nonzero(deg > TR.LONG_ROW)[0])
        assert dummy in t.long_rows.numpy()
        lo, hi, co = (t.chunk_lo.numpy(), t.chunk_hi.numpy(),
                      t.chunk_offs.numpy())
        for i, u in enumerate(t.long_rows.numpy()):
            ks = range(co[i], co[i + 1])
            assert lo[ks[0]] == offs[u] and hi[ks[-1]] == offs[u + 1]
            assert all(hi[k] == lo[k + 1] for k in ks[:-1])
            assert all(0 < hi[k] - lo[k] <= TR.CHUNK for k in ks)
    assert int(np.diff(tables.spiral_csr[0].offs.numpy())[-1]) == 34041


def test_csr_table_rejects_bad_input():
    offs, cols = inverse_spiral_csr(np.array([[0, 1], [1, 1]]))
    with pytest.raises(ValueError, match="columns"):
        TR.CSRTable.build(offs, cols, n_src=3, device="cpu")
    with pytest.raises(ValueError, match="offsets"):
        TR.CSRTable.build(offs[::-1], cols, n_src=4, device="cpu")
    g = torch.zeros((1, 5, 2))
    with pytest.raises(ValueError, match="rows"):
        TR._check(g, TR.CSRTable.build(offs, cols, n_src=4, device="cpu"))


@pytest.mark.parametrize("level", [0, 2])
def test_plain_csr_reduce_matches_jax_gather_grad(level):
    """csr_reduce_plain over the bundled topology's inverse table equals
    jax.grad of the spiral gather (its transpose): atol 1e-5 (f32 sums in
    another order; the dummy row sums 34,041 entries at level 0)."""
    hier = MeshHierarchy.load(FULL_TOPOLOGY)
    sp = np.asarray(hier.spirals[level])
    v1, s = sp.shape
    c = 3
    rng = np.random.default_rng(level)
    g = (rng.standard_normal((2, v1 * s, c)) * 0.01).astype(np.float32)
    got = TR.csr_reduce(torch.from_numpy(g), _csr(sp)).numpy()
    x = jnp.zeros((2, v1, c), jnp.float32)
    _, vjp = jax.vjp(lambda xx: spiral_gather(xx, jnp.asarray(sp)), x)
    (want,) = vjp(jnp.asarray(g.reshape(2, v1, s * c)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
