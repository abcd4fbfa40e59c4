"""The spiral conv's backward, half by half: the plain versions of the dW
and dx kernels (`spiral_conv_bwd_dw_plain`, `spiral_conv_bwd_dx_plain`)
against jax.vjp of spiral_conv_take, the unfused route against them, the
dispatch of SpiralConvFn.backward, and the wrappers' checks.  The kernels
against their plain versions on the card are in test_torch_kernels_cuda.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.models.tables import inverse_spiral_csr
from semantichuman_torch.ops import csr_reduce as TR
from semantichuman_tpu.ops.spiral_conv import spiral_conv_take

# the module: `semantichuman_torch.ops.spiral_conv` is the function
TC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

torch.set_num_threads(1)

# (b, v1, s, c, co): the shapes of test_torch_spiral_conv_grad.py (the
# second has the 3-channel input and output widths of the model's first and
# last convs), and one whose dummy row (a fifth of 700 * 7 entries) is
# longer than LONG_ROW and spans two chunks
SHAPES = [(2, 40, 6, 8, 16), (3, 50, 9, 3, 3), (2, 700, 7, 4, 5)]
ACTIVATIONS = ["elu", "relu", "leaky_relu", "sigmoid", "tanh", "identity"]


def _case(shape, seed=0):
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


def _jax_grads(x, idx, w, bias, ct, activation, compute_dtype):
    def f(xx, ww, bb):
        return spiral_conv_take(xx, jnp.asarray(idx), ww, bb, activation,
                                compute_dtype=compute_dtype)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _dy(y, ct, activation):
    """dy' as SpiralConvFn.backward makes it: the cotangent times the
    activation's derivative from the output, dummy row zero."""
    dy = torch.from_numpy(ct) * TC._act_grad(torch.from_numpy(y.copy()),
                                             activation)
    dy[:, -1] = 0.0
    return dy


def _halves(x, idx, w, ct, y, activation, dtype):
    """(dx, dW) from the two plain versions, inputs in `dtype` as the
    Function hands them over."""
    dy = _dy(y, ct, activation)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    dw = TC.spiral_conv_bwd_dw_plain(xt, torch.from_numpy(idx), dy)
    dx = TC.spiral_conv_bwd_dx_plain(dy, wt, _csr(idx), idx.shape)
    return dx, dw


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_halves_match_jax_f32(shape, activation):
    """dx and dW, each from its plain version, against jax.vjp of
    spiral_conv_take: atol 1e-5 (f32 sums of the same products in another
    order), scaled by the largest entry where a sum runs over more than a
    thousand terms (dW and the long dummy row of the third shape)."""
    x, idx, w, bias, ct = _case(shape)
    y, (want_dx, want_dw, _db) = _jax_grads(x, idx, w, bias, ct, activation,
                                            None)
    dx, dw = _halves(x, idx, w, ct, y, activation, torch.float32)
    assert dx.dtype == dw.dtype == torch.float32
    assert dx.shape == x.shape and dw.shape == w.shape
    for g, r in ((dx, want_dx), (dw, want_dw)):
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_halves_match_jax_bf16(shape, activation):
    """bf16 x and W: the halves sum in f32, JAX's VJP rounds to bf16 (dx
    after summing the gather's transpose in bf16): atol = rtol = 1e-2 after
    the bf16 rounding the Function applies to both gradients, dW's atol
    scaled by its largest entry.  dx's dummy row sums up to 980 entries,
    which JAX's bf16 sum does not hold to 1e-2: it is held to JAX's f32
    VJP on the bf16-rounded x and W instead."""
    x, idx, w, bias, ct = _case(shape, seed=1)
    y, (want_dx, want_dw, _db) = _jax_grads(x, idx, w, bias, ct, activation,
                                            jnp.bfloat16)
    rounded = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32)) for a in (x, w)]
    _y, (f32_dx, _dw, _db) = _jax_grads(rounded[0], idx, rounded[1], bias, ct,
                                        activation, None)
    want_dx = np.concatenate([want_dx[:, :-1], f32_dx[:, -1:]], axis=1)
    dx, dw = _halves(x, idx, w, ct, y, activation, torch.bfloat16)
    assert dx.dtype == dw.dtype == torch.float32
    for g, r in ((dx, want_dx), (dw, want_dw)):
        np.testing.assert_allclose(g.bfloat16().float().numpy(), r, rtol=1e-2,
                                   atol=1e-2 * max(1.0, np.abs(r).max()))


def test_long_dummy_row_case_is_long():
    """The third shape's dummy row takes the long-row path: more entries
    than LONG_ROW, in more than one chunk."""
    _x, idx, _w, _b, _ct = _case(SHAPES[2])
    table = _csr(idx)
    deg = np.diff(table.offs.numpy())
    assert deg[-1] > TR.CHUNK > TR.LONG_ROW
    assert table.long_rows.tolist() == [idx.shape[0] - 1]
    assert table.chunk_lo.shape[0] >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_unfused_route_equals_plain_halves(shape, dtype):
    """On the CPU the unfused route (its csr_reduce is the plain one
    there) and the plain halves are the same sums: bit-equal.  It computes
    only the halves asked for."""
    x, idx, w, _bias, ct = _case(shape, seed=2)
    dy = torch.from_numpy(ct)
    dy[:, -1] = 0.0
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    it, table = torch.from_numpy(idx), _csr(idx)
    dx, dw = TC.spiral_conv_bwd_unfused(xt, wt, dy, it, table)
    assert torch.equal(dw, TC.spiral_conv_bwd_dw(xt, it, dy))
    assert torch.equal(dx, TC.spiral_conv_bwd_dx(dy, wt, table, idx.shape))
    assert TC.spiral_conv_bwd_unfused(xt, wt, dy, it, table, need_x=False,
                                      need_w=False) == (None, None)
    only_dx = TC.spiral_conv_bwd_unfused(xt, wt, dy, it, table, need_w=False)
    assert only_dx[1] is None and torch.equal(only_dx[0], dx)


@pytest.mark.parametrize("halves", [(), ("dx",), ("dw",), ("dx", "dw")])
def test_backward_routes_agree(monkeypatch, halves):
    """The backward with halves sent to the unfused route equals the fused
    route's plain versions, and the unfused route is asked for exactly
    those halves."""
    x, idx, w, _bias, ct = _case(SHAPES[0], seed=3)
    dy = torch.from_numpy(ct)
    xt, wt, it = (torch.from_numpy(a) for a in (x, w, idx))
    table = _csr(idx)
    ref = TC._conv_backward(xt, wt, dy, it, table, True, True)
    calls = []
    unfused = TC.spiral_conv_bwd_unfused

    def spy(*args):
        calls.append(args[5:])
        return unfused(*args)

    monkeypatch.setattr(TC, "spiral_conv_bwd_unfused", spy)
    got = TC._conv_backward(xt, wt, dy, it, table, True, True, halves)
    assert calls == [("dx" in halves, "dw" in halves)]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_dispatch_reads_the_table_by_static_shape(monkeypatch):
    """`_unfused_halves` keys on (C, Co, S) alone above batch 16 (at batch
    <= 16 dx goes unfused whatever the shape), and names nothing for a
    CPU tensor whatever the table says."""
    b, v1, s, c, co = SHAPES[0]
    x, idx, w, _bias, _ct = _case(SHAPES[0])
    xt, wt, it = (torch.from_numpy(a) for a in (x, w, idx))
    monkeypatch.setattr(TC, "_UNFUSED", {(c, co, s): ("dw",)})
    assert TC._unfused_halves(xt, wt, it) == ()
    big = TC._DX_FUSED_MIN_B
    on_card = [torch.empty((big, v1, c), device="meta"), wt.to("meta"),
               it.to("meta")]
    assert TC._unfused_halves(*on_card) == ("dw",)
    assert TC._unfused_halves(on_card[0][:, :7], on_card[1],
                              on_card[2][:7]) == ("dw",)
    assert TC._unfused_halves(on_card[0][:1], *on_card[1:]) == ("dx", "dw")
    monkeypatch.setattr(TC, "_UNFUSED", {(c + 1, co, s): ("dx", "dw")})
    assert TC._unfused_halves(*on_card) == ()


def test_dispatch_table_names_only_halves():
    for key, halves in TC._UNFUSED.items():
        assert len(key) == 3 and all(isinstance(k, int) for k in key)
        assert set(halves) <= {"dx", "dw"} and halves


def test_launch_counters_stay_zero_on_cpu():
    x, idx, w, bias, ct = _case(SHAPES[0])
    before = (TC.spiral_conv_bwd_dx.launches, TC.spiral_conv_bwd_dw.launches)
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    y = TC.spiral_conv(xt, torch.from_numpy(idx), wt, torch.from_numpy(bias),
                       csr=_csr(idx))
    y.backward(torch.from_numpy(ct))
    assert xt.grad is not None and wt.grad is not None
    assert (TC.spiral_conv_bwd_dx.launches,
            TC.spiral_conv_bwd_dw.launches) == before


# --- the wrappers' checks ----------------------------------------------------

def _check_args():
    x, idx, w, _bias, ct = _case(SHAPES[0])
    return (torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
            torch.from_numpy(ct), _csr(idx))


@pytest.mark.parametrize("fault,error", [
    ("x_dtype", TypeError), ("dy_dtype", TypeError), ("idx_dtype", TypeError),
    ("x_rows", ValueError), ("idx_rows", ValueError), ("x_dim", ValueError),
    ("x_strided", ValueError), ("dy_strided", ValueError),
    ("device", ValueError)])
def test_dw_check_raises(fault, error):
    x, idx, _w, dy, _t = _check_args()
    TC._check_bwd_dw(x, idx, dy)
    if fault == "x_dtype":
        x = x.double()
    elif fault == "dy_dtype":
        dy = dy.bfloat16()
    elif fault == "idx_dtype":
        idx = idx.long()
    elif fault == "x_rows":
        x = x[:, :-1].contiguous()
    elif fault == "idx_rows":
        idx = idx[:-1].contiguous()
    elif fault == "x_dim":
        x = x[0]
    elif fault == "x_strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "dy_strided":
        dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "device":
        x = x.to("meta")
    with pytest.raises(error):
        TC._check_bwd_dw(x, idx, dy)


@pytest.mark.parametrize("fault,error", [
    ("w_dtype", TypeError), ("dy_dtype", TypeError), ("w_cols", ValueError),
    ("w_rows", ValueError), ("dy_rows", ValueError), ("table", ValueError),
    ("w_strided", ValueError), ("dy_strided", ValueError),
    ("device", ValueError), ("wide", ValueError)])
def test_dx_check_raises(fault, error):
    _x, idx, w, dy, table = _check_args()
    shape = tuple(idx.shape)
    TC._check_bwd_dx(dy, w, table, shape)
    if fault == "w_dtype":
        w = w.half()
    elif fault == "dy_dtype":
        dy = dy.double()
    elif fault == "w_cols":
        w = w[:, :-1].contiguous()
    elif fault == "w_rows":
        w = w[:-1].contiguous()
    elif fault == "dy_rows":
        dy = dy[:, :-1].contiguous()
    elif fault == "table":
        shape = (shape[0], shape[1] + 1)
        w = torch.zeros((shape[1] * 8, w.shape[1]))
    elif fault == "w_strided":
        w = w.t().contiguous().t()
    elif fault == "dy_strided":
        dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "device":
        w = w.to("meta")
    elif fault == "wide":
        dy = torch.zeros((2, 40, 1200))
        w = torch.zeros((48, 1200))
    with pytest.raises(error):
        TC._check_bwd_dx(dy, w, table, shape)


def test_wrappers_refuse_other_devices():
    x, idx, w, dy, table = _check_args()
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.spiral_conv_bwd_dw(x.to("meta"), idx.to("meta"), dy.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.spiral_conv_bwd_dx(dy.to("meta"), w, table, tuple(idx.shape))
