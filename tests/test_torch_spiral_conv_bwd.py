"""The spiral conv's backward, half by half: the plain versions of the dW
and dx kernels (`spiral_conv_bwd_dw_plain`, `spiral_conv_bwd_dx_plain`)
against jax.vjp of spiral_conv_take, the unfused route against them, the
dispatch of SpiralConvFn.backward, the wrappers' checks, the dW
kernel's window plan (`ops/dw_window.py`) and the dx kernel's short-row
plan (`ops/dx_plan.py`) walked on the CPU.  The kernels
against their plain versions on the card are in test_torch_kernels_cuda.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.models.tables import inverse_spiral_csr
from semantichuman_torch.ops import csr_reduce as TR
from semantichuman_torch.ops import dw_window as DW
from semantichuman_torch.ops import dx_plan as DX
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
    ("device", ValueError), ("wide", ValueError), ("slice", ValueError)])
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
    elif fault == "slice":  # S*Co within the long-row scratch, but no
        dy = torch.zeros((2, 40, 900))  # short-row weight slice fits
        w = torch.zeros((48, 900))
    with pytest.raises(error):
        TC._check_bwd_dx(dy, w, table, shape)


def test_wrappers_refuse_other_devices():
    x, idx, w, dy, table = _check_args()
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.spiral_conv_bwd_dw(x.to("meta"), idx.to("meta"), dy.to("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.spiral_conv_bwd_dx(dy.to("meta"), w, table, tuple(idx.shape))


# --- the dW kernel's window plan (ops/dw_window.py) ---------------------------

TOPOLOGY = "assets/topology_synth_full_2222.npz"
# (level, C_in, C_out) of the nine convs of PartAE and of neural3DMM (the
# same widths), in forward order
MODEL_CONVS = [(0, 3, 16), (1, 16, 32), (2, 32, 64), (3, 64, 128),
               (3, 128, 64), (2, 64, 32), (1, 32, 32), (0, 32, 16),
               (0, 16, 3)]


def _levels():
    with np.load(TOPOLOGY) as z:
        return [z[f"spirals_{l}"] for l in range(int(z["n_levels"]))]


def _permuted(spiral, seed=0):
    """The table with its vertices in a random order, the dummy row last:
    the case with no locality."""
    v = spiral.shape[0] - 1
    perm = np.append(np.random.default_rng(seed).permutation(v), v)
    out = np.empty_like(spiral)
    out[perm] = perm[spiral]
    return out


def _tables():
    """(label, spiral) of every bundled level, each level permuted, and a
    small random table with pads."""
    levels = _levels()
    out = [(f"L{l}", s) for l, s in enumerate(levels)]
    out += [(f"L{l} permuted", _permuted(s, l)) for l, s in enumerate(levels)]
    _x, idx, *_rest = _case(SHAPES[2])
    return out + [("random 700x7", idx)]


@pytest.mark.parametrize("label,spiral", _tables(),
                         ids=[t[0] for t in _tables()])
def test_window_plan_maps_back_to_the_spiral(label, spiral):
    """At every tile size: each tile's list is sorted and unique, every
    (v, s) maps back to spiral[v, s] through its tile's list, each row's
    mask is the set of slots that name it in the tile, and the index pads
    are 0."""
    win = DW.DwWindow.build(spiral, "cpu")
    v1, s = spiral.shape
    assert win.spiral_shape == (v1, s) and min(win.plans) == 16
    for t, p in win.plans.items():
        rows, lidx = p.rows.long().numpy(), p.lidx.long().numpy()
        assert lidx.shape == (-(-v1 // 16) * 16 + DW.LIDX_PAD, DW.s_pad(s))
        assert not lidx[v1:].any() and not lidx[:, s:].any()
        offs = p.host_offs
        assert offs[0] == 0 and offs[-1] == len(rows)
        assert len(offs) == -(-v1 // t) + 1
        assert p.max_rows == np.diff(offs).max()
        for tile in range(len(offs) - 1):
            lst = rows[offs[tile]:offs[tile + 1]]
            assert np.all(np.diff(lst) > 0), (label, t, tile)
            vs = slice(tile * t, min(v1, (tile + 1) * t))
            np.testing.assert_array_equal(lst[lidx[vs, :s]], spiral[vs])
            assert set(lst) == set(spiral[vs].ravel())
            want = np.zeros(len(lst), np.int64)
            for j in range(s):
                np.bitwise_or.at(want, lidx[vs, j], 1 << min(j, 31))
            np.testing.assert_array_equal(
                p.host_masks[offs[tile]:offs[tile + 1]].astype(np.uint32),
                want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("permuted", [False, True])
def test_window_fits_the_shared_memory_budget(dtype, permuted):
    """At every conv of the bundled topology, at batch 1, 12 and 128 and
    on a vertex order with no locality, the plan's window fits: the blocks
    an SM the kernel is set for where any tile size allows, else one; its shared memory is the
    window's longest list C wide beside the ring; T is the largest that
    fits and still gives four blocks an SM, else the smallest that fits;
    the chunks cover every item once."""
    levels = _levels()
    es = 2 if dtype == torch.bfloat16 else 4
    for lvl, c, co in MODEL_CONVS:
        spiral = _permuted(levels[lvl], lvl) if permuted else levels[lvl]
        win = DW.DwWindow.build(spiral, "cpu")
        v1, s = spiral.shape
        for b in (1, 12, 128):
            plan = win.launch_plan(b, c, co, dtype)
            t, shape = plan["t"], plan["shape"]
            assert plan["smem"] == DW.smem_bytes(win.plans[t].max_rows, c, s,
                                                 shape, es)
            budget = DW.budget(shape) if any(
                DW.smem_bytes(p.max_rows, c, s, shape, es)
                <= DW.budget(shape) for p in win.plans.values()) \
                else DW.SMEM_ONE
            fits = [u for u, p in win.plans.items()
                    if DW.smem_bytes(p.max_rows, c, s, shape, es) <= budget]
            assert plan["smem"] <= budget and t in fits
            blocks = [u for u in fits if -(-v1 // u) * b * plan["kt"]
                      * plan["nt"] >= 4 * DW.SMS]
            assert t == (max(blocks) if blocks else min(fits))
            assert plan["items"] == -(-v1 // t) * b
            assert (plan["chunks"] - 1) * plan["per_chunk"] < plan["items"] \
                <= plan["chunks"] * plan["per_chunk"]
            assert plan["rows"] <= plan["entries"]
        if not permuted and lvl == 0:
            # the level-0 convs at trunk 128: each staged row replaces
            # more than 1.5 reads of a gathered row
            plan = win.launch_plan(128, c, co, dtype)
            assert plan["entries"] > 1.5 * plan["rows"]


WALK_CASES = [(0, 3, 16, 1), (4, 16, 3, 3), (4, 32, 64, 2), (3, 128, 64, 1),
              (3, 64, 128, 2), (2, 24, 40, 2), (4, 5, 7, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_window_walk_gives_plain_dw(case, dtype):
    """The plan walked in the kernel's order (chunks of batch-major items,
    each k-tile's window holding only the rows it copies, the rest NaN)
    gives spiral_conv_bwd_dw_plain's dW: the same products, f32 sums in
    another order (1e-5 of the largest entry); also on the level with its
    vertices permuted."""
    lvl, c, co, b = case
    for spiral in (_levels()[lvl], _permuted(_levels()[lvl], 7)):
        v1, s = spiral.shape
        rng = np.random.default_rng(lvl + c + co)
        x = torch.from_numpy(rng.standard_normal((b, v1, c)).astype(
            np.float32)).to(dtype)
        dy = torch.from_numpy(rng.standard_normal((b, v1, co)).astype(
            np.float32))
        win = DW.DwWindow.build(spiral, "cpu")
        plan = win.launch_plan(b, c, co, dtype)
        got = DW.walk_plain(x, dy, win, plan)
        ref = TC.spiral_conv_bwd_dw_plain(x, torch.from_numpy(spiral), dy)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


def test_dw_counter_equals_the_plan():
    """A conv's backward on the CPU records its dW call in
    `spiral_conv_dw` under "<B>,<V1>,<S>,<C>,<Co>:<T>", with the launch
    plan's rows and entries; a graph's record carries it."""
    from semantichuman_torch.ops import launches

    spiral = _levels()[0]
    b, c, co = 2, 32, 16
    v1, s = spiral.shape
    it = torch.from_numpy(spiral)
    win = DW.window_of(it)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((b, v1, c)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((s * c, co)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, v1, co)).astype(np.float32))
    plan = win.launch_plan(b, c, co, torch.float32)
    key = f"{b},{v1},{s},{c},{co}:{plan['t']}"
    with launches.recording("test/dw") as rec:
        TC._conv_backward(x, w, dy, it, None, False, True)
        TC._conv_backward(x, w, dy, it, None, False, True)
    assert rec["spiral_conv_dw"] == {key: {
        "calls": 2, "rows": 2 * plan["rows"],
        "entries": 2 * plan["entries"]}}
    assert launches.graph_record("test/dw")["spiral_conv_dw"] == \
        rec["spiral_conv_dw"]
    assert "spiral_conv_bwd_dw" not in rec  # no launch on the CPU


def test_window_refuses_another_table():
    """`window_of` gives a spiral tensor one plan for as long as it lives,
    and another tensor of the same shape a plan of its own, not the
    first's; building the tables builds each level's."""
    from semantichuman_torch.models.tables import device_tables
    from semantichuman_torch.topology import MeshHierarchy

    _x, idx, *_rest = _check_args()
    other = torch.roll(idx, 1, dims=0)
    win = DW.window_of(idx)
    assert DW.window_of(idx) is win
    got = DW.window_of(other)
    assert got is not win and got.spiral_shape == win.spiral_shape
    assert any(not torch.equal(p.lidx, q.lidx) or not torch.equal(p.rows,
                                                                  q.rows)
               for p, q in zip(win.plans.values(), got.plans.values()))
    tables = device_tables(MeshHierarchy.load(TOPOLOGY), "cpu")
    for spiral in tables.spirals:
        hit = DW._BUILT.get(id(spiral))
        assert hit is not None and hit[0]() is spiral


# --- the dx kernel's short-row plan (ops/dx_plan.py) ---------------------------

def _inverse(spiral):
    return inverse_spiral_csr(spiral)


@pytest.mark.parametrize("label,spiral", _tables(),
                         ids=[t[0] for t in _tables()])
def test_dx_plan_maps_back_to_the_inverse_table(label, spiral):
    """Every short row (at most LONG_ROW entries) appears once, in
    ascending order, and no long row does; each short row's packed
    entries (v << 8 | s) are its inverse-table entries v*S + s in the
    table's order; keys are the offsets plus the row index."""
    offs, cols = _inverse(spiral)
    v1, s = spiral.shape
    plan = DX.DxPlan.build(offs, cols, s, "cpu")
    deg = np.diff(offs)
    np.testing.assert_array_equal(plan.host_rows,
                                  np.nonzero(deg <= TR.LONG_ROW)[0])
    assert plan.spiral_shape == (v1, s)
    assert plan.host_roffs[0] == 0 and plan.n_entries == deg[deg <= TR.LONG_ROW].sum()
    np.testing.assert_array_equal(plan.keys.numpy(),
                                  plan.host_roffs + np.arange(plan.n_rows + 1))
    ents = plan.host_ents.astype(np.int64)
    got = (ents >> 8) * s + (ents & 255)
    for r, u in enumerate(plan.host_rows):
        lo, hi = plan.host_roffs[r], plan.host_roffs[r + 1]
        np.testing.assert_array_equal(got[lo:hi], cols[offs[u]:offs[u + 1]],
                                      err_msg=f"{label} row {u}")
    assert np.all((ents & 255) < s) and np.all(spiral[ents >> 8, ents & 255]
                                               == np.repeat(plan.host_rows,
                                                            np.diff(plan.host_roffs)))


def _warp_units(plan, lp, g, n_warps):
    """The units (batch tile, short row index) of warp g of n_warps, as
    the kernel splits them: those that start in [P g / G, P (g+1) / G) of
    the P = n_bt x (E + R) positions (`keys`: each unit weighs its entries
    and one)."""
    r_n, e_n = plan.n_rows, plan.n_entries
    total = lp["n_bt"] * (e_n + r_n)
    keys = plan.host_roffs.astype(np.int64) + np.arange(r_n + 1)

    def unit_at(p):
        bt, rem = divmod(p, e_n + r_n)
        r = int(np.searchsorted(keys[:r_n], rem, side="left"))
        return (bt + 1, 0) if r == r_n else (bt, r)

    lo, hi = unit_at(total * g // n_warps), unit_at(total * (g + 1) // n_warps)
    out = []
    while lo < hi:
        out.append(lo)
        lo = (lo[0] + 1, 0) if lo[1] + 1 == r_n else (lo[0], lo[1] + 1)
    return out


def _walk_plain(dy, w, plan, lp, long_dx):
    """dx as the kernel walks the plan, in plain PyTorch: per c-slice, per
    warp of the grid its units in order, each row's entries added in the
    plan's order from the packed (v, s); the long rows' values from
    `long_dx` (the long-row kernels' part).  Every other entry of dx
    starts NaN, so a row no warp writes shows.  dy [B, V1, Co], w [S*C,
    Co] -> [B, V1, C] float32."""
    b, v1, co = dy.shape
    s = plan.spiral_shape[1]
    c = w.shape[0] // s
    wf = w.float().reshape(s, c, co)
    out = torch.full((b, v1, c), float("nan"))
    short = np.zeros(v1, bool)
    short[plan.host_rows] = True
    out[:, ~torch.from_numpy(short)] = long_dx[:, ~torch.from_numpy(short)]
    n_warps = lp["blocks"] * lp["warps"]
    bt_n = lp["bt"]
    for sl in range(lp["slices"]):
        c0, c1 = sl * lp["cp"], min(c, (sl + 1) * lp["cp"])
        for g in range(n_warps):
            for bt, r in _warp_units(plan, lp, g, n_warps):
                b0, b1 = bt * bt_n, min(b, (bt + 1) * bt_n)
                acc = torch.zeros((b1 - b0, c1 - c0))
                for j in range(plan.host_roffs[r], plan.host_roffs[r + 1]):
                    v, slot = plan.host_ents[j] >> 8, plan.host_ents[j] & 255
                    acc += dy[b0:b1, v] @ wf[slot, c0:c1].t()
                out[b0:b1, plan.host_rows[r], c0:c1] = acc
    return out


def _other_launch(lp, b, c, ntc, warps, blocks):
    """`lp`, for B = b and C = c, with another warp tile, warps a block and
    blocks a slice: the walk's order of units and sums then changes, its
    values must not."""
    bt, cp = DX.tile_of(ntc)
    return dict(lp, ntc=ntc, warps=warps, blocks=blocks, bt=bt, cp=cp,
                n_bt=-(-b // bt), slices=-(-c // cp))


# every conv whose dx the model computes: the first conv's input is data
DX_CONVS = MODEL_CONVS[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_plan_fits_the_shared_memory_budget(dtype):
    """At every conv of the bundled topology whose dx runs, and at the
    64 -> 128 conv, at B = 17, 128, 256 and 384 (W is staged as f32 for
    either type, so the plan is the same): the launch's shared memory is
    the weight slice and the warps' rings, within one block's most; the
    widest warp tile that fits four warps; as many warps as fit, at most
    eight; the c-slices and batch tiles cover C and B; one wave of blocks
    on a card of the plan's SMs (another count of SMs changes only the
    blocks); the warps' units cover every (batch tile, short row) once;
    Co <= 4 takes the narrow kernel (no plan)."""
    levels = _levels()
    for lvl, c, co in DX_CONVS:
        spiral = levels[lvl]
        v1, s = spiral.shape
        plan = DX.DxPlan.build(*_inverse(spiral), s, "cpu")
        for b in (17, 128, 256, 384):
            lp = plan.launch_plan(b, c, co)
            if co <= 4:
                assert lp is None
                continue
            assert lp["smem"] == DX.smem_bytes(s, co, lp["ntc"],
                                               lp["warps"])
            assert lp["smem"] <= DX.SMEM_ONE
            assert DX.MIN_WARPS <= lp["warps"] <= DX.MAX_WARPS
            assert lp["warps"] == DX.max_warps(s, co, lp["ntc"])
            assert (lp["bt"], lp["cp"]) == DX.tile_of(lp["ntc"])
            assert lp["ntc"] == DX.warp_tile(c, co, s) <= DX.ntc_for(c)
            wider = [t for t in DX.NTCS if lp["ntc"] < t <= DX.ntc_for(c)]
            assert all(DX.smem_bytes(s, co, t, DX.MIN_WARPS) > DX.SMEM_ONE
                       for t in wider)
            assert lp["slices"] * lp["cp"] >= c > (lp["slices"] - 1) * lp["cp"]
            assert lp["blocks"] * lp["slices"] <= DX.SMS_NO_CARD
            assert lp["n_bt"] * lp["bt"] >= b > (lp["n_bt"] - 1) * lp["bt"]
            assert lp == DX.launch_plan(b, c, co, s, DX.SMS_NO_CARD)
            small = DX.launch_plan(b, c, co, s, 114)
            assert small["blocks"] * small["slices"] <= 114
            assert dict(small, blocks=lp["blocks"]) == lp
            if b in (17, 256):
                n_warps = lp["blocks"] * lp["warps"]
                units = [u for g in range(n_warps)
                         for u in _warp_units(plan, lp, g, n_warps)]
                assert units == [(bt, r) for bt in range(lp["n_bt"])
                                 for r in range(plan.n_rows)]


DX_WALK_CASES = [(1, 16, 32, 3), (2, 32, 64, 2), (3, 128, 64, 2),
                 (3, 64, 128, 1), (3, 64, 32, 70), (4, 5, 7, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DX_WALK_CASES, ids=str)
def test_dx_plan_walk_gives_plain_dx(case, dtype):
    """The plan walked in the kernel's order (per c-slice, per warp of the
    grid its units, each short row's entries in the plan's order, the long
    rows from the plain dx; every row starts NaN) gives
    spiral_conv_bwd_dx_plain's dx: the same products, f32 sums in another
    order (1e-5 of the largest entry); also on the level with its vertices
    permuted, and under a narrower tile of fewer warps and blocks."""
    lvl, c, co, b = case
    for spiral in (_levels()[lvl], _permuted(_levels()[lvl], 9)):
        v1, s = spiral.shape
        rng = np.random.default_rng(lvl + c + co)
        w = torch.from_numpy((rng.standard_normal((s * c, co))
                              / np.sqrt(s * c)).astype(np.float32)).to(dtype)
        dy = torch.from_numpy(rng.standard_normal((b, v1, co)).astype(
            np.float32))
        dy[:, -1] = 0.0
        table = _csr(spiral)
        ref = TC.spiral_conv_bwd_dx_plain(dy, w, table, (v1, s))
        plan = DX.DxPlan.build(*_inverse(spiral), s, "cpu")
        lp = plan.launch_plan(b, c, co)
        for launch in (lp, _other_launch(lp, b, c, 1, 4, 7),
                       _other_launch(lp, b, c, 2, 3, 114)):
            got = _walk_plain(dy, w, plan, launch, ref)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-5 * float(ref.abs().max()))


def test_dispatch_sends_a_dx_whose_slice_cannot_fit_unfused():
    """At level 0 (S = 15) a conv with Co = 256 has no weight slice that
    fits the short-row kernel: the dispatch sends its dx unfused at any
    batch, by shape, and keeps the fused dW; Co = 192 there, and Co = 256
    at S = 9, fit and stay fused; the dx wrapper's check refuses the
    shape that does not fit."""
    v1, s, c = 50, 15, 16
    assert DX.warp_tile(c, 256, s) is None
    assert DX.warp_tile(c, 192, s) is not None
    assert DX.warp_tile(c, 256, 9) is not None

    def halves(b, s, co):
        return TC._unfused_halves(
            torch.empty((b, v1, c), device="meta"),
            torch.empty((s * c, co), device="meta"),
            torch.empty((v1, s), dtype=torch.int32, device="meta"))

    for b in (17, 128, 384):
        assert halves(b, 15, 256) == ("dx",)
        assert halves(b, 15, 192) == ()
        assert halves(b, 9, 256) == ()
    assert halves(4, 15, 256) == ("dx",)
    idx = np.random.default_rng(3).integers(0, v1, (v1, s)).astype(np.int32)
    dy = torch.zeros((2, v1, 256))
    w = torch.zeros((s * c, 256))
    with pytest.raises(ValueError, match="no weight slice"):
        TC._check_bwd_dx(dy, w, _csr(idx), (v1, s))
    TC._check_bwd_dx(dy[..., :192].contiguous(), w[:, :192].contiguous(),
                     _csr(idx), (v1, s))
