"""The two kernels on the serving path as `torch.library` custom ops:
`semantichuman::spiral_conv_fwd` (row 1's forward) and
`semantichuman::gather_rows` (row 7).  `torch.library.opcheck` holds the
CPU implementation (the plain versions) and the fake (shapes alone) to
the op's schema at small shapes; training and serving reach the kernels
through the ops.  tests/test_torch_kernels_cuda.py runs the same checks on
the card."""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from semantichuman_torch.models.tables import inverse_spiral_csr
from semantichuman_torch.ops import row_gather as RG
from semantichuman_torch.ops.csr_reduce import CSRTable

# the module: `semantichuman_torch.ops.spiral_conv` is the function
SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")

torch.set_num_threads(1)


def _conv_case(b, v1, s, c, co, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0
    idx = rng.integers(0, v1, (v1, s)).astype(np.int32)
    w = (rng.standard_normal((s * c, co)) / np.sqrt(s * c)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    x, idx, w, bias = (torch.from_numpy(a) for a in (x, idx, w, bias))
    return x.to(dtype), idx, w.to(dtype), bias


@pytest.mark.parametrize("activation", ["elu", "identity", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 12, 5, 3, 8), (3, 20, 9, 8, 3)])
def test_spiral_conv_op_passes_opcheck(shape, dtype, activation):
    args = _conv_case(*shape, dtype)
    torch.library.opcheck(SC.spiral_conv_fwd_op, (*args, activation))
    got = SC.spiral_conv_fwd_op(*args, activation)
    assert torch.equal(got, SC.spiral_conv_plain(*args, activation))


def _gather_case(b, n, c, taps, weighted, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    r = 7
    idx = rng.integers(0, n, (r, taps) if taps > 1 else (r,))
    w = (rng.uniform(size=idx.shape).astype(np.float32) if weighted
         else None)
    table = RG.GatherTable.build(idx, n, "cpu", w=w)
    return x.to(dtype), table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("taps, weighted", [(1, False), (1, True),
                                            (3, True)])
@pytest.mark.parametrize("b", [1, 4])
def test_gather_rows_op_passes_opcheck(b, taps, weighted, dtype):
    x, table = _gather_case(b, 11, 6, taps, weighted, dtype)
    torch.library.opcheck(RG.gather_rows_op, (x, table.idx, table.w))
    got = RG.gather_rows_op(x, table.idx, table.w)
    assert torch.equal(got, RG.gather_rows_plain(x, table.idx, table.w))


def test_fakes_give_the_shapes_and_count_nothing():
    """The fakes return the outputs' shapes and types without running the
    kernels' wrappers: a traced call adds no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, idx, w, bias = _conv_case(2, 20, 9, 8, 3, torch.bfloat16)
    xg, table = _gather_case(2, 11, 6, 3, True, torch.float32)
    before = (SC.spiral_conv.launches, RG.row_gather.launches)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        y = SC.spiral_conv_fwd_op(mode.from_tensor(x), idx, w, bias, "elu")
        g = RG.gather_rows_op(mode.from_tensor(xg), table.idx, table.w)
    assert (tuple(y.shape), y.dtype) == ((2, 20, 3), torch.float32)
    assert (tuple(g.shape), g.dtype) == ((2, 7, 6), torch.float32)
    assert (SC.spiral_conv.launches, RG.row_gather.launches) == before


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_training_reaches_the_kernels_through_the_ops():
    """The autograd Functions of the training path (SpiralConvFn,
    GatherRowsFn) call the ops in their forward: a conv with a gradient
    dispatches one spiral_conv_fwd, a gather one gather_rows, and the
    gradients are the plain version's."""
    x, idx, w, bias = _conv_case(2, 20, 5, 4, 6, torch.float32)
    inv = CSRTable.build(*inverse_spiral_csr(idx.numpy()),
                         n_src=idx.numel(), device="cpu")
    table = RG.GatherTable.build([0, 3, 3, 19], 20, "cpu")
    xg = x.clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    with _OpCounter() as ops:
        y = SC.spiral_conv(xg, idx, wg, bias, "elu", csr=inv)
        out = RG.gather_rows(y, table)
        out.square().sum().backward()
    assert ops.counts.get("semantichuman.spiral_conv_fwd") == 1
    assert ops.counts.get("semantichuman.gather_rows") == 1
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    yr = SC.spiral_conv_plain(xr, idx, wr, bias, "elu")
    yr.index_select(1, table.idx.long()).square().sum().backward()
    torch.testing.assert_close(xg.grad, xr.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wg.grad, wr.grad, rtol=1e-5, atol=1e-6)
