"""Port trunk ops against the JAX package: the spiral conv's plain version
against `spiral_conv_take` and the interpret-mode Pallas kernel, pool and
unpool against their take forms.  The CUDA kernel against the plain version
is in test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantichuman_torch.models.tables import device_tables
from semantichuman_torch.ops import sampling as TS
from semantichuman_torch.ops import spiral_conv as TC
from semantichuman_torch.topology import MeshHierarchy
from semantichuman_tpu.ops import sampling as JS
from semantichuman_tpu.ops.pallas.spiral_conv_pallas import spiral_conv_fused
from semantichuman_tpu.ops.spiral_conv import spiral_conv_take

torch.set_num_threads(1)

# (b, v1, s, c, co): the test_pallas.py shape, and a ragged one with the
# 3-channel input and output widths of the model's first and last convs
SHAPES = [(2, 40, 6, 8, 16), (3, 50, 9, 3, 3)]


def _case(shape, seed=0):
    b, v1, s, c, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0                                    # dummy row
    idx = rng.integers(0, v1, (v1, s)).astype(np.int32)
    idx[-1] = v1 - 1                                  # dummy spiral
    w = (rng.standard_normal((s * c, co)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, idx, w, bias


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("activation",
                         ["elu", "relu", "leaky_relu", "identity"])
def test_plain_matches_take_and_fused(shape, activation):
    """f32: the plain version equals spiral_conv_take and the Pallas kernel
    in interpret mode to f32 summation order (atol 1e-5)."""
    x, idx, w, bias = _case(shape)
    got = TC.spiral_conv_plain(*_torch(x, idx, w, bias), activation).numpy()
    take = np.asarray(spiral_conv_take(*_jax(x, idx, w, bias), activation))
    fused = np.asarray(spiral_conv_fused(*_jax(x, idx, w, bias), activation,
                                         interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, take, atol=1e-5)
    np.testing.assert_allclose(got, fused, atol=1e-5)
    np.testing.assert_array_equal(got[:, -1], 0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_matches_take_bf16(shape):
    """compute_dtype=bfloat16 casts x and W before the gather and keeps an
    f32 result; both sides round the same inputs, so the tolerance only
    covers bf16 rounding of values that sit on a rounding edge."""
    x, idx, w, bias = _case(shape, seed=1)
    got = TC.spiral_conv_plain(*_torch(x, idx, w, bias), "elu",
                               compute_dtype=torch.bfloat16).numpy()
    ref = np.asarray(spiral_conv_take(*_jax(x, idx, w, bias), "elu",
                                      compute_dtype=jnp.bfloat16))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)
    np.testing.assert_array_equal(got[:, -1], 0.0)


def test_wrapper_takes_plain_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x, idx, w, bias = _case(SHAPES[0])
    before = TC.spiral_conv.launches
    got = TC.spiral_conv(*_torch(x, idx, w, bias), "elu")
    ref = TC.spiral_conv_plain(*_torch(x, idx, w, bias), "elu")
    assert torch.equal(got, ref)
    assert TC.spiral_conv.launches == before


def _bad_inputs():
    x, idx, w, bias = _torch(*_case(SHAPES[0]))
    return {
        "spiral_int64": (x, idx.long(), w, bias),
        "x_float64": (x.double(), idx, w.double(), bias),
        "w_dtype_differs": (x, idx, w.bfloat16(), bias),
        "bias_bf16": (x, idx, w, bias.bfloat16()),
        "x_not_contiguous": (x.transpose(0, 1).contiguous().transpose(0, 1),
                             idx, w, bias),
        "w_rows_wrong": (x, idx, w[:-1], bias),
        "spiral_rows_wrong": (x, idx[:-1], w, bias),
        "bias_wrong": (x, idx, w, bias[:-1]),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_kernel_checks_reject(case):
    """The CUDA wrapper's checks raise on what the kernel does not take."""
    with pytest.raises((TypeError, ValueError)):
        TC._check(*_bad_inputs()[case])


def test_wrapper_rejects_other_devices():
    x, idx, w, bias = _torch(*_case(SHAPES[0]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        TC.spiral_conv(x.to("meta"), idx, w, bias)


@pytest.fixture(scope="module")
def hier_pair(small_hierarchy, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_topo") / "hier.npz"
    small_hierarchy.save(str(path))
    return small_hierarchy, MeshHierarchy.load(str(path))


def test_pool_unpool_match_jax(hier_pair):
    """pool/unpool against pool_take/unpool_take on every level of the
    small hierarchy (atol 1e-6: unpool sums 3 products in another order)."""
    jh, th = hier_pair
    tables = device_tables(th, "cpu")
    rng = np.random.default_rng(2)
    for l in range(th.n_levels - 1):
        xf = rng.standard_normal((2, th.sizes[l] + 1, 5)).astype(np.float32)
        xc = rng.standard_normal((2, th.sizes[l + 1] + 1, 5)).astype(
            np.float32)
        got_p = TS.pool(torch.from_numpy(xf), tables.pool_idx[l]).numpy()
        ref_p = np.asarray(JS.pool_take(jnp.asarray(xf),
                                        jnp.asarray(jh.pool_idx[l])))
        np.testing.assert_allclose(got_p, ref_p, atol=1e-6)
        got_u = TS.unpool(torch.from_numpy(xc), tables.unpool_idx[l],
                          tables.unpool_w[l]).numpy()
        ref_u = np.asarray(JS.unpool_take(jnp.asarray(xc),
                                          jnp.asarray(jh.unpool_idx[l]),
                                          jnp.asarray(jh.unpool_w[l])))
        np.testing.assert_allclose(got_u, ref_u, atol=1e-6)


def test_tables_reject_out_of_range(hier_pair):
    """The kernel trusts its spiral table, so building tables range-checks
    every index on the host."""
    import dataclasses
    _jh, th = hier_pair
    bad = [s.copy() for s in th.spirals]
    bad[1][0, 0] = th.sizes[1] + 1
    with pytest.raises(ValueError, match="spirals\\[1\\]"):
        device_tables(dataclasses.replace(th, spirals=bad), "cpu")
