"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

On a host without a card every test skips; chip_smoke.py holds the kernels
at the full serving shapes.
"""

import numpy as np
import pytest
import torch

from semantichuman_torch.ops import spiral_conv as TC

# (b, v1, s, c, co): small and ragged shapes, then a coarse and the last
# full-width serving conv
SHAPES = [(2, 40, 6, 8, 16), (3, 50, 9, 3, 3), (4, 863, 8, 64, 128),
          (2, 6893, 15, 16, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(shape, device, seed=3):
    b, v1, s, c, co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v1, c)).astype(np.float32)
    x[:, -1] = 0.0
    idx = rng.integers(0, v1, (v1, s)).astype(np.int32)
    idx[-1] = v1 - 1
    w = (rng.standard_normal((s * c, co)) / np.sqrt(s * c)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, idx, w, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("activation",
                         ["elu", "relu", "leaky_relu", "sigmoid", "tanh",
                          "identity"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_spiral_conv_kernel_matches_plain(cuda, shape, dtype, activation):
    """Same products, f32 sums in another order (rtol 1e-4, atol 1e-5);
    the dummy row is exactly zero and each call is one counted launch."""
    args = _case(shape, cuda)
    before = TC.spiral_conv.launches
    got = TC.spiral_conv(*args, activation, compute_dtype=dtype)
    ref = TC.spiral_conv_plain(*args, activation, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert TC.spiral_conv.launches == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    assert torch.count_nonzero(got[:, -1]) == 0


@pytest.mark.cuda
def test_spiral_conv_kernel_rejects_bad_input(cuda):
    x, idx, w, bias = _case(SHAPES[0], cuda)
    with pytest.raises(TypeError):
        TC.spiral_conv(x, idx.long(), w, bias)
    with pytest.raises(ValueError):
        TC.spiral_conv(x, idx, w, bias.cpu())
