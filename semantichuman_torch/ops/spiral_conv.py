"""Spiral convolution: the framework's core op (counterpart of
`semantichuman_tpu/ops/spiral_conv.py`).

    y[b, v] = act(concat_s(x[b, spiral[v, s]]) @ W + bias),  dummy row zeroed

Spiral tables arrive with pads already resolved to the dummy row index V
(topology.hierarchy), the input's dummy row is zero, and the output's dummy
row is set to exactly zero after bias and activation.

`compute_dtype` follows `spiral_conv_take`: with bfloat16, x and W are cast
BEFORE the gather; products and sums stay float32 and so does the output.

`spiral_conv` is the dispatching wrapper: for a CUDA tensor it launches the
hand-written kernel (`csrc/spiral_conv.cu`) and counts the launch in
`spiral_conv.launches`; for a CPU tensor it runs `spiral_conv_plain`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import build

ACTIVATIONS = {
    "relu": torch.relu,
    # expm1-based like jax.nn.elu
    "elu": lambda v: torch.where(v > 0, v,
                                 torch.expm1(torch.clamp(v, max=0.0))),
    "leaky_relu": lambda v: F.leaky_relu(v, negative_slope=0.02),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda v: v,
}

# activation codes of csrc/spiral_conv.cu
_ACT_CODES = {"identity": 0, "elu": 1, "relu": 2, "leaky_relu": 3,
              "sigmoid": 4, "tanh": 5}


def spiral_conv_plain(x: torch.Tensor, spiral_idx: torch.Tensor,
                      w: torch.Tensor, bias: torch.Tensor,
                      activation: str = "elu",
                      compute_dtype=None) -> torch.Tensor:
    """The plain PyTorch version: a gather, one matmul, bias, activation.
    x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co]
    -> [B, V1, Co] float32."""
    act = ACTIVATIONS[activation]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    b, _, c = x.shape
    v1, s = spiral_idx.shape
    g = x.index_select(1, spiral_idx.reshape(-1).long()).reshape(b, v1, s * c)
    # a product of two bf16 values is exact in f32: upcasting after the
    # gather keeps the f32 accumulation of the reference
    y = torch.matmul(g.float(), w.float())
    y = act(y + bias.float())
    y[:, -1] = 0.0
    return y


def _check(x, spiral_idx, w, bias) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 3 or spiral_idx.dim() != 2 or w.dim() != 2 \
            or bias.dim() != 1:
        raise ValueError("spiral_conv expects x [B, V1, C], spiral_idx "
                         "[V1, S], w [S*C, Co], bias [Co]")
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = w.shape[1]
    if spiral_idx.shape[0] != v1 or w.shape[0] != s * c \
            or bias.shape[0] != co:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, spiral_idx "
            f"{tuple(spiral_idx.shape)}, w {tuple(w.shape)}, bias "
            f"{tuple(bias.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    if spiral_idx.dtype != torch.int32 or bias.dtype != torch.float32:
        raise TypeError("spiral_idx must be int32 and bias float32")
    for name, t in (("x", x), ("spiral_idx", spiral_idx), ("w", w),
                    ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit 65535")


def spiral_conv(x: torch.Tensor, spiral_idx: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor, activation: str = "elu",
                compute_dtype=None) -> torch.Tensor:
    """x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co] float32
    -> [B, V1, Co] float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return spiral_conv_plain(x, spiral_idx, w, bias, activation,
                                 compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"spiral_conv runs on cpu or cuda, not {x.device}")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    _check(x, spiral_idx, w, bias)
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = w.shape[1]
    y = torch.empty((b, v1, co), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.load("spiral_conv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_spiral_conv_fwd(
            x.data_ptr(), spiral_idx.data_ptr(), w.data_ptr(),
            bias.data_ptr(), y.data_ptr(), b, v1, c, s, co,
            _ACT_CODES[activation], int(x.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "spiral_conv kernel launch")
    spiral_conv.launches += 1
    return y


spiral_conv.launches = 0
