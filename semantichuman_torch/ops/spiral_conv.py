"""Spiral convolution: the framework's core op (counterpart of
`semantichuman_tpu/ops/spiral_conv.py`).

    y[b, v] = act(concat_s(x[b, spiral[v, s]]) @ W + bias),  dummy row zeroed

Spiral tables arrive with pads already resolved to the dummy row index V
(topology.hierarchy), the input's dummy row is zero, and the output's dummy
row is set to exactly zero after bias and activation.

`compute_dtype` follows `spiral_conv_take`: with bfloat16, x and W are cast
BEFORE the gather; products and sums stay float32 and so does the output.

`spiral_conv` runs through `SpiralConvFn`, an autograd Function whose
forward is the hand-written kernel (`csrc/spiral_conv.cu`, counted in
`spiral_conv.launches`) for a CUDA tensor and `spiral_conv_plain` for a
CPU tensor.  Its backward takes the activation's derivative from the
output, dW and db as plain matmul and sum, and dx as the CSR reduce over
the inverse spiral table (`ops/csr_reduce.py`, a kernel on CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .csr_reduce import csr_reduce
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


def _act_grad(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The activation's derivative, from its output y."""
    if activation == "elu":
        return torch.where(y > 0, torch.ones_like(y), y + 1.0)
    if activation == "relu":
        return (y > 0).to(y.dtype)
    if activation == "leaky_relu":
        return torch.where(y >= 0, torch.ones_like(y),
                           torch.full_like(y, 0.02))
    if activation == "sigmoid":
        return y * (1.0 - y)
    if activation == "tanh":
        return 1.0 - y * y
    if activation == "identity":
        return torch.ones_like(y)
    raise ValueError(f"unknown activation {activation!r}")


def spiral_conv_plain(x: torch.Tensor, spiral_idx: torch.Tensor,
                      w: torch.Tensor, bias: torch.Tensor,
                      activation: str = "elu",
                      compute_dtype=None, csr=None) -> torch.Tensor:
    """The plain PyTorch version: a gather, one matmul, bias, activation.
    x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co]
    -> [B, V1, Co] float32.  `csr` is not used: autograd differentiates
    the gather itself."""
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
    # out of place, so that autograd can differentiate the plain version
    return torch.cat([y[:, :-1], y.new_zeros((b, 1, y.shape[2]))], dim=1)


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


def _forward(x, spiral_idx, w, bias, activation) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, the plain version on a CPU one;
    x and w arrive in the compute type."""
    if x.device.type == "cpu":
        return spiral_conv_plain(x, spiral_idx, w, bias, activation)
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


class SpiralConvFn(torch.autograd.Function):
    """y = act(gather(x) @ W + bias), dummy row 0, with the backward

        dy' = dy * act'(y), dummy row 0     db = sum dy'
        dW  = gather(x)^T dy'               dx = csr_reduce(dy' W^T)

    x and W arrive in the compute type; their gradients are computed in
    float32 and returned in that type, so a bf16 cast in front of the
    Function turns them back into float32, as JAX's astype VJP does."""

    @staticmethod
    def forward(ctx, x, w, bias, spiral_idx, csr, activation):
        y = _forward(x, spiral_idx, w, bias, activation)
        ctx.save_for_backward(x, w, y)
        ctx.spiral_idx, ctx.csr, ctx.activation = spiral_idx, csr, activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy * _act_grad(y, ctx.activation)
        dy[:, -1] = 0.0
        b, v1, c = x.shape
        s = ctx.spiral_idx.shape[1]
        co = w.shape[1]
        dx = dw = db = None
        if need_b:
            db = dy.sum(dim=(0, 1))
        if need_w:
            g = x.index_select(1, ctx.spiral_idx.reshape(-1).long())
            g = g.reshape(b * v1, s * c).float()
            dw = torch.matmul(g.t(), dy.reshape(b * v1, co)).to(w.dtype)
        if need_x:
            dg = torch.matmul(dy, w.float().t())          # [B, V1, S*C]
            dx = csr_reduce(dg.reshape(b, v1 * s, c), ctx.csr).to(x.dtype)
        return dx, dw, db, None, None, None


def spiral_conv(x: torch.Tensor, spiral_idx: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor, activation: str = "elu",
                compute_dtype=None, csr=None) -> torch.Tensor:
    """x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co] float32
    -> [B, V1, Co] float32.  `csr` (a CSRTable, the inverse of spiral_idx)
    is needed only when x's gradient is.  CPU tensors take the plain
    versions of the kernels; CUDA tensors launch them or raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spiral_conv runs on cpu or cuda, not {x.device}")
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if csr is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("spiral_conv: x needs a gradient, which needs the "
                         "inverse spiral table (csr=)")
    return SpiralConvFn.apply(x, w, bias, spiral_idx, csr, activation)


spiral_conv.launches = 0
