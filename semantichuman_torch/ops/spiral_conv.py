"""Spiral convolution: the framework's core op (counterpart of
`semantichuman_tpu/ops/spiral_conv.py`).

    y[b, v] = act(concat_s(x[b, spiral[v, s]]) @ W + bias),  dummy row zeroed

Spiral tables arrive with pads already resolved to the dummy row index V
(topology.hierarchy), the input's dummy row is zero, and the output's dummy
row is set to exactly zero after bias and activation.

`compute_dtype` follows `spiral_conv_take`: with bfloat16, x and W are cast
BEFORE the gather; products and sums stay float32 and so does the output.

`spiral_conv` dispatches as the JAX package's does, with a batch gate
measured on the card in place of the TPU's: a level whose tables carry a
band (`models/tables.py`) takes the banded route `spiral_conv_banded` for
a CUDA tensor at batch <= `_BANDED_MAX_B` (closed: the banded route was
slower at every batch measured); every other call takes the take route through `SpiralConvFn`, an autograd
Function whose forward is the custom op `semantichuman::spiral_conv_fwd`
(`spiral_conv_fwd_op`, so that `torch.export` traces it as one node):
the hand-written kernel (`csrc/spiral_conv_fwd.cu`, counted in
`spiral_conv.launches`) for a CUDA tensor and `spiral_conv_plain` for a
CPU tensor.  The wrapper picks the kernel's tile from the shape
(`_fwd_plan`).  The port's first forward kernel
(`csrc/spiral_conv.cu`) stays as the yardstick, `spiral_conv_fwd_v1`, which
a table keyed by the conv's static shape (`_FWD_V1`, empty) would send a
shape to where the new kernel measured slower.  Its backward takes the activation's
derivative from the output and db as a plain sum; dW and dx come from the
two fused kernels of `csrc/spiral_conv_bwd.cu` (`spiral_conv_bwd_dw`,
`spiral_conv_bwd_dx`, counted in their `.launches`), which gather on chip
and write nothing of width S*C to device memory; dW reads x through the
spiral table's window plan (`ops/dw_window.py:window_of`, built with the
tables: each tile of vertices' distinct source rows staged once), dx walks
the inverse table's short-row plan (`ops/dx_plan.py:dx_plan_of`, built
with the tables: each block's slice of W resident, each warp a balanced
run of rows).  The
earlier card route, torch matmuls around the gathered buffers and the CSR
reduce (`ops/csr_reduce.py`), stays as `spiral_conv_bwd_unfused`: a table keyed
by the conv's static shape sends a shape there where the fused kernel
measured slower, and dx at batch <= 16 takes it too.  The JAX package's one-hot form is a TPU gather-engine
workaround with the take route's values and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .banded_gather import BandedGatherFn, BandTable
from .csr_reduce import LONG_ROW, CSRTable, csr_reduce, csr_reduce_plain
from .dw_window import window_of
from .dx_plan import dx_plan_of, warp_tile
from .kernels import LIB, build
from .row_gather import RowGatherFn

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

# activation codes of csrc/spiral_conv.cu and csrc/spiral_conv_fwd.cu
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


def _dy_prime(dy: torch.Tensor, y: torch.Tensor,
              activation: str) -> torch.Tensor:
    """dy * act'(y) with a zero dummy row, a new row-major tensor whatever
    layout dy arrives in.  The values of `dy * _act_grad(y, activation)`
    in fewer passes over device memory for elu (act' = min(y, 0) + 1) and
    identity."""
    if activation == "identity":
        out = dy.clone(memory_format=torch.contiguous_format)
    elif activation == "elu":
        out = torch.clamp(y, max=0.0).add_(1.0).mul_(dy)
    else:
        out = _act_grad(y, activation).mul_(dy)
    out[:, -1] = 0.0
    return out


# the banded route's batch gate, set from the card's measurements: the
# largest batch at which the banded conv beats the take route on an H100.
# It won at none (`chip_smoke.py --band-gates`: serving at B = 1, 16, 64,
# the Trainer at trunk 12 and 128, in turns; PERF.md), so it is closed.
# The JAX dispatch's gate, 16, was set on the TPU.
_BANDED_MAX_B = 0


def _banded_ok(b: int, device: torch.device) -> bool:
    """The banded route runs on the card at batch <= _BANDED_MAX_B (at no
    batch: the gate is closed); on the CPU the take route stays, as the
    JAX dispatch keeps banding off the CPU."""
    return device.type == "cuda" and b <= _BANDED_MAX_B


def spiral_gather(x: torch.Tensor, spiral_idx: torch.Tensor) -> torch.Tensor:
    """x [B, V+1, C], spiral_idx [V+1, S] -> [B, V+1, S*C]: the spiral
    neighbourhoods side by side, the reference math's gather."""
    b, _, c = x.shape
    v1, s = spiral_idx.shape
    g = x.index_select(1, spiral_idx.reshape(-1).long())
    return g.reshape(b, v1, s * c)


def spiral_conv_plain(x: torch.Tensor, spiral_idx: torch.Tensor,
                      w: torch.Tensor, bias: torch.Tensor,
                      activation: str = "elu",
                      compute_dtype=None, csr=None,
                      band=None) -> torch.Tensor:
    """The plain PyTorch version: a gather, one matmul, bias, activation.
    x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co]
    -> [B, V1, Co] float32.  `csr` and `band` are not used: autograd
    differentiates the gather itself, and the banded route computes the
    same values."""
    act = ACTIVATIONS[activation]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    b = x.shape[0]
    g = spiral_gather(x, spiral_idx)
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
    _b, v1, c = x.shape
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


def spiral_conv_fwd_v1(x: torch.Tensor, spiral_idx: torch.Tensor,
                       w: torch.Tensor, bias: torch.Tensor,
                       activation: str = "elu") -> torch.Tensor:
    """The port's first forward kernel (`csrc/spiral_conv.cu`: one batch
    element per block, 4 x 4 register tiles), kept as the yardstick of
    the current one and counted in `spiral_conv_fwd_v1.launches`.  x and w
    in the compute type; the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return spiral_conv_plain(x, spiral_idx, w, bias, activation)
    _check(x, spiral_idx, w, bias)
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = w.shape[1]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the v1 kernel's grid limit "
                         "65535")
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
    build.check(lib, rc, "spiral_conv v1 kernel launch")
    spiral_conv_fwd_v1.launches += 1
    return y


spiral_conv_fwd_v1.launches = 0

# Tiles of csrc/spiral_conv_fwd.cu: id -> (BM rows of B*V1, BN output
# channels, threads, blocks an SM its registers allow).  Per output width
# (and, at 64 outputs, input width) the candidates run from the largest
# tile down; the plan takes the first whose grid fills the card's resident
# blocks one and a half times over, else the one with the most blocks.
# Outputs of at most four channels, and of at most 16 where x's rows cannot
# go in 16-byte pieces (C = 3), take the narrow kernel: one thread per row,
# 128 a block, id -> output channels it holds.
_FWD_TILES = {0: (128, 128, 256, 2), 1: (128, 64, 128, 3),
              2: (64, 64, 256, 2), 3: (128, 32, 128, 4),
              4: (64, 32, 128, 4), 5: (128, 16, 128, 4),
              6: (64, 16, 64, 8)}
_FWD_NARROW = {7: 4, 8: 16}
_FWD_NARROW_ROWS = 128
_SMS = 132
_FWD_BK = 32
_FWD_STAGES = 2
_FWD_MAX_SMEM = 232448
_GRID_Y_MAX = 65535
_GRID_X_MAX = 2 ** 31 - 1


def _fwd_candidates(c: int, co: int) -> tuple:
    if co > 64:
        return (0, 1, 2)
    if co > 32:
        return (1, 2) if c > 32 else (2,)
    if co > 16:
        return (3, 4)
    return (5, 6)


# Static conv shapes (C, Co, S) whose forward takes the v1 kernel on the
# card: only where the card measured the current kernel slower there.
_FWD_V1 = frozenset()


def _fwd_route(c: int, co: int, s: int) -> str:
    """Which forward kernel a CUDA tensor of this static shape takes."""
    return "v1" if (c, co, s) in _FWD_V1 else "tiled"


def _fwd_plan(b: int, v1: int, c: int, s: int, co: int,
              dtype: torch.dtype, tile=None) -> dict:
    """The forward kernel's launch: tile id, its rows BM and channels BN,
    its threads and the blocks an SM its registers are set for (0: not
    set), the grid (row tiles, channel tiles) and the dynamic shared memory
    in bytes, as csrc/spiral_conv_fwd.cu computes them; the library refuses
    a plan that is not its instance's.  `tile` forces one (the card tests
    run every instance)."""
    m = b * v1
    es = 2 if dtype == torch.bfloat16 else 4
    if tile is None:
        narrow = 7 if co <= 4 else 8 if co <= 16 and (c * es) % 16 else None
        if narrow is not None and s * c * 4 * _FWD_NARROW[narrow] \
                <= _FWD_MAX_SMEM:
            tile = narrow
    if tile in _FWD_NARROW:
        bn = _FWD_NARROW[tile]
        return {"tile": tile, "bm": _FWD_NARROW_ROWS, "bn": bn,
                "threads": _FWD_NARROW_ROWS, "mb": 0,
                "grid": (-(-m // _FWD_NARROW_ROWS), 1),
                "smem": s * c * 4 * bn}
    if tile is None:
        cands = _fwd_candidates(c, co)

        def blocks(t):
            bm, bn, _nt, _mb = _FWD_TILES[t]
            return -(-m // bm) * -(-co // bn)

        tile = next((t for t in cands
                     if 2 * blocks(t) >= 3 * _SMS * _FWD_TILES[t][3]),
                    max(cands, key=blocks))
    bm, bn, nt, mb = _FWD_TILES[tile]
    stage = (bm * (_FWD_BK + 16 // es) + _FWD_BK * bn) * es
    return {"tile": tile, "bm": bm, "bn": bn, "threads": nt, "mb": mb,
            "grid": (-(-m // bm), -(-co // bn)),
            "smem": _FWD_STAGES * stage + bm * s * 4}


def _vector_ok(x, w) -> tuple:
    """(vecx, vecw): whether x's rows and W's rows go in 16-byte pieces,
    by the static shape: C, resp. Co, a multiple of 16 bytes' elements."""
    epu = 16 // x.element_size()
    return x.shape[2] % epu == 0, w.shape[1] % epu == 0


def _check_fwd(x, spiral_idx, w, bias, tile=None) -> dict:
    """Raise on anything the forward kernel does not take; returns its
    plan (`tile` as in `_fwd_plan`)."""
    _check(x, spiral_idx, w, bias)
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = w.shape[1]
    if x.numel() >= 2 ** 31 or b * v1 >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's 32-bit "
                         "offsets")
    for name, t, vec in zip(("x", "w"), (x, w), _vector_ok(x, w)):
        if vec and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             "kernel's 16-byte loads")
    plan = _fwd_plan(b, v1, c, s, co, x.dtype, tile)
    if plan["bn"] < co and plan["tile"] in _FWD_NARROW:
        raise ValueError(f"the narrow kernel {plan['tile']} holds "
                         f"{plan['bn']} outputs, not {co}")
    if plan["smem"] > _FWD_MAX_SMEM:
        raise ValueError(f"S = {s}, C = {c} need {plan['smem']} bytes of "
                         f"shared memory, more than {_FWD_MAX_SMEM}")
    gx, gy = plan["grid"]
    if gx > _GRID_X_MAX or gy > _GRID_Y_MAX:
        raise ValueError(f"grid {plan['grid']} exceeds the card's limits")
    return plan


def _forward(x, spiral_idx, w, bias, activation, tile=None) -> torch.Tensor:
    """The forward kernel on a CUDA tensor (the v1 kernel for a shape that
    `_FWD_V1` names; `tile` forces one of the kernel's tiles), the plain
    version on a CPU one; x and w arrive in the compute type."""
    if x.device.type == "cpu":
        return spiral_conv_plain(x, spiral_idx, w, bias, activation)
    if tile is None and _fwd_route(x.shape[2], w.shape[1],
                                   spiral_idx.shape[1]) == "v1":
        return spiral_conv_fwd_v1(x, spiral_idx, w, bias, activation)
    plan = _check_fwd(x, spiral_idx, w, bias, tile)
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = w.shape[1]
    y = torch.empty((b, v1, co), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    vecx, vecw = _vector_ok(x, w)
    lib = build.load("spiral_conv_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_spiral_conv_fwd_tiled(
            x.data_ptr(), spiral_idx.data_ptr(), w.data_ptr(),
            bias.data_ptr(), y.data_ptr(), b, v1, c, s, co,
            _ACT_CODES[activation], int(x.dtype == torch.bfloat16),
            plan["tile"], plan["bm"], plan["bn"], plan["smem"],
            plan["threads"], plan["mb"], int(vecx), int(vecw), stream)
    build.check(lib, rc, "spiral_conv kernel launch")
    spiral_conv.launches += 1
    return y


# The forward as the custom op `semantichuman::spiral_conv_fwd`, so that
# `torch.export` traces it as one node: its body, `_forward`, reads the
# concrete batch and the pointers (the tile plan, the alignment checks) and
# counts the launch, which a fake tensor cannot; the fake gives the
# output's shape alone.  Registered through `torch.library.Library`
# (`kernels/__init__.py:LIB`) rather than `torch.library.custom_op`, whose
# wrapper costs about four times the dispatch (PERF.md, PR 13).
LIB.define("spiral_conv_fwd(Tensor x, Tensor spiral_idx, Tensor w, "
           "Tensor bias, str activation) -> Tensor")
LIB.impl("spiral_conv_fwd",
         lambda x, spiral_idx, w, bias, activation: _forward(
             x, spiral_idx, w, bias, activation),
         "CompositeExplicitAutograd")


@torch.library.register_fake("semantichuman::spiral_conv_fwd", lib=LIB)
def _(x, spiral_idx, w, bias, activation):
    return x.new_empty((x.shape[0], spiral_idx.shape[0], w.shape[1]),
                       dtype=torch.float32)


spiral_conv_fwd_op = torch.ops.semantichuman.spiral_conv_fwd.default


# --- the backward: dW and dx -------------------------------------------------

def spiral_conv_bwd_dw_plain(x: torch.Tensor, spiral_idx: torch.Tensor,
                             dy: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of dW: gather x's rows into [B*V1, S*C],
    one matmul with dy.  x [B, V1, C] f32 or bf16, spiral_idx [V1, S],
    dy [B, V1, Co] f32 (already times act', dummy row zero) -> [S*C, Co]
    float32."""
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    g = x.index_select(1, spiral_idx.reshape(-1).long())
    g = g.reshape(b * v1, s * c).float()
    return torch.matmul(g.t(), dy.reshape(b * v1, dy.shape[2]))


def spiral_conv_bwd_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                             csr: CSRTable, spiral_shape) -> torch.Tensor:
    """The plain PyTorch version of dx: dy @ W^T as [B, V1*S, C], then the
    plain CSR reduce over the inverse spiral table.  dy [B, V1, Co] f32,
    w [S*C, Co] f32 or bf16, spiral_shape (V1, S) -> [B, V1, C] float32."""
    v1, s = spiral_shape
    b = dy.shape[0]
    c = w.shape[0] // s
    dg = torch.matmul(dy, w.float().t())                  # [B, V1, S*C]
    return csr_reduce_plain(dg.reshape(b, v1 * s, c), csr)


def spiral_conv_bwd_unfused(x, w, dy, spiral_idx, csr, need_x=True,
                            need_w=True):
    """The unfused card route, the yardstick of the fused kernels: the
    gathered [B*V1, S*C] buffer and a matmul for dW, dy @ W^T and the
    csr_reduce kernel (its plain version on the CPU) for dx.  Returns
    (dx or None, dW or None), float32."""
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    dx = dw = None
    if need_w:
        dw = spiral_conv_bwd_dw_plain(x, spiral_idx, dy)
    if need_x:
        dg = torch.matmul(dy, w.float().t())              # [B, V1, S*C]
        dx = csr_reduce(dg.reshape(b, v1 * s, c), csr)
    return dx, dw


def _check_common(dy, other, name) -> None:
    if dy.dim() != 3 or dy.dtype != torch.float32:
        raise TypeError("dy must be float32 [B, V1, Co], got "
                        f"{tuple(dy.shape)} {dy.dtype}")
    if other.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got "
                        f"{other.dtype}")
    if dy.shape[0] > 65535:
        raise ValueError(f"batch {dy.shape[0]} exceeds the grid limit 65535")


def _check_bwd_dw(x, spiral_idx, dy) -> None:
    """Raise on anything the dW kernel does not take."""
    _check_common(dy, x, "x")
    if x.dim() != 3 or spiral_idx.dim() != 2:
        raise ValueError("spiral_conv_bwd_dw expects x [B, V1, C], "
                         "spiral_idx [V1, S], dy [B, V1, Co]")
    if x.shape[:2] != dy.shape[:2] or spiral_idx.shape[0] != x.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, spiral_idx "
                         f"{tuple(spiral_idx.shape)}, dy {tuple(dy.shape)}")
    if spiral_idx.dtype != torch.int32:
        raise TypeError("spiral_idx must be int32")
    for name, t in (("x", x), ("spiral_idx", spiral_idx), ("dy", dy)):
        if t.device != dy.device:
            raise ValueError(f"{name} is on {t.device}, dy on {dy.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def spiral_conv_bwd_dw(x: torch.Tensor, spiral_idx: torch.Tensor,
                       dy: torch.Tensor) -> torch.Tensor:
    """dW[s*C + c, n] = sum_{b, v} x[b, spiral[v, s], c] * dy[b, v, n].
    x [B, V1, C] f32 or bf16, spiral_idx [V1, S] int32, dy [B, V1, Co] f32
    -> [S*C, Co] float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel through spiral_idx's window plan
    (`window_of`: the tables' are built with them, another table's on its
    first call; per-chunk partial sums into scratch, added in chunk
    order: no atomics) or raise."""
    if dy.device.type == "cpu":
        return spiral_conv_bwd_dw_plain(x, spiral_idx, dy)
    if dy.device.type != "cuda":
        raise ValueError(f"spiral_conv_bwd_dw runs on cpu or cuda, not "
                         f"{dy.device}")
    _check_bwd_dw(x, spiral_idx, dy)
    b, v1, c = x.shape
    s = spiral_idx.shape[1]
    co = dy.shape[2]
    dw = torch.empty((s * c, co), dtype=torch.float32, device=dy.device)
    if dw.numel() == 0:
        return dw
    if b * v1 == 0:
        return dw.zero_()
    window = window_of(spiral_idx)
    plan = window.launch_plan(b, c, co, x.dtype)
    if plan is None:
        raise ValueError(f"S = {s}, C = {c}: no window of 16 vertices fits "
                         "the dW kernel's shared memory")
    p = window.plans[plan["t"]]
    partial = torch.empty((plan["chunks"], s * c, co), dtype=torch.float32,
                          device=dy.device)
    lib = build.load("spiral_conv_bwd")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_spiral_conv_bwd_dw(
            x.data_ptr(), p.rows.data_ptr(), p.offs.data_ptr(),
            p.masks.data_ptr(), p.lidx.data_ptr(), dy.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), b, v1, c, s, co, p.t,
            p.max_rows, plan["shape"], plan["chunks"], plan["per_chunk"],
            plan["smem"], int(x.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "spiral_conv_bwd_dw kernel launch")
    spiral_conv_bwd_dw.launches += 1
    return dw


spiral_conv_bwd_dw.launches = 0

# the dx kernel's long-row path holds S*Co floats, and S floats per thread,
# in shared memory
_DX_MAX_S_CO = 6000
_DX_MAX_S = 128


def _check_bwd_dx(dy, w, csr, spiral_shape) -> None:
    """Raise on anything the dx kernel does not take."""
    _check_common(dy, w, "w")
    v1, s = spiral_shape
    if w.dim() != 2 or w.shape[1] != dy.shape[2] or s <= 0 \
            or w.shape[0] % s != 0:
        raise ValueError(f"shape mismatch: dy {tuple(dy.shape)}, w "
                         f"{tuple(w.shape)}, spiral shape ({v1}, {s})")
    if dy.shape[1] != v1 or csr.n_rows != v1 or csr.n_src != v1 * s:
        raise ValueError(
            f"the inverse table has {csr.n_rows} rows over {csr.n_src} "
            f"entries, dy {tuple(dy.shape)} and the spiral shape "
            f"({v1}, {s}) need {v1} over {v1 * s}")
    if s * dy.shape[2] > _DX_MAX_S_CO or s > _DX_MAX_S:
        raise ValueError(f"S = {s}, S*Co = {s * dy.shape[2]} exceed the "
                         f"kernel's long-row scratch ({_DX_MAX_S}, "
                         f"{_DX_MAX_S_CO})")
    if dy.shape[2] <= 4 and 16 * s * (w.shape[0] // s + 1) > 200 * 1024:
        raise ValueError(f"w {tuple(w.shape)} exceeds the narrow-output "
                         "kernel's shared memory")
    co = dy.shape[2]
    if co > 4 and warp_tile(w.shape[0] // s, co, s) is None:
        raise ValueError(f"S = {s}, Co = {co}: no weight slice "
                         "fits the short-row kernel's shared memory (the "
                         "dispatch sends such a dx unfused)")
    for name, t in (("w", w), ("table", csr.offs), ("dy", dy)):
        if t.device != dy.device:
            raise ValueError(f"{name} is on {t.device}, dy on {dy.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def spiral_conv_bwd_dx(dy: torch.Tensor, w: torch.Tensor, csr: CSRTable,
                       spiral_shape) -> torch.Tensor:
    """dx[b, u, c] = sum over the entries j = v*S + s of row u of the
    inverse table `csr` of sum_n dy[b, v, n] * W[s*C + c, n].
    dy [B, V1, Co] f32, w [S*C, Co] f32 or bf16, spiral_shape (V1, S)
    -> [B, V1, C] float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernels through the table's short-row plan
    (`dx_plan_of`: the tables' are built with them, another table's on
    its first call; every sum in a fixed order, no atomics) or raise."""
    if dy.device.type == "cpu":
        return spiral_conv_bwd_dx_plain(dy, w, csr, spiral_shape)
    if dy.device.type != "cuda":
        raise ValueError(f"spiral_conv_bwd_dx runs on cpu or cuda, not "
                         f"{dy.device}")
    _check_bwd_dx(dy, w, csr, spiral_shape)
    v1, s = spiral_shape
    b, _, co = dy.shape
    c = w.shape[0] // s
    dx = torch.empty((b, v1, c), dtype=torch.float32, device=dy.device)
    if dx.numel() == 0:
        return dx
    if co == 0:
        return dx.zero_()
    plan = dx_plan_of(csr)
    lp = plan.launch_plan(b, c, co) or {"ntc": 0, "warps": 0, "blocks": 0,
                                        "smem": 0}
    n_chunks = csr.chunk_lo.shape[0]
    partial = torch.empty((max(n_chunks, 1), b, s * co),
                          dtype=torch.float32, device=dy.device)
    lib = build.load("spiral_conv_bwd")
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sh_spiral_conv_bwd_dx(
            dy.data_ptr(), w.data_ptr(), csr.offs.data_ptr(),
            csr.cols.data_ptr(), csr.chunk_lo.data_ptr(),
            csr.chunk_hi.data_ptr(), csr.long_rows.data_ptr(),
            csr.chunk_offs.data_ptr(), partial.data_ptr(), dx.data_ptr(),
            plan.rows.data_ptr(), plan.keys.data_ptr(),
            plan.roffs.data_ptr(), plan.ents.data_ptr(),
            b, v1, c, s, co, LONG_ROW, csr.long_rows.shape[0], n_chunks,
            int(w.dtype == torch.bfloat16), plan.n_rows, plan.n_entries,
            lp["ntc"], lp["warps"], lp["blocks"], lp["smem"],
            stream)
    build.check(lib, rc, "spiral_conv_bwd_dx kernel launch")
    spiral_conv_bwd_dx.launches += 1
    return dx


spiral_conv_bwd_dx.launches = 0

# Static conv shapes (C, Co, S) whose backward, or one half of it, takes
# the unfused route on the card: the halves named here ("dx", "dw")
# measured slower fused than unfused at trunk batch 384 (chip_smoke.py's
# conv-backward phase; the per-shape times are in PERF.md, section 6).
# Every shape not named here runs both fused kernels, but a dx whose
# short-row weight slice cannot fit (`dx_plan.warp_tile` None: Co above
# about 192 at S = 15, for one).  The one dx half below is the 64 -> 128 conv's at level 3: its 128 output channels make
# the short-row kernel's resident weight slice 135 KB for 32 channels, and
# it measured slower fused than unfused at trunk 128, though faster at 256
# and 384 (PERF.md, section 6).
_UNFUSED = {
    (64, 128, 8): ("dx",),
}
# At batch <= 16 the dx half takes the unfused route whatever the shape:
# the fused dx kernel's warp tile spans at least 8 * (32 / NTC) batch
# elements, so twelve leave most of it empty, and it measured slower than
# its plain version at the Trainer's batch 12 (PERF.md, section 5).
_DX_FUSED_MIN_B = 17


def _unfused_halves(x, w, spiral_idx) -> tuple:
    """The halves of this conv's backward that take the unfused route:
    none on the CPU (the plain versions run there), else what `_UNFUSED`
    names for the static shape (C, Co, S), dx at batch <= 16, and dx where
    Co > 4 and no short-row weight slice fits the shared memory."""
    if x.device.type == "cpu":
        return ()
    c, co, s = x.shape[2], w.shape[1], spiral_idx.shape[1]
    halves = _UNFUSED.get((c, co, s), ())
    if "dx" not in halves and (x.shape[0] < _DX_FUSED_MIN_B or (
            co > 4 and warp_tile(c, co, s) is None)):
        halves = ("dx",) + halves
    return halves


# The conv backward's dx calls by route and shape, as `_conv_backward`
# took them: "<route>:<B>,<V1>,<S>,<C_in>,<C_out>" -> calls, the route
# "unfused" (`spiral_conv_bwd_unfused`), "fused" (the dx kernel) or "plain"
# (its plain version, on the CPU).  Read as `spiral_conv_dx` by
# `ops/launches.py`, and carried in a captured graph's record like every
# launch counter.
DX_CALLS: dict = {}


def _count_dx(x, w, dy, spiral_idx, unfused) -> None:
    route = ("unfused" if "dx" in unfused
             else "plain" if dy.device.type == "cpu" else "fused")
    b, v1, c = x.shape
    key = f"{route}:{b},{v1},{spiral_idx.shape[1]},{c},{w.shape[1]}"
    DX_CALLS[key] = DX_CALLS.get(key, 0) + 1


# The conv backward's fused dW calls by shape and window tile:
# "<B>,<V1>,<S>,<C_in>,<C_out>:<T>" -> {"calls": n, "rows": x rows the
# window copies, "entries": spiral entries read from it}, rows and entries
# summed over the calls (each call's are the launch plan's, on the CPU
# too, where the plain version runs).  entries / rows is how many reads of
# a gathered row from L2 one staged row replaces.  Read as
# `spiral_conv_dw` by `ops/launches.py` and carried in a captured graph's
# record like every launch counter.
DW_CALLS: dict = {}


def _count_dw(x, dy, spiral_idx) -> None:
    b, v1, c = x.shape
    co = dy.shape[2]
    if b * v1 * c * co == 0:
        return
    plan = window_of(spiral_idx).launch_plan(b, c, co, x.dtype)
    if plan is None:  # the kernel refuses the shape
        return
    key = f"{b},{v1},{spiral_idx.shape[1]},{c},{co}:{plan['t']}"
    n = DW_CALLS.setdefault(key, {"calls": 0, "rows": 0, "entries": 0})
    n["calls"] += 1
    n["rows"] += plan["rows"]
    n["entries"] += plan["entries"]


def _conv_backward(x, w, dy, spiral_idx, csr, need_x, need_w, unfused=()):
    """(dx, dW) in float32 for dy already times act' with a zero dummy
    row: the halves named in `unfused` ("dx", "dw") through
    `spiral_conv_bwd_unfused`, the others through the fused wrappers
    (kernels on the card, their plain versions on the CPU).  Each dx is
    counted in DX_CALLS by its route, each fused dW in DW_CALLS."""
    if need_x:
        _count_dx(x, w, dy, spiral_idx, unfused)
    dx, dw = spiral_conv_bwd_unfused(
        x, w, dy, spiral_idx, csr, need_x and "dx" in unfused,
        need_w and "dw" in unfused)
    if need_w and dw is None:
        _count_dw(x, dy, spiral_idx)
        dw = spiral_conv_bwd_dw(x, spiral_idx, dy)
    if need_x and dx is None:
        dx = spiral_conv_bwd_dx(dy, w, csr, tuple(spiral_idx.shape))
    return dx, dw


class SpiralConvFn(torch.autograd.Function):
    """y = act(gather(x) @ W + bias), dummy row 0, with the backward

        dy' = dy * act'(y), dummy row 0     db = sum dy'
        dW  = gather(x)^T dy'               dx = csr_reduce(dy' W^T)

    x and W arrive in the compute type; their gradients are computed in
    float32 and returned in that type, so a bf16 cast in front of the
    Function turns them back into float32, as JAX's astype VJP does."""

    @staticmethod
    def forward(ctx, x, w, bias, spiral_idx, csr, activation):
        y = spiral_conv_fwd_op(x, spiral_idx, w, bias, activation)
        ctx.save_for_backward(x, w, y)
        ctx.spiral_idx, ctx.csr, ctx.activation = spiral_idx, csr, activation
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = _dy_prime(dy, y, ctx.activation)
        db = dy.sum(dim=(0, 1)) if need_b else None
        dx, dw = _conv_backward(x, w, dy, ctx.spiral_idx, ctx.csr, need_x,
                                need_w, _unfused_halves(x, w, ctx.spiral_idx))
        if dx is not None:
            dx = dx.to(x.dtype)
        if dw is not None:
            dw = dw.to(w.dtype)
        return dx, dw, db, None, None, None


def spiral_conv_banded(x: torch.Tensor, spiral_idx: torch.Tensor,
                       band: BandTable, w: torch.Tensor, bias: torch.Tensor,
                       activation: str = "elu",
                       compute_dtype=None) -> torch.Tensor:
    """The banded route (counterpart of JAX `spiral_conv_banded_pallas`):
    pack x as [V1, B*C], gather the in-band entries with the banded-gather
    kernels, add the out-of-band fix-up rows through the row-gather kernel,
    then one matmul with W, bias, activation and a zero dummy row.  Same
    values as the take route: every gathered row is one copied source row,
    and dummy pads out of the window read the zero dummy row either way."""
    act = ACTIVATIONS[activation]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    b, _, c = x.shape
    v1, s = spiral_idx.shape
    xp = x.transpose(0, 1).reshape(v1, b * c).contiguous()
    g = BandedGatherFn.apply(xp, band)                  # [V1*S, B*C]
    if band.fix is not None:
        # the banded gather wrote 0 at every out-of-band row, so the fix-up
        # puts (no atomics) where the JAX form adds
        g = g.index_put((band.fix_pos,), RowGatherFn.apply(xp, band.fix))
    g = g.reshape(v1, s, b, c).permute(2, 0, 1, 3).reshape(b, v1, s * c)
    y = act(torch.matmul(g.float(), w.float()) + bias.float())
    return torch.cat([y[:, :-1], y.new_zeros((b, 1, y.shape[2]))], dim=1)


def spiral_conv(x: torch.Tensor, spiral_idx: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor, activation: str = "elu",
                compute_dtype=None, csr=None, band=None) -> torch.Tensor:
    """x [B, V1, C], spiral_idx [V1, S] int32, w [S*C, Co], bias [Co] float32
    -> [B, V1, Co] float32.  `csr` (a CSRTable, the inverse of spiral_idx)
    is needed only when x's gradient is; `band` (a BandTable, or None) is
    the level's band.  CPU tensors take the plain versions of the kernels;
    CUDA tensors launch them or raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spiral_conv runs on cpu or cuda, not {x.device}")
    if band is not None and _banded_ok(x.shape[0], x.device):
        return spiral_conv_banded(x, spiral_idx, band, w, bias, activation,
                                  compute_dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if csr is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("spiral_conv: x needs a gradient, which needs the "
                         "inverse spiral table (csr=)")
    return SpiralConvFn.apply(x, w, bias, spiral_idx, csr, activation)


spiral_conv.launches = 0
