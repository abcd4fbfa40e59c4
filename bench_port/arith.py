"""The yardstick's arithmetic: the card's published peaks, the least time
of a kernel's call from the operations and bytes its shapes need, and the
model FLOPs of a training step and of a served request.

The kernel bounds follow the roofline rule: each input byte read once and
each output byte written once, whatever the kernel reads again; the least
time is the larger of operations over the peak FLOP/s and bytes over the
peak bandwidth.  Times are in milliseconds.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, published dense peaks: float32 on the CUDA cores (no
# TF32), bf16 on the tensor cores, HBM3 bandwidth; special-function results
# (square root, reciprocal, acos's core) at 16 a clock an SM, 132 SMs,
# 1.98 GHz
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9


def _es(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def conv_fwd_bound(b, v1, s, cin, cout, dtype="float32"):
    """(ms for the operations, ms for the bytes) of one spiral conv's
    forward: x, W, the spiral table and bias read once, y written once."""
    es = _es(dtype)
    flops = 2 * b * v1 * s * cin * cout
    nbytes = (b * v1 * cin * es + s * cin * cout * es + v1 * s * 4
              + cout * 4 + b * v1 * cout * 4)
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def conv_bwd_bound(b, v1, s, cin, cout, dtype="float32", dx=True):
    """(ms, ms) of one conv's backward: the dW product and, with dx, the dx
    product (2*B*V1*S*C_in*C_out each); x, y, dy, W and the tables read
    once, dW, db and, with dx, dx written once."""
    es = _es(dtype)
    flops = (4 if dx else 2) * b * v1 * s * cin * cout
    nbytes = (b * v1 * cin * es + 2 * b * v1 * cout * 4 + s * cin * cout * 4
              + v1 * s * 4 + cout * 4)
    if dx:
        nbytes += s * cin * cout * es + v1 * s * 4 + b * v1 * cin * 4
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def gather_bound_ms(idx, b: int, c: int, es: int = 4,
                    weighted: bool = False) -> float:
    """Row gather y[b, r] = sum_t w[r, t] x[b, idx[r, t]]: each distinct
    source row read once, each output row written once, the index and
    weights read once."""
    idx = np.asarray(idx)
    n_rows = idx.shape[0]
    taps = 1 if idx.ndim == 1 else idx.shape[1]
    n_read = len(np.unique(idx))
    nbytes = (b * (n_read + n_rows) * c * es
              + n_rows * taps * 4 * (2 if weighted else 1))
    return nbytes / PEAK_BYTES * 1e3


def csr_bound_ms(n_rows: int, cols, b: int, c: int,
                 weighted: bool = False) -> float:
    """CSR reduce out[b, u] = sum_k w_k g[b, cols_k] over row u's entries:
    each row of g the table reads, read once, each output row written once,
    the offsets, columns and weights read once."""
    cols = np.asarray(cols)
    n_read = len(np.unique(cols))
    nbytes = (b * (n_read + n_rows) * c * 4
              + (n_rows + 1 + cols.size * (2 if weighted else 1)) * 4)
    return nbytes / PEAK_BYTES * 1e3


def gather_backward_ms(idx, n_src: int, b: int, c: int,
                       weighted: bool = False) -> float:
    """A gather's backward as a CSR reduce over its inverse: n_src output
    rows, one entry per tap, each entry reading its output row's gradient
    (a T-tap row is read once for its T entries)."""
    idx = np.asarray(idx)
    taps = 1 if idx.ndim == 1 else idx.shape[1]
    return csr_bound_ms(n_src, np.repeat(np.arange(idx.shape[0]), taps), b,
                        c, weighted)


def part_dist_bound(n_real, allone, batch: int, counts, asym, grad: bool,
                    w_mode: str = "threshold"):
    """(ms for the f32 operations, ms for the special-function operations)
    of one part_dist call, counting the least work: one evaluation per
    unordered pair, plus one for each pair whose two Gram orders round
    otherwise (`asym`, per tile); ~20 f32 operations and a square root an
    evaluation, the weight's acos where the threshold keeps the pair (for
    every pair in linear mode, a square root in sin mode, none on a uniform
    part), and for each evaluation in the mask (counts, ordered, per tile)
    ~16 f32 operations, a square root and a divide, with the gradient ~10
    f32 and two divides more."""
    n = np.repeat(np.asarray(n_real, np.float64), batch)
    uniform = np.repeat(np.asarray(allone, np.float64), batch)
    if w_mode == "all_one":
        uniform = np.ones_like(uniform)
    pairs = n * (n - 1) / 2
    evals = pairs + np.asarray(asym, np.float64)
    masked = np.asarray(counts, np.float64) / 2 * evals / np.maximum(pairs, 1)
    flops = float((evals * 20 + masked * (16 + (10 if grad else 0))).sum())
    weight = {"threshold": masked, "linear": evals, "sin": evals,
              "all_one": 0 * evals}[w_mode]
    sfu = float((evals + (1 - uniform) * (evals + weight)
                 + masked * (2 + (2 if grad else 0))).sum())
    return flops / PEAK_FLOPS["float32"] * 1e3, sfu / PEAK_SFU * 1e3


# --- model FLOPs ----------------------------------------------------------------

def conv_flops(plan, sizes, spiral_sizes, b: int) -> float:
    """2 B (V_l + 1) S_l C_in C_out summed over a conv plan
    [(level, C_in, C_out, act)]."""
    return float(sum(2 * b * (sizes[lvl] + 1) * spiral_sizes[lvl] * ci * co
                     for lvl, ci, co, _act in plan))


def model_flops(shape: dict, b: int, part: str = "forward") -> float:
    """The FLOPs of one forward ('forward'), encode or decode at batch b.
    `shape` holds the conv plans ("enc_plan", "dec_plan"), "sizes",
    "spiral_sizes" and the dense layers as [(K, N, count)] per part
    ("enc_dense", "dec_dense"): 2 b K N count each."""
    def dense(layers):
        return float(sum(2 * b * k * n * cnt for k, n, cnt in layers))

    enc = conv_flops(shape["enc_plan"], shape["sizes"], shape["spiral_sizes"],
                     b) + dense(shape["enc_dense"])
    dec = conv_flops(shape["dec_plan"], shape["sizes"], shape["spiral_sizes"],
                     b) + dense(shape["dec_dense"])
    return {"forward": enc + dec, "encode": enc, "decode": dec}[part]


def train_step_flops(shape: dict, trunk_b: int) -> float:
    """A training step's model FLOPs: the forward at the trunk batch and
    the backward as twice it."""
    return 3.0 * model_flops(shape, trunk_b)
