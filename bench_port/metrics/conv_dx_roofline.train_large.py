"""conv_dx_roofline.train_large: the fused conv dx kernels' share of their
roofline in the traced `Trainer.fit` call (`csrc/spiral_conv_bwd.cu`).

The least time is that of the dx halves the fused kernel computed: each
replay of a training graph inside the benchmark's `fit` span (the program
spans `sh:replay/train/...`) times that graph's record of dx calls by route
and shape (`spiral_conv_dx` in `ops/launches.py:graph_record`, the route
`fused` only).  A dx half at (B, V1, S, C_in, C_out) is bound by the larger
of its operations, 2 B V1 S C_in C_out over the float32 peak, and its bytes,
dy, W, the inverse spiral table and dx each moved once, over the memory
bandwidth.  Over the device time of the `dx_short`, `dx_narrow`,
`dx_long_partial` and `dx_long_finish` kernels, in %.  Silent where no
fused dx ran, or where the program keeps no such record."""

from __future__ import annotations

from bench_port import arith

DX_KERNELS = ("dx_short_kernel", "dx_narrow_kernel", "dx_long_partial_kernel",
              "dx_long_finish_kernel")
REPLAY = "sh:replay/"


def dx_least_s(b: int, v1: int, s: int, c_in: int, c_out: int) -> float:
    """The least time of one float32 dx half, in seconds."""
    flops = 2 * b * v1 * s * c_in * c_out
    nbytes = 4 * (b * v1 * c_out + s * c_in * c_out + (v1 + 1) + v1 * s
                  + b * v1 * c_in)
    return max(flops / arith.PEAK_FLOPS["float32"], nbytes / arith.PEAK_BYTES)


def replays(tr) -> dict:
    """{graph name: replays} of the training graphs inside the `fit`
    spans."""
    fits = tr.spans_named("fit")
    out: dict = {}
    for n, s, e in tr.host:
        if n.startswith(REPLAY + "train/") and any(
                lo <= s and e <= hi for lo, hi in fits):
            g = n[len(REPLAY):]
            out[g] = out.get(g, 0) + 1
    return out


def least_s(replayed: dict, record) -> float:
    """The least time of the fused dx halves of the replays, `record(name)`
    giving a graph's launch record."""
    total = 0.0
    for g, k in replayed.items():
        for key, calls in record(g).get("spiral_conv_dx", {}).items():
            route, dims = key.split(":")
            if route == "fused":
                total += k * calls * dx_least_s(*map(int, dims.split(",")))
    return total


def read(ctx):
    replayed = replays(ctx.traced)
    if not replayed:
        return None
    try:
        from semantichuman_torch.ops.launches import graph_record
    except ImportError:
        return None
    least = least_s(replayed, graph_record)
    kernel_s = ctx.traced.kernel_s(*DX_KERNELS)[0]
    if least <= 0 or kernel_s <= 0:
        return None
    return 100.0 * least / kernel_s
