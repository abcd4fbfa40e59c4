"""What the per-layer readers (`bench_port/metrics/<name>.py`) share: the
traced stretch's counts (steps, validation batches, requests), the conv
kernels' names and the least time of their work from `arith`.

Each reader is `read(ctx) -> float | None`, ctx holding `kind` ("train" or
"serve"), `traced` (a `trace.Traced`), `out` (the driver's record of the
run), `shape` (`drivers.common.model_shape`), `config` and `traffic`.  A
reader that finds nothing to read returns None, and the metric is left out
of the line."""

from __future__ import annotations

import math

from . import arith
from .trace import covered

FWD_KERNELS = ("sc_fwd_tile_kernel", "sc_fwd_narrow_kernel")
DW_KERNELS = ("dw_partial_kernel", "dw_finish_kernel")


def traced_steps(ctx) -> int:
    e0, e1, _ = ctx.out["traced_call"]
    return (e1 - e0 + 1) * ctx.out["steps_per_epoch"]


def val_batches(ctx) -> int:
    per = math.ceil(ctx.traffic["n_test"] / ctx.out["batch_test"])
    return len(ctx.traced.spans_named("validate")) * per


def convs(shape, part: str = "forward") -> list:
    """(v1, s, c_in, c_out) of each conv of an artifact."""
    plans = {"forward": shape["enc_plan"] + shape["dec_plan"],
             "encode": shape["enc_plan"], "decode": shape["dec_plan"]}[part]
    return [(shape["sizes"][l] + 1, shape["spiral_sizes"][l], ci, co)
            for l, ci, co, _ in plans]


def fwd_least_s(shape, b: int, part: str = "forward") -> float:
    return sum(max(arith.conv_fwd_bound(b, *c))
               for c in convs(shape, part)) * 1e-3


def dw_least_s(shape, b: int) -> float:
    return sum(max(arith.conv_bwd_bound(b, *c, dx=False))
               for c in convs(shape)) * 1e-3


def busy_in(tr, spans) -> float:
    return sum(covered(tr.busy, s, e) for s, e in spans)


def requests(tr) -> list:
    """(artifact, batch, start, end) of each traced request."""
    out = []
    for name, s, e in tr.spans:
        if name.startswith("request/"):
            _, art, b = name.split("/")
            out.append((art, int(b), s, e))
    return out


def share(least_s: float, kernel_s: float):
    """A roofline share in %: None where no kernel time was read."""
    return 100.0 * least_s / kernel_s if kernel_s > 0 else None


# --- the readers ----------------------------------------------------------

def val_share(ctx):
    """The share of the window's epochs spent outside the train chunks
    (validation and the Trainer's per-epoch host work), from Trainer.history:
    sum(sec - train_sec) / sum(sec), in %."""
    hist = ctx.out["history"]
    total = sum(h["sec"] for h in hist)
    if total <= 0:
        return None
    return 100.0 * sum(h["sec"] - h["train_sec"] for h in hist) / total


def step_device_ms(ctx):
    """Device busy ms per training step in the traced call: busy time inside
    the `fit` span less that inside its `validate` spans, over its steps."""
    tr = ctx.traced
    fit = tr.spans_named("fit")
    if not fit:
        return None
    busy = busy_in(tr, fit) - busy_in(tr, tr.spans_named("validate"))
    return busy / traced_steps(ctx) * 1e3


def conv_fwd_roofline_train(ctx):
    """The spiral conv forward kernels' share of their roofline in the traced
    training call: the least time of the nine convs at the trunk batch a step
    and at the test batch a validation batch (bytes or operations, whichever
    binds, `arith.conv_fwd_bound`), over the kernels' device time, in %."""
    least = (traced_steps(ctx) * fwd_least_s(ctx.shape, ctx.out["trunk_b"])
             + val_batches(ctx) * fwd_least_s(ctx.shape,
                                              ctx.out["batch_test"]))
    return share(least, ctx.traced.kernel_s(*FWD_KERNELS)[0])


def conv_dw_roofline_train(ctx):
    """The spiral conv dW kernels' share of their roofline in the traced
    training call: the least time of every conv's dW at the trunk batch a
    step (`arith.conv_bwd_bound` without dx), over the dW kernels' device
    time, in %.  Silent where the call did not launch one dW partial
    kernel a conv a step, that is where some conv's dW took another
    route."""
    steps = traced_steps(ctx)
    if ctx.traced.kernel_s(DW_KERNELS[0])[1] != steps * len(convs(ctx.shape)):
        return None
    return share(steps * dw_least_s(ctx.shape, ctx.out["trunk_b"]),
                 ctx.traced.kernel_s(*DW_KERNELS)[0])


def mfu_train(ctx):
    """Model FLOPs utilisation of training: the steps of the window's calls
    times a step's model FLOPs (`arith.train_step_flops` at the trunk
    batch: the forward, and the backward as twice it), over those calls' host
    time times the float32 peak (67 TFLOP/s), in %."""
    calls = ctx.out["calls"]
    secs = sum(c[2] for c in calls)
    if not calls or secs <= 0:
        return None
    steps = sum(e1 - e0 + 1 for e0, e1, _ in calls) * ctx.out["steps_per_epoch"]
    flops = steps * arith.train_step_flops(ctx.shape, ctx.out["trunk_b"])
    return 100.0 * flops / (secs * arith.PEAK_FLOPS["float32"])


def idle_share(ctx):
    """The share of the traced stretch with no device operation running,
    in %."""
    tr = ctx.traced
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None


def serve_host_gap_ms(ctx):
    """Per traced request, its wall time less the device's busy time inside
    it (the bundle's input copy, replay, clone and copy back as the host paces
    them), mean ms."""
    tr = ctx.traced
    reqs = requests(tr)
    if not reqs:
        return None
    gap = sum((e - s) - covered(tr.busy, s, e) for _a, _b, s, e in reqs)
    return gap / len(reqs) * 1e3


def conv_fwd_roofline_serve(ctx):
    """The spiral conv forward kernels' share of their roofline over the
    traced requests: the least time of each request's convs at its batch
    (forward nine, encode four, decode five), over the kernels' device time,
    in %."""
    least = sum(fwd_least_s(ctx.shape, b, art)
                for art, b, _s, _e in requests(ctx.traced))
    return share(least, ctx.traced.kernel_s(*FWD_KERNELS)[0])


def mfu_serve(ctx):
    """Model FLOPs utilisation of serving: the model FLOPs of the requests
    served in the window (`arith.model_flops` of each request's artifact at
    its batch), over the window's host time times the float32 peak (67
    TFLOP/s), in %."""
    served = ctx.out["served"]
    secs = ctx.out["window_s"]
    if not served or secs <= 0:
        return None
    flops = sum(arith.model_flops(ctx.shape, b, art) for art, b in served)
    return 100.0 * flops / (secs * arith.PEAK_FLOPS["float32"])
