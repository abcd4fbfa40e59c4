"""optimizer_roofline.n3dmm: `Adam.update_`'s share of its roofline in the
traced `Trainer.fit` call's replayed steps (`train/optim.py`).

The least time is bytes over the memory bandwidth: each step reads the
parameters, the gradients and both moments and writes the parameters and
both moments, 4 bytes an entry each (`adam_bytes`).  Over the device time
of `update_`'s kernels alone: in each step's run of `multi_tensor_apply` and
elementwise kernels, those from the first foreach kernel (the coupled decay
added to the gradient) to the last (the update added to the parameters),
which leaves out `global_norm`'s products, sums and square root before them
and the step's counters after them; a run with no elementwise kernel among
its foreach kernels (the chunk's state copied into the epoch buffers,
`EpochBuffers.load`) is no step's.  In %.  Silent unless every traced step
was a replay of a captured graph (`replay_share.n3dmm` reads 100 %) and one
such run was found a step."""

from __future__ import annotations

from bench_port import arith
from bench_port.layers import convs, traced_steps
from bench_port.manifest import metric_reader

FOREACH = "multi_tensor_apply_kernel"
ELEMENTWISE = "elementwise_kernel"


def n_params(shape) -> int:
    """The model's parameters: each conv's weight [S C_in, C_out] and
    bias, each dense layer's weight [K, N] and bias, `count` times."""
    conv = sum(s * ci * co + co for _v1, s, ci, co in convs(shape))
    dense = sum((k * n + n) * cnt
                for k, n, cnt in shape["enc_dense"] + shape["dec_dense"])
    return conv + dense


def adam_bytes(n: int) -> int:
    """The least bytes of one Adam step over n float32 parameters: params,
    grads, mu and nu read, params, mu and nu written."""
    return 7 * 4 * n


def update_runs(ops, fits, skip) -> list:
    """The seconds of each `update_` run among the device ops (name, start,
    end) that lie in one of `fits` and in none of `skip`: a run is the ops
    from the first to the last foreach kernel of a stretch of foreach and
    elementwise kernels alone, with an elementwise kernel between them
    (update_'s per-leaf bias corrections)."""
    def inside(s, e, spans):
        return any(lo <= s and e <= hi for lo, hi in spans)

    seq = sorted((s, e, n) for n, s, e in ops
                 if inside(s, e, fits) and not inside(s, e, skip))
    runs, cur = [], []

    def close():
        first = next((i for i, (_s, _e, n) in enumerate(cur)
                      if FOREACH in n), None)
        if first is not None:
            last = max(i for i, (_s, _e, n) in enumerate(cur) if FOREACH in n)
            run = cur[first:last + 1]
            if any(FOREACH not in n for _s, _e, n in run):
                runs.append(sum(e - s for s, e, _n in run))
        cur.clear()

    for s, e, n in seq:
        if FOREACH in n or ELEMENTWISE in n:
            cur.append((s, e, n))
        else:
            close()
    close()
    return runs


def read(ctx):
    tr = ctx.traced
    steps = traced_steps(ctx)
    if metric_reader("replay_share.n3dmm")(ctx) != 100.0:
        return None
    runs = update_runs(tr.ops, tr.spans_named("fit"),
                       tr.spans_named("validate"))
    if len(runs) != steps or sum(runs) <= 0:
        return None
    least = steps * adam_bytes(n_params(ctx.shape)) / arith.PEAK_BYTES
    return 100.0 * least / sum(runs)
