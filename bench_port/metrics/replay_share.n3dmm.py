"""replay_share.n3dmm: the share of the traced `Trainer.fit` call's training
steps that were replays of a captured graph (`train/graph.py`: the program
spans `sh:replay/train/...` inside the benchmark's `fit` span, counted by
`conv_dx_roofline.train_large`'s `replays`) over the call's steps, in %.
Silent where the program records no such span (a Trainer that trains the
model through its eager loop)."""

from __future__ import annotations

import importlib.util

from bench_port.layers import traced_steps
from bench_port.manifest import HERE


def dx_reader():
    """The reader module of `conv_dx_roofline.train_large`, whose
    `replays` this metric shares."""
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_conv_dx_roofline_train_large",
        HERE / "metrics" / "conv_dx_roofline.train_large.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(ctx):
    replayed = dx_reader().replays(ctx.traced)
    if not replayed:
        return None
    return 100.0 * sum(replayed.values()) / traced_steps(ctx)
