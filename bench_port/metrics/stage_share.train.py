"""stage_share.train: the share of the traced `Trainer.fit` call that the
Trainer spent staging its chunks (`train/loop.py` `Trainer._run_scan_chunk`:
a chunk's schedule built and copied onto the device, the state loaded into
the epoch buffers, while the card waits), from the program spans
`sh:trainer.stage` inside the benchmark's `fit` span: their wall time over
the span's, in %.  Silent where the program records no such span."""

from __future__ import annotations

STAGE = "sh:trainer.stage"


def inside(spans, outer) -> list:
    """The (start, end) of `spans` that lie within one of `outer`."""
    return [(s, e) for s, e in spans
            if any(lo <= s and e <= hi for lo, hi in outer)]


def read(ctx):
    tr = ctx.traced
    fits = tr.spans_named("fit")
    stage = inside([(s, e) for n, s, e in tr.host if n == STAGE], fits)
    wall = sum(e - s for s, e in fits)
    if not stage or wall <= 0:
        return None
    return 100.0 * sum(e - s for s, e in stage) / wall
