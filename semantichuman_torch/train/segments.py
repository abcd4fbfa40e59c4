"""Segmented training (the port's copy of
`semantichuman_tpu/train/segments.py`): fit in eval_every-epoch segments,
run the full test eval after each, and append one JSON line per segment to
a curve file."""

from __future__ import annotations

import json
import time

import numpy as np


def run_segments(trainer, n_epochs: int, eval_every: int, curve_path: str,
                 tag: str = "", stop_on_nonfinite: bool = False) -> list:
    """Train `trainer` to `n_epochs` in `eval_every`-epoch segments.

    After each segment: full test eval, one JSON line
    {"epoch", "l1", "mm", "sec_per_epoch"} appended to `curve_path`.
    Returns the records, each with "elapsed_sec" (wall time since this call
    started, after that segment's eval; not written to the file).  With
    `stop_on_nonfinite`, a NaN/Inf mm stops the remaining segments.
    """
    t_start = time.time()
    start = trainer.start_epoch
    seg_ends = list(range(start - 1 + eval_every, n_epochs + 1, eval_every))
    if not seg_ends or seg_ends[-1] != n_epochs:
        # a trailing partial segment still trains and evaluates
        seg_ends.append(n_epochs)
    records = []
    for seg_end in seg_ends:
        t0 = time.time()
        trainer.fit(seg_end)
        sec = (time.time() - t0) / max(seg_end - trainer.start_epoch + 1, 1)
        trainer.start_epoch = seg_end + 1
        _, _, _, _, l1, mm = trainer.evaluate()
        rec = {"epoch": seg_end, "l1": round(float(l1), 6),
               "mm": round(float(mm), 4), "sec_per_epoch": round(sec, 2)}
        with open(curve_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        prefix = f"[{tag}] " if tag else ""
        print(f"{prefix}CURVE {json.dumps(rec)}", flush=True)
        records.append(dict(rec, elapsed_sec=round(time.time() - t_start, 1)))
        if stop_on_nonfinite and not np.isfinite(mm):
            print(f"{prefix}diverged (NaN): stopping", flush=True)
            break
    return records
