"""Metrics logging as JSON lines (the port's copy of
`semantichuman_tpu/utils/logging.py`, without TensorBoard)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Appends one JSON object per call to <log_dir>/metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: dict, prefix: str = "loss"):
        """`prefix` names the group (kept for the JAX signature; JSONL
        records carry the bare names)."""
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class AverageValueMeter:
    """Streaming mean/std accumulator."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.sumsq = 0.0

    def add(self, value, n: int = 1):
        v = float(value)
        self.n += n
        self.sum += v * n
        self.sumsq += v * v * n

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else float("nan")

    @property
    def std(self) -> float:
        if self.n < 2:
            return float("nan")
        var = (self.sumsq - self.n * self.mean ** 2) / (self.n - 1)
        return var ** 0.5 if var > 0 else 0.0
