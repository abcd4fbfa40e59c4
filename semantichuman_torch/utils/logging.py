"""Metrics logging (the port's copy of `semantichuman_tpu/utils/logging.py`):
JSON lines always, TensorBoard scalars as well where
`torch.utils.tensorboard` imports (the `tensorboard` package installed)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Appends one JSON object per call to <log_dir>/metrics.jsonl and,
    with tensorboard and the package present, adds each scalar to a
    SummaryWriter in log_dir as '<prefix>/<name>'."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:     # no tensorboard package: JSONL alone
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def log(self, step: int, scalars: dict, prefix: str = "loss"):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


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
