"""Step timing, trace windows and program spans (counterpart of
`semantichuman_tpu/utils/profiling.py`): a wall-clock step timer with
percentile summaries, torch.profiler traces of a window of steps, and
`span`, the program's named ranges in such a trace.

A trace records the host's operators and, where a card is present, its
kernels and copies (CPU and CUDA activities), and is written as Chrome
trace JSON (`export_chrome_trace`), which Perfetto and chrome://tracing
open and which needs no TensorBoard package.

A program span is a host range named `sh:<name>` around one phase of the
program at a layer boundary (the Trainer's staging, a graph's replay, the
bundle's copy-in, ...), recorded as an operator event (`cpu_op`) on the
profiler's clock, beside the card's kernels.  Spans are leaves: no span
encloses another, so the longest host event at a moment names the phase
the program was in.  Their names come from a fixed set, plus a graph's
name, and never hold a request, a step or a count.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as _Range

SPAN_PREFIX = "sh:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """The program span `sh:<name>` around a block: a no-op (one check of
    the profiler's flag) unless a profiler is recording, else an operator
    range, which adds nothing to the device's timeline."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Range(SPAN_PREFIX + name)


class StepTimer:
    """Wall-clock step timing with percentile summaries.  Where CUDA is
    initialized, each step's exit waits for the current card, so a step's
    time holds the kernels it launched."""

    def __init__(self, skip_first: int = 1):
        self.samples: list[float] = []
        self.skip_first = skip_first
        self._seen = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:    # drop the warm-up steps
            self.samples.append(dt)
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {"steps": 0}
        s = sorted(self.samples)
        n = len(s)
        return {
            "steps": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[min(n - 1, int(0.9 * n))],
            "max_s": s[-1],
        }

    def save(self, path: str) -> dict:
        out = self.summary()
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _sync():
    """Wait for the card, so that a trace holds the kernels it started."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _stop(prof, log_dir: str, name: str) -> str:
    """Stop the profiler and write its trace as
    <log_dir>/<name>.rank<r>.pt.trace.json; returns the path."""
    from ..parallel.distributed import process_index

    _sync()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"{name}.rank{process_index()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into <log_dir>/trace.rank<r>.pt.trace.json; yields
    log_dir."""
    prof = _profiler()
    prof.start()
    try:
        yield log_dir
    finally:
        _stop(prof, log_dir, "trace")


class TraceWindow:
    """Trace steps [start, stop) of a training loop into one file,
    <log_dir>/steps<start>-<stop>.rank<r>.pt.trace.json.

        window = TraceWindow(workdir + '/profile', start=5, stop=8)
        for step in ...:
            window.tick(step)   # starts / stops the trace at the bounds
        window.close()          # ends a window the loop left open
    """

    def __init__(self, log_dir: str, start: int, stop: int):
        self.log_dir = log_dir
        self.start, self.stop = start, stop
        self.path = None            # the trace file, once written
        self._prof = None

    def tick(self, step: int):
        if self._prof is None and self.path is None and step == self.start:
            _sync()
            self._prof = _profiler()
            self._prof.start()
        elif self._prof is not None and step >= self.stop:
            self.close()

    def close(self):
        if self._prof is not None:
            self.path = _stop(self._prof, self.log_dir,
                              f"steps{self.start}-{self.stop}")
            self._prof = None
