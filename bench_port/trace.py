"""The traced part of a `--trace 1` run: torch.profiler over one stretch of
the window, read into device intervals (kernels, copies, sets), the
benchmark's own spans (`span`, recorded around its calls into each layer
with `record_function`, names starting with "bench:") and the host's
operators, and reduced to the device's busy time, the window's length and
the breakdown the result line carries."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN_PREFIX = "bench:"


@contextmanager
def span(name: str):
    """A benchmark span around a call into one layer; a no-op unless a
    profiler is recording."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def merge(intervals) -> list:
    """Sorted, disjoint [start, end] intervals covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(merged, lo: float, hi: float) -> float:
    """The length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


@dataclass
class Traced:
    """Times in seconds from the profiler's clock."""
    ops: list = field(default_factory=list)      # (name, start, end) device
    spans: list = field(default_factory=list)    # (name, start, end) bench
    host: list = field(default_factory=list)     # (name, start, end) cpu ops
    window_s: float = 0.0
    start: float = 0.0
    wall: float = 0.0
    prof: object = None

    @property
    def busy(self) -> list:
        if not hasattr(self, "_busy"):
            self._busy = merge([(s, e) for _, s, e in self.ops])
        return self._busy

    @property
    def busy_s(self) -> float:
        return covered(self.busy, self.start, self.start + self.window_s)

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def kernel_s(self, *names) -> tuple:
        """(seconds, launches) of the device ops whose name contains one
        of `names`."""
        hits = [(e - s) for n, s, e in self.ops if any(k in n for k in names)]
        return sum(hits), len(hits)

    LABELLED_GAPS = 500

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle gaps by what
        the host was doing at their midpoint: the innermost benchmark span
        and the longest host operator (the longest gaps one by one, the
        rest together)."""
        by_op: dict = {}
        for n, s, e in self.ops:
            key = n[:120]
            by_op[key] = by_op.get(key, 0.0) + (e - s)
        edges = [(self.start, self.start)] + [tuple(x) for x in self.busy] \
            + [(self.start + self.window_s,) * 2]
        holes = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _)
                        in zip(edges, edges[1:]) if s1 > e0), reverse=True)
        sp = np.array([(s, e) for _, s, e in self.spans] or [(0.0, 0.0)])
        ho = np.array([(s, e) for _, s, e in self.host] or [(0.0, 0.0)])
        gaps: dict = {}
        for k, (length, e0, s1) in enumerate(holes):
            if k >= self.LABELLED_GAPS:
                key = "shorter gaps"
            else:
                mid = 0.5 * (e0 + s1)
                inner = np.nonzero((sp[:, 0] <= mid) & (sp[:, 1] >= mid))[0]
                outer = np.nonzero((ho[:, 0] <= mid) & (ho[:, 1] >= mid))[0]
                key = (self.spans[inner[-1]][0] if len(inner) and self.spans
                       else "outside the spans") + " / " + (
                    self.host[outer[np.argmax(ho[outer, 1] - ho[outer, 0])]][0]
                    if len(outer) and self.host else "python")
            gaps[key] = gaps.get(key, 0.0) + length

        def rank(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


@contextmanager
def traced(out: Traced):
    """Profile the block (CPU and CUDA activities) into `out`, whose
    events `read` takes in after the window; the block's end waits for
    the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    sync()
    t0 = time.perf_counter()
    with span("window"):
        yield out
        sync()
    out.wall = time.perf_counter() - t0
    prof.stop()
    out.prof = prof


def read(out: Traced) -> Traced:
    """Fill `out` from its profiler once the window has closed."""
    for ev in out.prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if name.startswith(SPAN_PREFIX):
            # record_function's annotation; its copy on the device's
            # timeline is no device operation
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                out.spans.append((name[len(SPAN_PREFIX):], s, e))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            out.ops.append((name, s, e))
        else:
            out.host.append((name, s, e))
    out.prof = None
    out.spans.sort(key=lambda x: x[1])
    win = out.spans_named("window")
    out.start = win[0][0] if win else 0.0
    out.window_s = (win[0][1] - win[0][0]) if win else out.wall
    return out
