"""A step or a program as a CUDA graph: the card's form of the JAX package's
whole-epoch `lax.scan` (`Trainer._run_scan_chunk`) and of its serving
loader's jit cache (`serving.py:_Copy`).

The step of `step.py:make_epoch_scan_step` reads everything that changes
from step to step from static device buffers through a device counter, so
one capture of it is replayed once per step of every chunk: the host
launches one graph a step and reads the chunk's metrics once at its end.
The graph's size does not depend on the chunk's length.

    warm_up(fn, reset, name)            # first-use work, outside any graph
    graph = capture(fn, pool, name)     # one call of fn, recorded
    graph.replay()                      # once per step

Every graph has a name (`train/<flags>/<variant>`, `serve/<artifact>/<B>`),
under which its warm-up and capture run in the program span
`sh:capture/<name>` and each replay in `sh:replay/<name>`
(`utils/profiling.py:span`), and under which the launch counters keep
what its capture launched (`ops/launches.py:graph_record`): each replay
adds that record to the counters.

Nothing here falls back to running the step eagerly: a capture that meets
a host copy, a host read or any other operation a stream capture refuses
raises.
"""

from __future__ import annotations

import torch

from ..ops import launches
from ..utils.profiling import span


class Graph:
    """A captured CUDA graph under its name: `replay()` launches it and
    counts its capture's launches again; `out` is what the captured call
    returned (its static outputs)."""

    def __init__(self, graph: torch.cuda.CUDAGraph, name: str, record: dict,
                 out=None):
        self.graph, self.name, self.record, self.out = graph, name, record, out
        self._span = "replay/" + name
        self._count = launches.replayer(name, record)

    def replay(self) -> None:
        with span(self._span):
            self.graph.replay()
        self._count()

    def pool(self):
        return self.graph.pool()


def warm_up(fn, reset, name: str, steps: int = 2) -> None:
    """Run fn `steps` times on a side stream, `reset()` before each, so
    that what a first call does once (loading the kernel libraries, their
    cudaFuncSetAttribute calls, the cached constant tables, cuBLAS's
    handles and workspaces, autograd's device threads) happens before the
    capture.  fn changes the buffers it runs on: the caller loads its
    state into them after."""
    with span("capture/" + name):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(steps):
                reset()
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()


def capture(fn, pool, name: str) -> Graph:
    """One call of fn captured into graph `name`, whose memory comes from
    `pool` (`torch.cuda.graph_pool_handle()`, shared by every graph of a
    Trainer: they are replayed one at a time and keep no tensor alive
    between replays; or another graph's `pool()`).  The kernels are
    recorded, not run, and what the counters gained is the graph's
    record.  A replay reads every tensor the capture saw at its address:
    the caller keeps fn, and the tensors it closes over, alive as long as
    the graph."""
    graph = torch.cuda.CUDAGraph()
    with span("capture/" + name), launches.recording(name) as record:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    return Graph(graph, name, record, out)
