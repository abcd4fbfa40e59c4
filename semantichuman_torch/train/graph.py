"""A training step as a CUDA graph: the card's form of the JAX package's
whole-epoch `lax.scan` (`Trainer._run_scan_chunk`).

The step of `step.py:make_epoch_scan_step` reads everything that changes
from step to step from static device buffers through a device counter, so
one capture of it is replayed once per step of every chunk: the host
launches one graph a step and reads the chunk's metrics once at its end.
The graph's size does not depend on the chunk's length.

    warm_up(fn, reset)          # first-use work, outside any graph
    graph = capture(fn, pool)   # one call of fn, recorded
    graph.replay()              # once per step

Nothing here falls back to running the step eagerly: a capture that meets
a host copy, a host read or any other operation a stream capture refuses
raises.
"""

from __future__ import annotations

import torch


def warm_up(fn, reset, steps: int = 2) -> None:
    """Run fn `steps` times on a side stream, `reset()` before each, so
    that what a first call does once (loading the kernel libraries, their
    cudaFuncSetAttribute calls, the cached constant tables, cuBLAS's
    handles and workspaces, autograd's device threads) happens before the
    capture.  fn changes the buffers it runs on: the caller loads its
    state into them after."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(steps):
            reset()
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def capture(fn, pool) -> torch.cuda.CUDAGraph:
    """One call of fn captured into a graph whose memory comes from `pool`
    (`torch.cuda.graph_pool_handle()`, shared by every graph of a Trainer:
    they are replayed one at a time and keep no tensor alive between
    replays).  The kernels are recorded, not run.  A replay reads every
    tensor the capture saw at its address: the caller keeps fn, and the
    tensors it closes over, alive as long as the graph."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        fn()
    return graph
