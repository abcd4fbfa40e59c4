"""The launch counters of the port's kernels, read and set as one dict.

Each kernel wrapper adds one to its counter where it launches its kernel
on the card, and nowhere else (`spiral_conv.launches`,
`csr_reduce.launches`, ...; part_dist counts per mode).  The conv
backward counts its dx calls by route and shape (`spiral_conv.DX_CALLS`)
and its fused dW calls by shape and window tile, with the rows the window
copies and the entries read from it (`spiral_conv.DW_CALLS`).
A captured graph (`train/graph.py:capture`) keeps what each counter gained
while it was captured, its record (`graph_record(name)`), and each replay
adds the record again (`replayer`): the counters count what a replayed
graph launched as well.  A check sets them to 0, drives a path and reads
them: `read()` names every counter, `restore(counts)` sets them, `reset()`
sets them to 0, `diff(after, before)` subtracts two readings.
"""

from __future__ import annotations

import contextlib

DX = "spiral_conv_dx"
DW = "spiral_conv_dw"
DW_KINDS = ("calls", "rows", "entries")
GRAPH_KINDS = ("graph_captures", "graph_replays")

# graph name -> {"graph_captures": n, "graph_replays": n, "record": {...}}
_GRAPHS: dict = {}


def _counters():
    from .banded_gather import banded_gather_bwd, banded_gather_fwd
    from .csr_reduce import csr_reduce
    from .part_dist import part_dist_sums
    from .row_gather import row_gather
    from .spiral_conv import (DW_CALLS, DX_CALLS, spiral_conv,
                              spiral_conv_bwd_dw, spiral_conv_bwd_dx)

    return ({"spiral_conv_fwd": spiral_conv,
             "spiral_conv_bwd_dw": spiral_conv_bwd_dw,
             "spiral_conv_bwd_dx": spiral_conv_bwd_dx,
             "csr_reduce": csr_reduce,
             "banded_gather_fwd": banded_gather_fwd,
             "banded_gather_bwd": banded_gather_bwd,
             "row_gather": row_gather}, part_dist_sums.launches, DX_CALLS,
            DW_CALLS)


def read() -> dict:
    """{kernel: launches so far}, part_dist as part_dist_<mode>; besides,
    `spiral_conv_dx`: {"<route>:<B>,<V1>,<S>,<C_in>,<C_out>": dx calls}
    (route fused, unfused or plain), `spiral_conv_dw`:
    {"<B>,<V1>,<S>,<C_in>,<C_out>:<T>": {"calls", "rows", "entries"}}
    (fused dW calls, window rows copied, entries read), and
    `graph_captures`, `graph_replays`: {"total": n, "by_name": {graph
    name: n}}."""
    fns, modes, dx, dw = _counters()
    out = {name: fn.launches for name, fn in fns.items()}
    out.update({f"part_dist_{m}": n for m, n in modes.items()})
    out[DX] = dict(dx)
    out[DW] = {k: dict(v) for k, v in dw.items()}
    for kind in GRAPH_KINDS:
        by_name = {n: g[kind] for n, g in _GRAPHS.items() if g[kind]}
        out[kind] = {"total": sum(by_name.values()), "by_name": by_name}
    return out


def restore(counts: dict) -> None:
    """Set every counter to `counts` (read()'s keys)."""
    fns, modes, dx, dw = _counters()
    for name, fn in fns.items():
        fn.launches = counts[name]
    for m in modes:
        modes[m] = counts[f"part_dist_{m}"]
    dx.clear()
    dx.update(counts[DX])
    dw.clear()
    dw.update({k: dict(v) for k, v in counts[DW].items()})
    for kind in GRAPH_KINDS:
        for name, g in _GRAPHS.items():
            g[kind] = counts[kind]["by_name"].get(name, 0)


def reset() -> None:
    """Set every counter to 0 (the graphs' records stay)."""
    counts = read()
    restore({k: 0 for k in counts if k not in _KEYED}
            | {DX: {}, DW: {}, **{k: {"by_name": {}} for k in GRAPH_KINDS}})


def diff(after: dict, before: dict) -> dict:
    """after - before, key by key, into the nested counts (a key missing
    from `before` counts 0)."""
    return {k: diff(v, before.get(k, {})) if isinstance(v, dict)
            else v - before.get(k, 0) for k, v in after.items()}


_KEYED = (DX, DW) + GRAPH_KINDS


def _record(after: dict, before: dict) -> dict:
    """The kernel, dx and dW counts gained between two readings, zeros
    left out."""
    d = diff(after, before)
    rec = {k: n for k, n in d.items() if k not in _KEYED and n}
    dx = {k: n for k, n in d[DX].items() if n}
    if dx:
        rec[DX] = dx
    dw = {k: n for k, n in d[DW].items() if n["calls"]}
    if dw:
        rec[DW] = dw
    return rec


def _graph(name: str) -> dict:
    return _GRAPHS.setdefault(name, {"graph_captures": 0, "graph_replays": 0,
                                     "record": {}})


@contextlib.contextmanager
def recording(name: str):
    """Count the block as one capture of graph `name` and keep what the
    counters gained in it as the graph's record; yields a dict that holds
    the record once the block has ended."""
    out: dict = {}
    before = read()
    yield out
    out.update(_record(read(), before))
    g = _graph(name)
    g["graph_captures"] += 1
    g["record"] = dict(out)


def replayer(name: str, record: dict):
    """-> a function that counts one replay of graph `name`, captured with
    `record`: its launches added to the counters, which are looked up once,
    here."""
    fns, modes, dx, dw = _counters()
    ints = [(fns[k], n) for k, n in record.items() if k in fns]
    keyed = [(modes, k[len("part_dist_"):], n) for k, n in record.items()
             if k not in _KEYED and k not in fns]
    keyed += [(dx, k, n) for k, n in record.get(DX, {}).items()]
    dws = list(record.get(DW, {}).items())
    graph = _graph(name)

    def replayed() -> None:
        for fn, n in ints:
            fn.launches += n
        for counts, k, n in keyed:
            counts[k] = counts.get(k, 0) + n
        for k, n in dws:
            got = dw.setdefault(k, dict.fromkeys(DW_KINDS, 0))
            for kind in DW_KINDS:
                got[kind] += n[kind]
        graph["graph_replays"] += 1

    return replayed


def graph_record(name: str) -> dict:
    """What the latest capture of graph `name` launched ({} for a name
    never captured): kernel counts, `spiral_conv_dx` and `spiral_conv_dw`,
    zeros left out."""
    g = _GRAPHS.get(name)
    return dict(g["record"]) if g else {}
