"""The launch counters of the port's kernels, read and set as one dict.

Each kernel wrapper adds one to its counter where it launches its kernel
on the card, and nowhere else (`spiral_conv.launches`,
`csr_reduce.launches`, ...; part_dist counts per mode).  A check sets
them to 0, drives a path and reads them: `read()` names every counter,
`restore(counts)` sets them.
"""

from __future__ import annotations


def _counters():
    from .banded_gather import banded_gather_bwd, banded_gather_fwd
    from .csr_reduce import csr_reduce, csr_reduce_v1
    from .part_dist import part_dist_sums, part_dist_v1
    from .row_gather import row_gather
    from .spiral_conv import (spiral_conv, spiral_conv_bwd_dw,
                              spiral_conv_bwd_dx, spiral_conv_fwd_v1)

    return ({"spiral_conv_fwd": spiral_conv,
             "spiral_conv_fwd_v1": spiral_conv_fwd_v1,
             "spiral_conv_bwd_dw": spiral_conv_bwd_dw,
             "spiral_conv_bwd_dx": spiral_conv_bwd_dx,
             "csr_reduce": csr_reduce, "csr_reduce_v1": csr_reduce_v1,
             "part_dist_v1": part_dist_v1,
             "banded_gather_fwd": banded_gather_fwd,
             "banded_gather_bwd": banded_gather_bwd,
             "row_gather": row_gather}, part_dist_sums.launches)


def read() -> dict:
    """{kernel: launches so far}; part_dist as part_dist_<mode>."""
    fns, modes = _counters()
    out = {name: fn.launches for name, fn in fns.items()}
    out.update({f"part_dist_{m}": n for m, n in modes.items()})
    return out


def restore(counts: dict) -> None:
    """Set every counter to `counts` (read()'s keys)."""
    fns, modes = _counters()
    for name, fn in fns.items():
        fn.launches = counts[name]
    for m in modes:
        modes[m] = counts[f"part_dist_{m}"]
