"""The comparison that decides `correct`: the numbers each cell compares
between what the timed path produced and the plain reference, each judged
against its limit (`bench_port/limits/<cell>.json`)."""

from __future__ import annotations

import math

import numpy as np


def _median(xs) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def leaf_gap(prog: list, ref: list, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's: |n_p - n_r| / max(n_r, median n_r)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    floor = _median([ref[i] for i in idx])
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], floor, 1e-30) for i in idx]
    return max(gaps) if gaps else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap: the worst of the first three steps' relative loss gaps;
    loss1_gap: the first step's, which no optimizer step precedes;
    grad_gap: the first step's gradient as the optimizer took it in, by
    the worst leaf; delta_gap: the parameters' change after three steps,
    by the worst leaf, over the leaves whose raw reference gradient is at
    least a thousandth of the median leaf's (the others move under Adam by
    round-off alone)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(prog["loss"], ref["loss"])]
    floor = 1e-3 * _median(ref["raw"])
    moved = [g >= floor for g in ref["raw"]]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "delta_gap": leaf_gap(prog["delta"], ref["delta"], moved)}


def output_gap(prog, ref) -> float:
    """max |prog - ref| over max |ref|, for one output tensor."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape:
        return math.inf
    return float(np.max(np.abs(prog - ref)) / max(np.max(np.abs(ref)), 1e-30))


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell's limits name (a
    cell compares those; the others are readings); a number that is not
    there or not finite fails."""
    return {k: {"value": float(numbers.get(k, math.nan)), "limit": lim}
            for k, lim in limits.items()}


def correct(checked: dict) -> bool:
    return bool(checked) and all(
        math.isfinite(c["value"])
        and c["value"] <= c["limit"]
        for c in checked.values())
