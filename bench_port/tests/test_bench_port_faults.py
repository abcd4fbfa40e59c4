"""`correct` against the faults a cell can have and against its control,
at a small size on the CPU: the rest of a run (set-up, window, the
reference and the comparison, `run.run_cell`), past the harness's look
for a card, with the timed path broken underneath.

  * a step that returns its state unchanged (Adam applies nothing);
  * half of every batch left out, the mean taken over the rest;
  * an answer altered where it is produced (one served output entry);
  * the control: the program's own bfloat16 trunk.

A cell on one card has no exchange between cards to leave out.  The
limits are the cells' own (`bench_port/limits/`)."""

from __future__ import annotations

import pytest
import torch

from bench_port.run import run_cell

SEED = 2 ** 31 + 31


def _run(spec, name):
    return run_cell(spec, name, SEED, 1.0, False, "cpu", 0.0)


TRAIN = ["partae.train_b4", "n3dmm.train_b16", "partae.train_b64"]


@pytest.mark.parametrize("cell", TRAIN + ["partae.serve_edit"])
def test_sound_run_is_correct(small_cell, cell):
    res = _run(small_cell(cell), cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_unchanged(small_cell, monkeypatch, cell):
    from semantichuman_torch.train.optim import Adam

    def frozen_(self, grads, params, mu, nu, scalars, bad=None):
        return None

    monkeypatch.setattr(Adam, "update_", frozen_)
    monkeypatch.setattr(Adam, "update", lambda self, g, s, p: (
        _zeros_like_tree(g), s))
    res = _run(small_cell(cell), cell)
    assert not res["correct"]
    assert res["checks"]["delta_gap"]["value"] > \
        res["checks"]["delta_gap"]["limit"]


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch(small_cell, monkeypatch, cell):
    from semantichuman_torch.data.device_data import DeviceDataSource
    real = DeviceDataSource.batch_fn

    def half(self, idx):
        # the first half twice: the mean over it, at the batch's shape
        h = idx[:idx.shape[0] // 2]
        return real(self, torch.cat([h, h]))

    monkeypatch.setattr(DeviceDataSource, "batch_fn", half)
    res = _run(small_cell(cell), cell)
    assert not res["correct"], res["checks"]


def test_answer_altered(small_cell, monkeypatch):
    from semantichuman_torch import serving
    real = serving._Copy.call

    def altered(self, name, args, graph):
        out = real(self, name, args, graph)
        outs = list(out) if isinstance(out, tuple) else [out]
        first = outs[0].clone(memory_format=torch.contiguous_format)
        first.view(-1)[7] += 1e-3 * float(first.abs().max())
        outs[0] = first
        return tuple(outs) if isinstance(out, tuple) else first

    monkeypatch.setattr(serving._Copy, "call", altered)
    res = _run(small_cell("partae.serve_edit"), "partae.serve_edit")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_control_bf16_trunk(small_cell, cell):
    """The program's own lower-precision path in its place fails the
    cell's limits."""
    from bench_port import checks
    from bench_port.tools.readings import train_reading
    spec = small_cell(cell)
    nums = train_reading(cell, spec, SEED, "control", "cpu")
    assert not checks.correct(checks.judge(nums, spec["limits"])), nums


def test_control_bf16_serving(small_cell):
    from bench_port import checks
    from bench_port.tools.readings import serve_reading
    spec = small_cell("partae.serve_edit")
    nums = serve_reading("partae.serve_edit", spec, SEED, "control", "cpu",
                         1.0)
    assert not checks.correct(checks.judge(nums, spec["limits"])), nums
