"""The plain reference against the port: the first three steps of a PartAE
and of a neural3DMM training run, and the three serving programs, on the
CPU at a small size; on the card, the cells' own sizes (marked `cuda`)."""

from __future__ import annotations

import pytest
import torch

from bench_port.drivers import common as C
from bench_port.drivers import serve as S
from bench_port.drivers import train as T

# float32 both sides, the same operations in another order or grouping
TOL = 1e-5


def _steps(spec, seed, device):
    trainer, inputs = T._trainer(spec["config"], spec["traffic"], seed,
                                 device, "test")
    inputs["seed"] = seed
    first = T.first_epoch(trainer)
    prog = T.program_readings(first, C.leaves(inputs["params"]))
    ref = T.reference_readings(spec["config"], spec["traffic"], inputs,
                               device)
    return prog, ref


@pytest.mark.parametrize("cell", ["partae.train_b4", "n3dmm.train_b16"])
def test_training_steps(small_cell, cell):
    prog, ref = _steps(small_cell(cell), 2 ** 31 + 21, "cpu")
    assert len(prog["loss"]) == 3
    for p, r in zip(prog["loss"], ref["loss"]):
        assert abs(p - r) <= TOL * abs(r)
    for key in ("grad", "delta"):
        scale = max(ref[key])
        for p, r in zip(prog[key], ref[key]):
            assert abs(p - r) <= TOL * max(r, scale * 1e-3), key


def _served(spec, seed, device, tmp):
    """The three programs through the bundle against the reference: the
    forward, and each edit of the traffic (its encodes and decode), at
    batches 1, 4 and 16."""
    from semantichuman_torch.serving import ServingBundle
    config, traffic = spec["config"], spec["traffic"]
    h = C.human(config)
    bundle_dir, params = S.export(config, h, seed, device, tmp)
    bundle = ServingBundle(bundle_dir, device=device)
    pool = S.inputs(config, traffic, seed, h, device)
    ref = S.Reference(config, h, params, device)

    def call(art, *a):
        return S._host(bundle.call(art, *a))

    got, want = [], []
    for b in (1, 4, 16):
        x = pool["verts"][1:1 + b]
        got.append([("forward", call("forward", x))])
        want.append([("forward", ref("forward", x))])
        for e in traffic["edits"]:
            got.append(S.run_edit(call, traffic, pool, b, 1, e))
            want.append(S.run_edit(ref, traffic, pool, b, 1, e))
    return S.gap(got, want)


def test_serving_programs(small_cell, tmp_path):
    assert _served(small_cell("partae.serve_edit"), 2 ** 31 + 22, "cpu",
                   str(tmp_path)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["partae.train_b4", "partae.train_b64"])
def test_training_steps_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_port import manifest
    spec = manifest.cell(manifest.load(C.ROOT), C.ROOT, cell)
    prog, ref = _steps(spec, 2 ** 31 + 23, "cuda")
    from bench_port import checks
    assert checks.correct(checks.judge(checks.train_numbers(prog, ref),
                                       spec["limits"]))


@pytest.mark.cuda
def test_serving_programs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench_port import manifest
    spec = manifest.cell(manifest.load(C.ROOT), C.ROOT, "partae.serve_edit")
    assert _served(spec, 2 ** 31 + 24, "cuda", str(tmp_path)) \
        <= spec["limits"]["serve_gap"]
