"""The cell `n3dmm.train_b256` (the neural3DMM baseline at B = 256 through
the captured epoch path) on the CPU at a small size: `correct` against its
faults and its control, the plain reference against the port's first three
steps, and the readers of its metrics that read the program's spans and
the optimizer's bytes, on hand-built traces; on the card, the cell's own
size (marked `cuda`)."""

from __future__ import annotations

import importlib.util
import json
from types import SimpleNamespace

import pytest
import torch

from bench_port import checks, manifest
from bench_port.drivers import common as C
from bench_port.manifest import HERE
from bench_port.tests import test_bench_port_faults as F
from bench_port.tests import test_bench_port_reference as R
from bench_port.trace import Traced

CELL = "n3dmm.train_b256"
GRAPH = "train/0a1b2c3d/ori"


def test_sound_run_is_correct(small_cell):
    res = F._run(small_cell(CELL), CELL)
    assert res["correct"], res["checks"]


def test_state_unchanged(small_cell, monkeypatch):
    from semantichuman_torch.train.optim import Adam

    monkeypatch.setattr(Adam, "update_", lambda self, *a, **k: None)
    monkeypatch.setattr(Adam, "update", lambda self, g, s, p: (
        F._zeros_like_tree(g), s))
    res = F._run(small_cell(CELL), CELL)
    assert not res["correct"]
    assert res["checks"]["delta_gap"]["value"] > \
        res["checks"]["delta_gap"]["limit"]


def test_half_batch(small_cell, monkeypatch):
    from semantichuman_torch.data.device_data import DeviceDataSource
    real = DeviceDataSource.batch_fn

    def half(self, idx):
        h = idx[:idx.shape[0] // 2]
        return real(self, torch.cat([h, h]))

    monkeypatch.setattr(DeviceDataSource, "batch_fn", half)
    res = F._run(small_cell(CELL), CELL)
    assert not res["correct"], res["checks"]


def test_control_bf16_trunk(small_cell):
    from bench_port.tools.readings import train_reading
    spec = small_cell(CELL)
    nums = train_reading(CELL, spec, F.SEED, "control", "cpu")
    assert not checks.correct(checks.judge(nums, spec["limits"])), nums


def test_timed_path_is_the_epoch_path(small_cell):
    """The cell's Trainer takes the epoch path, and the reference follows
    its first three steps to float32's tolerance."""
    spec = small_cell(CELL)
    from bench_port.drivers import train as T
    trainer, _inputs = T._trainer(spec["config"], spec["traffic"], 5, "cpu",
                                  "test")
    assert trainer._epoch_scan_ok()
    prog, ref = R._steps(spec, 2 ** 31 + 25, "cpu")
    for p, r in zip(prog["loss"], ref["loss"]):
        assert abs(p - r) <= R.TOL * abs(r)
    for key in ("grad", "delta"):
        scale = max(ref[key])
        for p, r in zip(prog[key], ref[key]):
            assert abs(p - r) <= R.TOL * max(r, scale * 1e-3), key


# --- the readers ----------------------------------------------------------

def _module(name):
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(tr, steps=2):
    config = json.loads((HERE / "configs" / "n3dmm.json").read_text())
    return SimpleNamespace(
        traced=tr, config=config, shape=C.model_shape(config),
        out={"traced_call": (2, 2, 0.0), "steps_per_epoch": steps})


def _adam_ops(t0):
    """One step's Adam as the trace shows it: the coupled decay (a
    foreach kernel), two per-leaf divisions, the square root and the
    update (foreach), the step's counter after it; 0.1 s of foreach and
    0.05 s of elementwise kernels inside, 0.01 s after."""
    fe = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
    ew = "void at::native::vectorized_elementwise_kernel<4, DivFunctor>"
    return [(fe, t0, t0 + 0.04), (ew, t0 + 0.04, t0 + 0.065),
            (ew, t0 + 0.065, t0 + 0.09), (fe, t0 + 0.09, t0 + 0.12),
            (fe, t0 + 0.12, t0 + 0.15), (ew, t0 + 0.15, t0 + 0.16)]


def _step_trace(replayed=2):
    """A fit over [0, 10] s with two steps: each a conv kernel, global
    norm's reduce and square root, then Adam; before them the chunk's
    state copied into the epoch buffers (foreach copies and the counters
    set); a validation whose foreach kernel is not counted; `replayed`
    replay spans."""
    fe = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
    ops = [("Memcpy HtoD (Pageable -> Device)", 0.3, 0.31), (fe, 0.31, 0.4),
           (fe, 0.4, 0.5), ("void at::native::vectorized_elementwise_kernel"
                            "<4, FillFunctor>", 0.5, 0.51)]
    for t0 in (1.0, 4.0):
        ops += [("void sc_fwd_tile_kernel<float, 64, 64, 4>", t0, t0 + 0.5),
                ("void at::native::reduce_kernel<512, 1>", t0 + 0.5,
                 t0 + 0.6),
                ("void at::native::vectorized_elementwise_kernel<4, sqrt>",
                 t0 + 0.6, t0 + 0.61)]
        ops += _adam_ops(t0 + 0.7)
    ops += [(fe, 8.2, 8.3)]
    return Traced(
        spans=[("window", 0.0, 12.0), ("fit", 0.0, 10.0),
               ("validate", 8.0, 9.0)],
        host=[(f"sh:replay/{GRAPH}", 1.0 + 3 * i, 1.1 + 3 * i)
              for i in range(replayed)] + [("sh:trainer.stage", 0.1, 0.2)],
        ops=ops)


def test_replay_share():
    """Two replays in a fit of two steps: 100 %; one: 50 %; a replay
    after the fit does not count."""
    mod = _module("replay_share.n3dmm")
    assert mod.read(_ctx(_step_trace())) == pytest.approx(100.0)
    assert mod.read(_ctx(_step_trace(1))) == pytest.approx(50.0)
    tr = _step_trace(1)
    tr.host.append((f"sh:replay/{GRAPH}", 11.0, 11.1))
    assert mod.read(_ctx(tr)) == pytest.approx(50.0)


def test_adam_bytes_and_parameters():
    """28,557,347 parameters (the port's SpiralAE at nz 256: nine convs
    and two dense layers of 432 x 128 rows by 256), 7 x 4 bytes each."""
    mod = _module("optimizer_roofline.n3dmm")
    shape = _ctx(Traced()).shape
    assert mod.n_params(shape) == 28557347
    assert mod.adam_bytes(10) == 280
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.models import build_model
    from semantichuman_torch.topology import MeshHierarchy
    from semantichuman_torch.utils.params import tree_leaves
    config = _ctx(Traced()).config
    model = build_model(ModelConfig(**config["model"]),
                        MeshHierarchy.load(str(C.topology_path(config))),
                        device="cpu")
    assert sum(p.numel() for p in tree_leaves(model.init(0))) == \
        mod.n_params(shape)


def test_optimizer_roofline():
    """Each step's Adam from its first to its last foreach kernel, 0.15 s,
    twice; the staging's copies, the square root before Adam, the counter
    after it and the validation's kernel left out: the least time of two
    steps over 0.3 s."""
    mod = _module("optimizer_roofline.n3dmm")
    ctx = _ctx(_step_trace())
    want = 100.0 * 2 * mod.adam_bytes(28557347) / 3.35e12 / 0.3
    assert mod.read(ctx) == pytest.approx(want)
    runs = mod.update_runs(ctx.traced.ops, [(0.0, 10.0)], [(8.0, 9.0)])
    assert runs == pytest.approx([0.15, 0.15])


def test_stage_and_val_share():
    """stage_share.n3dmm: the 0.1 s staging span over the 10 s fit, 1 %,
    and nothing where the Trainer staged nothing (the loop);
    val_share.n3dmm: the epochs' seconds outside their train chunks."""
    stage = _module("stage_share.n3dmm")
    assert stage.read(_ctx(_step_trace())) == pytest.approx(1.0)
    tr = _step_trace()
    tr.host.remove(("sh:trainer.stage", 0.1, 0.2))
    assert stage.read(_ctx(tr)) is None
    ctx = _ctx(Traced())
    ctx.out["history"] = [{"sec": 4.0, "train_sec": 3.0},
                          {"sec": 6.0, "train_sec": 5.0}]
    assert _module("val_share.n3dmm").read(ctx) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["replay_share.n3dmm",
                                  "optimizer_roofline.n3dmm",
                                  "conv_dx_roofline.n3dmm"])
def test_silent_without_replays(name):
    """A Trainer that trains through its eager loop records no replay:
    these read nothing."""
    assert _module(name).read(_ctx(_step_trace(0))) is None


def test_optimizer_roofline_silent_when_a_step_is_not_found():
    """A step whose Adam is not found (here: broken by a copy) leaves the
    metric out rather than count another step's kernels."""
    tr = _step_trace()
    tr.ops.append(("Memcpy DtoD (Device -> Device)", 1.79, 1.79))
    assert _module("optimizer_roofline.n3dmm").read(_ctx(tr)) is None


@pytest.mark.cuda
def test_training_steps_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = manifest.cell(manifest.load(C.ROOT), C.ROOT, CELL)
    prog, ref = R._steps(spec, 2 ** 31 + 26, "cuda")
    assert checks.correct(checks.judge(checks.train_numbers(prog, ref),
                                       spec["limits"]))
