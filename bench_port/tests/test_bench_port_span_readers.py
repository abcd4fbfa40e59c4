"""The readers of the program's spans and counters (`stage_share.*`,
`serve_input_ms`, `serve_launch_ms`, `conv_dx_roofline.train_large`) on
hand-built traces: each gives the hand-computed value, and nothing where
the program recorded no span or record."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_port import manifest
from bench_port.trace import Traced

GRAPH = "train/0a1b2c3d/dynamic"


def _read(name, tr):
    return manifest.metric_reader(name)(SimpleNamespace(traced=tr))


def _fit_trace() -> Traced:
    """One fit span over [0, 10] s: two staging spans inside it (1.0 and
    1.5 s) and one after it; three replays inside, one after; dx kernels
    0.5 + 0.25 s, a dW kernel beside them; an operator event that is no
    program span."""
    return Traced(
        spans=[("window", 0.0, 12.0), ("fit", 0.0, 10.0),
               ("validate", 8.0, 9.0)],
        host=[("sh:trainer.stage", 1.0, 2.0), ("aten::copy_", 1.2, 1.3),
              ("sh:trainer.stage", 5.0, 6.5), ("sh:trainer.stage", 11.0, 11.5),
              (f"sh:replay/{GRAPH}", 2.0, 2.1),
              (f"sh:replay/{GRAPH}", 2.2, 2.3),
              (f"sh:replay/{GRAPH}", 2.4, 2.5),
              (f"sh:replay/{GRAPH}", 11.6, 11.7),
              ("sh:trainer.read", 7.0, 7.5)],
        ops=[("void (anonymous namespace)::dx_short_kernel<16>(float)", 3.0,
              3.5),
             ("void (anonymous namespace)::dx_long_partial_kernel(float)",
              4.0, 4.25),
             ("void (anonymous namespace)::dw_partial_kernel(float)", 4.5,
              5.0)])


@pytest.mark.parametrize("name", ["stage_share.train",
                                  "stage_share.train_large"])
def test_stage_share(name):
    """(1.0 + 1.5) s of staging inside a 10-s fit: 25 %; the span after the
    fit is not counted."""
    assert _read(name, _fit_trace()) == pytest.approx(25.0)


def _serve_trace() -> Traced:
    """Two requests, [0, 1] and [2, 4] s: the first replays a graph (inputs
    0.1 + 0.05 s; copy-in 0.05, replay 0.1, clone 0.1), the second calls
    the program eagerly (input 0.4, eager 1.0); spans outside the requests
    and operator events are not counted."""
    return Traced(
        spans=[("window", 0.0, 6.0), ("request/encode/4", 0.0, 1.0),
               ("request/decode/1", 2.0, 4.0)],
        host=[("sh:serve.input", 0.1, 0.2), ("aten::to", 0.12, 0.18),
              ("sh:serve.input", 0.25, 0.3), ("sh:serve.copy_in", 0.3, 0.35),
              ("sh:replay/serve/encode/4", 0.35, 0.45),
              ("sh:serve.clone", 0.5, 0.6), ("sh:serve.input", 2.1, 2.5),
              ("sh:serve.eager", 2.6, 3.6), ("sh:serve.input", 5.0, 5.5),
              ("sh:replay/train/x/ori", 0.7, 0.8)])


def test_serve_input_ms():
    """((0.1 + 0.05) + 0.4) s over two requests: 275 ms."""
    assert _read("serve_input_ms", _serve_trace()) == pytest.approx(275.0)


def test_serve_launch_ms():
    """((0.05 + 0.1 + 0.1) + 1.0) s over two requests: 625 ms; a training
    graph's replay is not the bundle's."""
    assert _read("serve_launch_ms", _serve_trace()) == pytest.approx(625.0)


def test_conv_dx_roofline(monkeypatch):
    """Three replays inside the fit of a graph whose record holds one fused
    dx at (128, 1725, 9, 32, 64) and one unfused: the fused half's least
    time is its operations, 2 x 128 x 1725 x 9 x 32 x 64 = 8139571200 over
    67 TFLOP/s (its bytes, 84929932 over 3.35 TB/s, take less); three of
    them over the dx kernels' 0.75 s."""
    from semantichuman_torch.ops import launches
    record = {"spiral_conv_fwd": 9, "spiral_conv_dx": {
        "fused:128,1725,9,32,64": 1, "unfused:128,863,8,64,128": 1}}
    monkeypatch.setattr(launches, "graph_record",
                        lambda name: record if name == GRAPH else {})
    want = 100.0 * 3 * (8139571200 / 67e12) / 0.75
    assert 84929932 / 3.35e12 < 8139571200 / 67e12
    assert _read("conv_dx_roofline.train_large",
                 _fit_trace()) == pytest.approx(want)
    record["spiral_conv_dx"] = {"unfused:128,863,8,64,128": 1}
    assert _read("conv_dx_roofline.train_large", _fit_trace()) is None


@pytest.mark.parametrize("name", [
    "stage_share.train", "stage_share.train_large", "serve_input_ms",
    "serve_launch_ms", "conv_dx_roofline.train_large"])
def test_silent_without_program_spans(name):
    """A trace of a program that records no span (the harness's own spans,
    operator events and kernels alone) reads nothing."""
    tr = Traced(spans=[("window", 0.0, 5.0), ("fit", 0.0, 4.0),
                       ("request/encode/1", 0.0, 1.0)],
                host=[("aten::to", 0.1, 0.2), ("cudaGraphLaunch", 1.0, 1.1)],
                ops=[("dx_short_kernel", 0.5, 0.7)])
    assert _read(name, tr) is None
