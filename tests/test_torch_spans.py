"""Program spans and replay-aware launch counters (`utils/profiling.py:
span`, `ops/launches.py`, `train/graph.py`): spans only while a profiler
records, as operator events that never nest, around the Trainer's and the
bundle's phases; a capture's launch record and the replays that add it; the
conv backward's dx calls by route and shape.

Imports neither JAX nor the JAX package, so the card test runs on a GPU
machine without them:

    python -m pytest --noconftest -q -m cuda tests/test_torch_spans.py
"""

import importlib
import json
import types
import warnings

import numpy as np
import pytest
import torch

from semantichuman_torch.ops import launches
from semantichuman_torch.train import graph as G
from semantichuman_torch.utils import profiling as TP

# the module: `semantichuman_torch.ops.spiral_conv` is the function
SC = importlib.import_module("semantichuman_torch.ops.spiral_conv")
SLIM = {"filter_sizes_enc": [[3, 8, 8, 16, 16], [[], [], [], [], []]],
        "filter_sizes_dec": [[16, 16, 8, 8, 8], [[], [], [], [], 3]],
        "part_shape_latent_size": 8, "part_kps_latent_size": 8}
N_THETA, N_PHI = 12, 24


def _profiled(fn):
    """Run fn under a CPU profile: -> (fn's result, the trace's events)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, prof


def _program_spans(prof, tmp_path) -> list:
    """(name, category, start, end) of every sh: event of a profile's
    Chrome trace, in the order they start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return sorted(((e["name"], e.get("cat"), e["ts"], e["ts"] + e["dur"])
                   for e in json.loads(path.read_text())["traceEvents"]
                   if e.get("name", "").startswith(TP.SPAN_PREFIX)
                   and e.get("ph") == "X"), key=lambda x: x[2])


def _assert_leaves(spans):
    """No program span encloses another."""
    for (n0, _c0, s0, e0), (n1, _c1, s1, e1) in zip(spans, spans[1:]):
        assert s1 >= e0, f"{n1} starts inside {n0}"


def test_span_off_enters_no_range(monkeypatch):
    """With no profiler running, span() checks the flag and enters no
    record function: the range class, made to raise, is never built."""
    def boom(*a, **k):
        raise AssertionError("a range was built with the profiler off")

    monkeypatch.setattr(TP, "_Range", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    with TP.span("trainer.stage"):
        x = torch.ones(3).add_(1)
    assert float(x.sum()) == 6.0
    with pytest.raises(AssertionError):
        _profiled(lambda: TP.span("x").__enter__())


def test_span_on_is_an_operator_event(tmp_path):
    """Under a profile a span is an sh: event of the operator category
    (`cpu_op`), never a user annotation."""
    def body():
        with TP.span("serve.input"):
            torch.ones(4).add_(1)

    _out, prof = _profiled(body)
    spans = _program_spans(prof, tmp_path)
    assert [(n, c) for n, c, _s, _e in spans] == [("sh:serve.input",
                                                   "cpu_op")]


# --- the Trainer ------------------------------------------------------------

def _trainer(tmp_path, name, n_train=8, **train):
    from semantichuman_torch.config import Config
    from semantichuman_torch.train.loop import Trainer

    wd = tmp_path / name
    wd.mkdir()
    cfg = Config.from_dict({
        "model": dict(SLIM),
        "data": {"synthetic": True, "synthetic_train": n_train,
                 "synthetic_test": 4, "synthetic_n_theta": N_THETA,
                 "synthetic_n_phi": N_PHI, "normalization": "zeroroot"},
        "train": {"n_epochs": 1, "batch_train": 4, "batch_interp": 4,
                  "batch_test": 4, "log_every": 0, "save_recons": False,
                  "data_parallel": False, **train}})
    return Trainer(cfg, str(wd), device="cpu")


@pytest.fixture(scope="module")
def trainer_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("spans_trainer")


@pytest.mark.parametrize("epoch_scan,want", [
    (True, {"sh:trainer.stage", "sh:trainer.step", "sh:trainer.read",
            "sh:trainer.validate", "sh:trainer.epoch_host"}),
    (False, {"sh:trainer.batch", "sh:trainer.step", "sh:trainer.validate",
             "sh:trainer.epoch_host"})])
def test_trainer_fit_spans(trainer_dir, tmp_path, epoch_scan, want):
    """A profiled fit of a small Trainer on the CPU, on the epoch path and
    on the loop: its phases as sh: operator events, none inside another,
    one step span a step."""
    tr = _trainer(trainer_dir, f"fit_{epoch_scan}", epoch_scan=epoch_scan)
    assert tr._epoch_scan_ok() == epoch_scan
    _out, prof = _profiled(tr.fit)
    spans = _program_spans(prof, tmp_path)
    assert {n for n, _c, _s, _e in spans} == want
    assert {c for _n, c, _s, _e in spans} == {"cpu_op"}
    _assert_leaves(spans)
    assert sum(n == "sh:trainer.step" for n, *_x in spans) == tr.global_step


def test_dx_counter_after_one_cpu_step(trainer_dir):
    """One training step on the CPU counts each conv's dx, route plain, at
    that model's shapes: every conv but the first (whose input needs no
    gradient), at the trunk batch."""
    tr = _trainer(trainer_dir, "dx", n_train=4, epoch_scan=True)
    launches.reset()
    tr.fit()
    assert tr.global_step == 1
    got = launches.read()["spiral_conv_dx"]
    t = tr.cfg.train
    b = t.batch_train + 2 * t.batch_interp
    sizes = tr.hierarchy.sizes
    want = {}
    for lvl, c_in, c_out, _act in tr.model.enc_plan[1:] + tr.model.dec_plan:
        key = (b, sizes[lvl] + 1, tr.model.tables.spiral_sizes[lvl], c_in,
               c_out)
        want[key] = want.get(key, 0) + 1
    assert {k.split(":")[0] for k in got} == {"plain"}
    shapes = {tuple(map(int, k.split(":")[1].split(","))): v
              for k, v in got.items()}
    assert shapes == want


# --- the bundle ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_bundle(tmp_path_factory):
    from semantichuman_torch.config import ModelConfig
    from semantichuman_torch.data.synthetic import SyntheticHuman
    from semantichuman_torch.models import build_model
    from semantichuman_torch.serving import ServingBundle, export_inference
    from semantichuman_torch.topology import compile_topology

    h = SyntheticHuman(n_theta=N_THETA, n_phi=N_PHI)
    d = tmp_path_factory.mktemp("spans_bundle")
    hier = compile_topology(h.template_verts, h.template_faces,
                            reference_vertex=min(414,
                                                 len(h.template_verts) - 1),
                            cache_path=str(d / "topology.npz"))
    model = build_model(ModelConfig(**SLIM), hier, h.part_dict, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        export_inference(model, model.init(0), h.J_regressor,
                         str(d / "bundle"), batch_size=2)
    return ServingBundle(str(d / "bundle"), device="cpu"), h


def test_bundle_call_spans(cpu_bundle, tmp_path):
    """A profiled ServingBundle.call on the CPU: the argument's copy onto
    the device and the eager program as sh: operator events, neither
    inside the other."""
    bundle, h = cpu_bundle
    v = np.concatenate([h.sample_meshes(2, seed=1),
                        np.zeros((2, 1, 3))], axis=1).astype(np.float32)
    _out, prof = _profiled(lambda: bundle.call("encode", v))
    spans = _program_spans(prof, tmp_path)
    assert [n for n, *_x in spans] == ["sh:serve.input", "sh:serve.eager"]
    assert {c for _n, c, _s, _e in spans} == {"cpu_op"}
    _assert_leaves(spans)


# --- the capture record -------------------------------------------------------

@pytest.fixture
def fake_counters(monkeypatch):
    """launches' counters swapped for fakes, and no graph known."""
    fns = {k: types.SimpleNamespace(launches=0)
           for k in ("spiral_conv_fwd", "row_gather", "csr_reduce")}
    modes, dx, dw = {"fwd": 0, "fwd_grad": 0}, {}, {}
    monkeypatch.setattr(launches, "_counters",
                        lambda: (fns, modes, dx, dw))
    monkeypatch.setattr(launches, "_GRAPHS", {})
    return fns, modes, dx, dw


def test_capture_record_and_replays(fake_counters):
    """What the counters gain inside a recorded capture is its record;
    k replays add k x the record, and the graph counts follow."""
    fns, modes, dx, dw = fake_counters
    fns["row_gather"].launches = 5          # before the capture: not in it
    dw["128,10,9,16,32:16"] = {"calls": 1, "rows": 5, "entries": 9}
    with launches.recording("train/abc/ori") as rec:
        fns["spiral_conv_fwd"].launches += 9
        fns["row_gather"].launches += 2
        modes["fwd_grad"] += 2
        dx["fused:128,10,9,16,32"] = dx.get("fused:128,10,9,16,32", 0) + 1
        for kind, n in (("calls", 1), ("rows", 5), ("entries", 9)):
            dw["128,10,9,16,32:16"][kind] += n
    one = {"calls": 1, "rows": 5, "entries": 9}
    want = {"spiral_conv_fwd": 9, "row_gather": 2, "part_dist_fwd_grad": 2,
            "spiral_conv_dx": {"fused:128,10,9,16,32": 1},
            "spiral_conv_dw": {"128,10,9,16,32:16": one}}
    assert rec == want == launches.graph_record("train/abc/ori")
    at_capture = launches.read()
    k = 4
    graph = G.Graph(types.SimpleNamespace(replay=lambda: None),
                    "train/abc/ori", rec)
    for _ in range(k):
        graph.replay()
    got = launches.read()
    assert got["spiral_conv_fwd"] == 9 * (k + 1)
    assert got["row_gather"] == 5 + 2 * (k + 1)
    assert got["part_dist_fwd_grad"] == 2 * (k + 1)
    assert got["part_dist_fwd"] == 0 and got["csr_reduce"] == 0
    assert got["spiral_conv_dx"] == {"fused:128,10,9,16,32": k + 1}
    assert got["spiral_conv_dw"] == {"128,10,9,16,32:16": {
        kind: n * (k + 2) for kind, n in one.items()}}
    assert got["graph_captures"] == {"total": 1,
                                     "by_name": {"train/abc/ori": 1}}
    assert got["graph_replays"] == {"total": k,
                                    "by_name": {"train/abc/ori": k}}
    d = launches.diff(got, at_capture)
    assert d["spiral_conv_fwd"] == 9 * k
    assert d["spiral_conv_dx"] == {"fused:128,10,9,16,32": k}
    assert d["spiral_conv_dw"] == {"128,10,9,16,32:16": {
        kind: n * k for kind, n in one.items()}}
    launches.reset()
    zero = launches.read()
    assert zero["spiral_conv_fwd"] == 0 and zero["spiral_conv_dx"] == {}
    assert zero["spiral_conv_dw"] == {}
    assert zero["graph_replays"] == {"total": 0, "by_name": {}}
    assert launches.graph_record("train/abc/ori") == want
    launches.restore(got)
    assert launches.read() == got


def test_read_names_every_counter():
    """read() holds every kernel counter as an int, the dx and dW calls
    and the graph counts; restore(read()) changes nothing."""
    got = launches.read()
    ints = {k for k, v in got.items() if not isinstance(v, dict)}
    assert {"spiral_conv_fwd", "spiral_conv_bwd_dx", "row_gather",
            "part_dist_fwd_grad"} <= ints
    assert set(got) - ints == {"spiral_conv_dx", "spiral_conv_dw",
                               "graph_captures", "graph_replays"}
    launches.restore(got)
    assert launches.read() == got


# --- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_replays_count_and_stay_off_the_device_timeline():
    """On the card: after k replays of a captured conv step (forward and
    backward at batch 32, its dx fused), launches.read() is the reading
    after the capture plus k x the graph's record, the dW calls' window
    rows and entries included; a profiled replay shows
    its sh:replay span on the host and no sh: event among the device's
    operations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from semantichuman_torch.models.tables import inverse_spiral_csr
    from semantichuman_torch.ops.csr_reduce import CSRTable

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, v1, s, c, co = 32, 200, 9, 16, 32
    idx = rng.integers(0, v1 - 1, (v1, s)).astype(np.int32)
    idx[-1] = v1 - 1
    spiral = torch.from_numpy(idx).to(dev)
    csr = CSRTable.build(*inverse_spiral_csr(idx), n_src=idx.size,
                         device=dev)
    x = torch.randn(b, v1, c, device=dev)
    x[:, -1] = 0
    x.requires_grad_(True)
    w = torch.randn(s * c, co, device=dev, requires_grad=True)
    bias = torch.zeros(co, device=dev, requires_grad=True)

    def step():
        y = SC.spiral_conv(x, spiral, w, bias, "elu", csr=csr)
        return torch.autograd.grad(y.square().sum(), (x, w))

    G.warm_up(step, lambda: None, "test/conv")
    graph = G.capture(step, torch.cuda.graph_pool_handle(), "test/conv")
    rec = launches.graph_record("test/conv")
    assert rec["spiral_conv_fwd"] == 1 and rec["spiral_conv_bwd_dx"] == 1
    assert rec["spiral_conv_dx"] == {f"fused:{b},{v1},{s},{c},{co}": 1}
    (dw_key, dw_rec), = rec["spiral_conv_dw"].items()
    assert dw_key.startswith(f"{b},{v1},{s},{c},{co}:") and \
        dw_rec["calls"] == 1
    at_capture = launches.read()
    k = 5
    for _ in range(k):
        graph.replay()
    torch.cuda.synchronize()
    got = launches.read()
    for key, n in at_capture.items():
        if key in ("spiral_conv_dx", "spiral_conv_dw", "graph_captures",
                   "graph_replays"):
            continue
        assert got[key] == n + k * rec.get(key, 0), key
    assert got["spiral_conv_dx"][f"fused:{b},{v1},{s},{c},{co}"] == \
        at_capture["spiral_conv_dx"][f"fused:{b},{v1},{s},{c},{co}"] + k
    assert got["spiral_conv_dw"][dw_key] == {
        kind: n + k * dw_rec[kind]
        for kind, n in at_capture["spiral_conv_dw"][dw_key].items()}
    assert got["graph_replays"]["by_name"]["test/conv"] == \
        at_capture["graph_replays"]["by_name"].get("test/conv", 0) + k

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    graph.replay()
    torch.cuda.synchronize()
    prof.stop()
    events = list(prof.profiler.kineto_results.events())
    on_device = [e.name() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    on_host = [e.name() for e in events
               if e.device_type() != torch.autograd.DeviceType.CUDA]
    assert on_device, "the profiler saw no device operation"
    assert not [n for n in on_device if n.startswith(TP.SPAN_PREFIX)]
    assert "sh:replay/test/conv" in on_host
