"""The port's step timer, trace window and metrics logger
(`semantichuman_torch/utils/profiling.py`, `utils/logging.py`) against the
JAX package's, on the CPU."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils import logging as TLog
from semantichuman_torch.utils import profiling as TP
from semantichuman_tpu.utils import logging as JLog
from semantichuman_tpu.utils import profiling as JP

from tests.test_torch_trainer import _raw_cfg, _workdir
from tests.test_torch_trainer import topology_dir  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 10])
def test_step_timer_summary_matches_jax(n, tmp_path):
    """The same samples give the same summary keys and values, and
    skip_first drops the same warm-up steps."""
    samples = list(np.random.default_rng(n).uniform(0.01, 0.5, n))
    t, j = TP.StepTimer(skip_first=1), JP.StepTimer(skip_first=1)
    for timer in (t, j):
        with timer:
            pass
        timer.samples = list(samples)
    assert t.summary() == j.summary()
    assert t.save(str(tmp_path / "t.json")) == json.loads(
        (tmp_path / "t.json").read_text())
    with t:
        pass
    assert t.summary()["steps"] == n + 1


def test_trace_context_writes_a_trace(tmp_path):
    with TP.trace(str(tmp_path / "prof")) as d:
        torch.ones(8).add_(1)
    path = Path(d, "trace.rank0.pt.trace.json")
    assert "traceEvents" in json.loads(path.read_text())


def _losses(workdir) -> list:
    with open(Path(workdir, "summaries", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_trace_window(tmp_path, topology_dir):  # noqa: F811
    """A window over global steps [2, 5) of a 2-epoch fit (4 steps an
    epoch): one trace file with the steps' operators in it, written when
    step 5 begins; the window sends the Trainer to the loop (epoch_scan
    on), and its losses equal those of the loop's fit without a window bit
    for bit."""
    runs = {}
    for name, over in (("plain", {}),
                       ("window", {"profile_start": 2, "profile_stop": 5,
                                   "epoch_scan": True})):
        wd = _workdir(tmp_path / name, topology_dir)
        tr = TorchTrainer(TorchConfig.from_dict(_raw_cfg(log_every=1,
                                                         **over)),
                          wd, device="cpu")
        assert not tr._epoch_scan_ok()
        tr.fit()
        runs[name] = (tr, wd)
    tr, wd = runs["window"]
    files = os.listdir(Path(wd, "profile"))
    assert files == ["steps2-5.rank0.pt.trace.json"]
    assert tr.trace_window.path == str(Path(wd, "profile", files[0]))
    events = json.loads(Path(tr.trace_window.path).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)
    assert _losses(runs["plain"][1]) != [] and [
        {k: v for k, v in r.items() if k != "time"}
        for r in _losses(runs["plain"][1])] == [
        {k: v for k, v in r.items() if k != "time"} for r in _losses(wd)]


def test_trace_window_closes_an_open_window(tmp_path):
    """A window still open when the loop ends is written by close(); a
    window never reached writes nothing."""
    w = TP.TraceWindow(str(tmp_path / "a"), 1, 100)
    for step in range(3):
        w.tick(step)
        torch.ones(4).mul_(2)
    assert w.path is None
    w.close()
    assert Path(w.path).name == "steps1-100.rank0.pt.trace.json"
    never = TP.TraceWindow(str(tmp_path / "b"), 50, 60)
    for step in range(3):
        never.tick(step)
    never.close()
    assert never.path is None and not (tmp_path / "b").exists()


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metrics_logger_matches_jax(tmp_path, tensorboard):
    """The same JSONL records (but the time) from both loggers; with
    tensorboard, where the package imports, an events file beside them."""
    recs = []
    for name, mod in (("torch", TLog), ("jax", JLog)):
        d = tmp_path / name
        lg = mod.MetricsLogger(str(d), tensorboard=tensorboard)
        lg.log(3, {"loss": np.float32(0.5), "rec": 0.25})
        lg.log(1, {"epoch_train": 1.5}, prefix="epoch")
        lg.close()
        recs.append([{k: v for k, v in json.loads(line).items()
                      if k != "time"}
                     for line in (d / "metrics.jsonl").read_text()
                     .splitlines()])
        events = [f for f in os.listdir(d) if f.startswith("events.out")]
        if name == "torch":
            try:
                import torch.utils.tensorboard  # noqa: F401
                has_tb = True
            except ImportError:
                has_tb = False
            assert bool(events) == (tensorboard and has_tb)
    assert recs[0] == recs[1]
