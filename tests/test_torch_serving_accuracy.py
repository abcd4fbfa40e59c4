"""The port's serving dtype A/B (`semantichuman_torch/tools/
serving_accuracy.py`) against the JAX tool (`tools/serving_accuracy.py`):
the run's config read back from its train_params.txt, and one tiny run on
the CPU on parameters moved from JAX."""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from semantichuman_torch.config import Config as TorchConfig
from semantichuman_torch.tools import serving_accuracy as tool
from semantichuman_torch.train.loop import Trainer as TorchTrainer
from semantichuman_torch.utils.params import params_from_jax
from semantichuman_tpu.config import Config as JaxConfig
from semantichuman_tpu.train.loop import Trainer as JaxTrainer

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "serving_accuracy", REPO / "tools" / "serving_accuracy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_config_roundtrip_with_appended_dumps(tmp_path):
    """The first JSON object of train_params.txt, as the Trainer dumps it
    (cfg.to_dict, default=str); a resumed run's later dumps are skipped.
    Both tools read the same file into the same config."""
    cfg = TorchConfig()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              seed=7))
    dump = json.loads(json.dumps(
        {"git_sha": "x", "start_epoch": 1, "config": cfg.to_dict()},
        default=str))
    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    with open(ckpt / "train_params.txt", "w") as f:
        json.dump(dump, f, indent=2)
        f.write("\n")
        json.dump({"resumed": True}, f)
    got = tool._run_config(str(ckpt), None)
    assert got.train.seed == 7
    assert got.model.trunk_dtype == cfg.model.trunk_dtype
    assert got.to_dict() == _jax_tool()._run_config(str(ckpt),
                                                    None).to_dict()
    # the parent of a checkpoint step directory is searched too
    assert tool._run_config(str(ckpt / "3"), None).train.seed == 7


def test_run_config_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="train_params"):
        tool._run_config(str(tmp_path / "nope"), None)


RAW = {
    "model": dict(SMALL_MODEL_OVERRIDES, banded_conv=False),
    "data": {"synthetic": True, "synthetic_train": 8, "synthetic_test": 6,
             "synthetic_n_theta": 16, "synthetic_n_phi": 36,
             "normalization": "zeroroot"},
    "train": {"batch_train": 4, "batch_interp": 4, "batch_test": 4,
              "save_recons": False, "seed": 2},
}


def test_tool_on_jax_parameters(tmp_path):
    """The JAX Trainer's initial parameters, saved as a JAX checkpoint and,
    moved with params_from_jax, as the port's: the port's f32 arm gives the
    JAX tool's f32 mm within rtol 1e-5, and its bf16 arm a nonzero delta."""
    jt = JaxTrainer(JaxConfig.from_dict(RAW), str(tmp_path / "jax"))
    jt._dump_train_params()
    jt.save(1)
    jax_ckpt = str(tmp_path / "jax" / "checkpoints")
    jcfg = _jax_tool()._run_config(jax_ckpt, None)
    _jl1, jmm = _jax_tool()._eval_at(jcfg, jax_ckpt, "float32")

    tt = TorchTrainer(TorchConfig.from_dict(RAW), str(tmp_path / "torch"),
                      device="cpu")
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), "cpu")
    tt._dump_train_params()
    tt.save(1)
    out = tool.main(["--resume", str(tmp_path / "torch" / "checkpoints"),
                     "--device", "cpu"])
    assert out["f32_mm"] == pytest.approx(jmm, rel=1e-5)
    assert out["delta_mm"] != 0.0
    assert np.isfinite([out[k] for k in ("f32_l1", "bf16_l1", "bf16_mm")]
                       ).all()
    assert os.listdir(tmp_path / "torch" / "checkpoints") == ["1"] or \
        sorted(os.listdir(tmp_path / "torch" / "checkpoints")) == [
            "1", "train_params.txt"]
