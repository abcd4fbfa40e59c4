"""The port's device-resident data gate, the counterpart of
tests/test_device_data.py::test_trainer_auto_respects_budget: the
Trainer's byte budget (`train/loop.py:_maybe_stage_device_data`) on the
small synthetic human on the CPU."""

import pytest
import torch

from semantichuman_torch.config import Config
from semantichuman_torch.data.device_data import DeviceBatchLoader
from semantichuman_torch.train.loop import Trainer

from tests.conftest import SMALL_MODEL_OVERRIDES

torch.set_num_threads(1)

BASE = {
    "model": dict(SMALL_MODEL_OVERRIDES),
    "data": {"synthetic": True, "synthetic_train": 16,
             "synthetic_test": 8, "synthetic_n_theta": 16,
             "synthetic_n_phi": 36, "normalization": "zeroroot",
             "device_resident_max_gb": 1e-6},
    "train": {"n_epochs": 1, "batch_train": 8, "batch_interp": 8,
              "batch_test": 8, "save_recons": False}}


def _cfg(**data):
    return Config.from_dict({**BASE, "data": {**BASE["data"], **data}})


def test_trainer_auto_respects_budget(tmp_path):
    """'auto' keeps the host loaders when the splits exceed the byte
    budget (and stages them under the default budget), and
    device_resident=True raises instead of falling back to the host."""
    t = Trainer(_cfg(), str(tmp_path / "auto"), device="cpu")
    assert t.device_data is None
    assert not isinstance(t.train_loader, DeviceBatchLoader)

    t = Trainer(_cfg(device_resident_max_gb=6.0), str(tmp_path / "fits"),
                device="cpu")
    assert t.device_data is not None
    assert isinstance(t.train_loader, DeviceBatchLoader)

    with pytest.raises(ValueError, match="cannot be staged"):
        Trainer(_cfg(device_resident=True), str(tmp_path / "forced"),
                device="cpu")
