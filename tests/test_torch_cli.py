"""The port's training CLI, the counterpart of
tests/test_cli.py::test_train_cli_config_overrides: how
`semantichuman_torch/cli/train.py` folds its flags into the config, with a
stand-in Trainer."""

from semantichuman_torch.cli import train as T
from semantichuman_torch.train import loop as L


def test_train_cli_config_overrides(monkeypatch, tmp_path):
    """--epochs must land on cfg.train.n_epochs (the lr schedule is built
    from it when the Trainer is made, not from fit()'s argument), and an
    explicit CLI resume flag must replace the config's resume PAIR so a
    yaml train.resume cannot trip the resume-xor-resume_torch check."""
    captured = {}

    class FakeTrainer:
        _is_main = True

        def __init__(self, cfg, workdir, device="cuda"):
            captured["cfg"] = cfg
            captured["device"] = device

        def fit(self, n_epochs=None):
            captured["fit_n"] = n_epochs

        def export_predictions(self):
            return (None, None, None, None, 0.0, 0.0)

    monkeypatch.setattr(L, "Trainer", FakeTrainer)

    cfgfile = tmp_path / "cfg.yaml"
    cfgfile.write_text(
        "train:\n  n_epochs: 1600\n  resume: /stale/checkpoint/dir\n")

    T.main(["--workdir", str(tmp_path / "w"), "--config", str(cfgfile),
            "--epochs", "7", "--resume_torch", "ck.pth.tar",
            "--synthetic", "--device", "cpu"])
    cfg = captured["cfg"]
    assert cfg.train.n_epochs == 7
    assert captured["fit_n"] is None        # fit() reads cfg.train.n_epochs
    assert cfg.train.resume is None         # CLI flag replaced the pair
    assert cfg.train.resume_torch == "ck.pth.tar"
    assert cfg.data.synthetic and captured["device"] == "cpu"

    # no CLI resume flags: the yaml's resume survives --finetune
    T.main(["--workdir", str(tmp_path / "w2"), "--config", str(cfgfile),
            "--finetune", "--synthetic", "--device", "cpu"])
    cfg = captured["cfg"]
    assert cfg.train.resume == "/stale/checkpoint/dir"
    assert cfg.train.resume_torch is None
    assert cfg.train.finetune
