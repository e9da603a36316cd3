"""The port's device policy, on the CPU: its entry points run on the card
unless the caller names the CPU, and raise where there is no card."""

import pytest
import torch

from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.training.trainer import Trainer
from prodiff_tpu_torch.vocoders import get_vocoder_cls


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_card(no_cuda):
    for asked in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve_device(asked)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("argv", [
    ["infer", "song.ds", "--exp_name", "exp", "--spk_name", "spk0"],
    ["web", "--exp_name", "exp"],
    ["train", "svs", "--config", "train.yaml", "--exp_name", "exp"],
])
def test_cli_defaults_to_the_card(no_cuda, argv, tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``: without a card the CLI stops before
    it reads the experiment."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli(argv)


@pytest.mark.parametrize("name", ["nsfhifigan", "fastdiff"])
def test_vocoders_default_to_the_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        get_vocoder_cls(name)({}, state_dict={}, config={})


def test_trainer_defaults_to_the_card(no_cuda, tmp_path):
    hp = {"work_dir": str(tmp_path / "work")}
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Trainer(hp, device=asked)
    assert Trainer(hp, device="cpu").device == torch.device("cpu")


def test_train_cli_stops_before_writing_without_a_card(no_cuda, tmp_path, monkeypatch):
    """Without a card the train CLI writes no work dir; ``--device cpu``
    goes on to read the config (missing here)."""
    monkeypatch.chdir(tmp_path)
    argv = ["train", "svs", "--config", "train.yaml", "--exp_name", "exp"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli(argv)
    assert not (tmp_path / "checkpoints").exists()
    with pytest.raises(FileNotFoundError, match="config"):
        port_cli(argv + ["--device", "cpu"])
