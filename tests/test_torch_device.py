"""The port's device policy, on the CPU: its entry points run on the card
unless the caller names the CPU, and raise where there is no card."""

import numpy as np
import pytest
import torch

from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.ops.mel import MelSpectrogram
from prodiff_tpu_torch.pe.acf import ACF
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
    ["train", "dur", "--config", "train.yaml", "--exp_name", "exp"],
    ["train", "pitch", "--config", "train.yaml", "--exp_name", "exp"],
    ["train", "vari", "--config", "train.yaml", "--exp_name", "exp"],
    ["train", "svs_rectified", "--config", "train.yaml", "--exp_name", "exp"],
    ["binarize", "dur", "--config", "data.yaml", "--exp_name", "exp"],
    ["binarize", "pitch", "--config", "data.yaml", "--exp_name", "exp"],
    ["binarize", "svs", "--config", "data.yaml", "--exp_name", "exp"],
    ["binarize", "vari", "--config", "data.yaml", "--exp_name", "exp"],
    ["binarize", "svs_rectified", "--config", "data.yaml", "--exp_name", "exp"],
    ["infer", "song.ds", "--exp_name", "exp", "--spk_name", "spk0", "--isolate_aspiration"],
    ["infer", "song.ds", "--exp_name", "exp", "--spk_name", "spk0", "--isolate_aspiration",
     "--isolate_base_harmonic"],
    ["vocode", "wav2wav", "in.wav", "--config", "vocoder.yaml"],
])
def test_cli_defaults_to_the_card(no_cuda, argv, tmp_path, monkeypatch):
    """``--device`` defaults to ``cuda``: without a card the CLI stops before
    it reads the experiment."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli(argv)


@pytest.mark.parametrize("name", ["nsfhifigan", "fastdiff", "hifigan", "pwg"])
def test_vocoders_default_to_the_card(no_cuda, name):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        get_vocoder_cls(name)({}, state_dict={}, config={})


def test_mel_and_pitch_default_to_the_card(no_cuda, tmp_path):
    """``MelSpectrogram``, ``ACF`` and the vocoders' ``wav2spec`` run on the
    card unless given the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MelSpectrogram()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ACF({})
    from scipy.io import wavfile

    wavfile.write(str(tmp_path / "in.wav"), 44100, np.zeros(4096, np.float32))
    hp = {"audio_sample_rate": 44100, "audio_num_mel_bins": 16, "fft_size": 512,
          "win_size": 512, "hop_size": 128, "fmin": 40, "fmax": 16000}
    for name in ("nsfhifigan", "fastdiff", "hifigan", "pwg"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            get_vocoder_cls(name).wav2spec(str(tmp_path / "in.wav"), hp)
        _, mel = get_vocoder_cls(name).wav2spec(str(tmp_path / "in.wav"), hp, device="cpu")
        assert mel.shape == (4096 // 128, 16)
    assert MelSpectrogram(device="cpu").device == torch.device("cpu")


def test_trainer_defaults_to_the_card(no_cuda, tmp_path):
    hp = {"work_dir": str(tmp_path / "work")}
    for asked in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Trainer(hp, device=asked)
    assert Trainer(hp, device="cpu").device == torch.device("cpu")


def test_data_pipeline_defaults_to_the_card(no_cuda, tmp_path):
    """RMVPE, the VR separation, the k-th harmonic and the binarizers' mel run
    on the card unless given the CPU; given the CPU, they go on (to the
    missing checkpoint, or to the result)."""
    from prodiff_tpu_torch.binarize.utils import get_kth_harmonic, get_mel_spec
    from prodiff_tpu_torch.pe.rmvpe import RMVPE
    from prodiff_tpu_torch.separation import extract_harmonic_aperiodic

    absent = str(tmp_path / "absent" / "model.pt")
    wav = np.sin(np.arange(8192) * 0.05).astype(np.float32)
    for call in (lambda **kw: RMVPE({"pe_ckpt": absent}, **kw),
                 lambda **kw: extract_harmonic_aperiodic(wav, absent, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
        with pytest.raises(FileNotFoundError):
            call(device="cpu")
    args = (0, wav, np.full(40, 220.0), 256, 1024, 44100)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        get_kth_harmonic(*args)
    assert get_kth_harmonic(*args, device="cpu").shape == wav.shape
    mel_args = (wav, 44100, 16, 1024, 1024, 256, 40, 16000)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        get_mel_spec(*mel_args)
    assert get_mel_spec(*mel_args, device="cpu").shape == (32, 16)


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


def test_train_svs_rectified_runs_on_the_cpu_when_named(no_cuda, tmp_path, monkeypatch):
    """``train svs_rectified`` raises without a card and trains (3 steps) on
    a synthetic triplet set with ``--device cpu``."""
    import yaml

    from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams

    monkeypatch.chdir(tmp_path)
    make_svs_dataset(str(tmp_path), task="svs_rectified", rectified=True, n_train=4, n_valid=2)
    hp = small_hparams(str(tmp_path), task="svs_rectified", max_updates=3)
    for key in ("task", "work_dir"):
        hp.pop(key)
    (tmp_path / "rect.yaml").write_text(yaml.dump(hp))
    argv = ["train", "svs_rectified", "--config", "rect.yaml", "--exp_name", "exp"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_cli(argv)
    assert not (tmp_path / "checkpoints").exists()
    port_cli(argv + ["--device", "cpu"])
    assert (tmp_path / "checkpoints" / "exp" / "svs_rectified" / "model_ckpt_steps_3.ckpt").exists()


@pytest.mark.parametrize("argv", [["merge_rectified", "a.ckpt", "b.ckpt"],
                                  ["convert_ckpt", "ref.ckpt", "--config", "c.yaml"]])
def test_checkpoint_commands_take_no_device(no_cuda, argv, tmp_path, monkeypatch):
    """``merge_rectified`` and ``convert_ckpt`` do no device work: they take
    no ``--device`` and need no card (here they stop at the missing file)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        port_cli(argv + ["--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        port_cli(argv)
