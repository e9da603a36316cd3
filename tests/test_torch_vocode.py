"""The ``vocode wav2wav`` path of the PyTorch port vs the JAX package, on the CPU.

Mel (``ops/mel.py``), the ACF pitch extractor and its registry, ``load_wav``,
``interp_f0``, ``pad_frames``, the vocoders' ``wav2spec``/``spec2wav`` and the
``python -m prodiff_tpu_torch vocode wav2wav`` command against the JAX
package's functions and the JAX pipeline of ``main.py vocode wav2wav`` run
function by function on the same weights. Inputs are made with numpy from a
seed; vocoder checkpoints are written in the files both loaders read.
Tolerances: mel atol 1e-4 on the log-mel (float32 FFTs on both sides; the
inputs keep every mel bin well above the 1e-5 clip, where a float32 FFT's
error is relative to the frame's energy), the filterbank 1e-6 (the same
float64 numpy code), ACF f0 1e-3 relative with identical voicing, and the
written wavs 1e-4 of their peak plus one 16-bit step (``save_wav`` truncates
to int16, so a sample on a step edge may land on either side).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from prodiff_tpu.config import load_config as jax_load_config
from prodiff_tpu.models.fastdiff import sampling_given_noise_schedule as jax_sampling
from prodiff_tpu.ops.mel import MelSpectrogram as JaxMel
from prodiff_tpu.ops.mel import mel_filterbank as jax_filterbank
from prodiff_tpu.pe import get_pe_cls as jax_get_pe_cls
from prodiff_tpu.pe import pad_frames as jax_pad_frames
from prodiff_tpu.pe.acf import ACF as JaxACF
from prodiff_tpu.utils.audio import load_wav as jax_load_wav
from prodiff_tpu.utils.audio import save_wav as jax_save_wav
from prodiff_tpu.utils.pitch_utils import interp_f0 as jax_interp_f0
from prodiff_tpu.utils.pitch_utils import shift_pitch as jax_shift_pitch
from prodiff_tpu.vocoders import get_vocoder_cls as jax_get_vocoder_cls
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.models.fastdiff import FastDiff as FastDiffNet
from prodiff_tpu_torch.models.nsf_hifigan import Generator
from prodiff_tpu_torch.ops.mel import LN_TO_LOG10, MelSpectrogram, mel_filterbank
from prodiff_tpu_torch.pe import BasePitchExtractor, get_pe_cls, pad_frames
from prodiff_tpu_torch.pe.acf import ACF
from prodiff_tpu_torch.utils.audio import load_wav
from prodiff_tpu_torch.utils.pitch_utils import interp_f0
from prodiff_tpu_torch.vocoders import BaseVocoder, get_vocoder_cls
from prodiff_tpu_torch.vocoders.fastdiff import FastDiff as FastDiffVocoder
from tests.test_torch_vocoder import VOCODER_H

SR = 44100
# the base config's audio settings (prodiff_tpu/assets/base_config.yaml)
MEL_44K = dict(sr=SR, n_mels=128, n_fft=2048, win_size=2048, hop_length=512, fmin=40,
               fmax=16000)
NSF_AUDIO = {"audio_sample_rate": SR, "audio_num_mel_bins": 16, "fft_size": 512,
             "win_size": 512, "hop_size": 32, "fmin": 40, "fmax": 16000}
# a 2-layer FastDiff at 16 mel channels behind 22.05 kHz / hop 256 audio settings
FD_CFG = {
    "audio_channels": 1, "inner_channels": 32, "cond_channels": 16,
    "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 2, "lvc_kernel_size": 3,
    "kpnet_hidden_channels": 64, "kpnet_conv_size": 3, "diffusion_step_embed_dim_in": 128,
    "diffusion_step_embed_dim_mid": 512, "diffusion_step_embed_dim_out": 512,
    "beta_0": 1e-6, "beta_T": 0.01, "T": 1000,
}
FD_AUDIO = {"audio_sample_rate": 22050, "audio_num_mel_bins": 16, "fft_size": 1024,
            "win_size": 1024, "hop_size": 256, "fmin": 80, "fmax": 7600}


def vibrato_tone(seconds, sr=SR, f0=220.0, harmonics=1, noise_db=-30.0, gap=None, seed=0):
    """A seeded vibrato tone (f0 +- 1 semitone at 5 Hz) with ``harmonics``
    partials at 1/k, white noise ``noise_db`` below the tone's amplitude and
    an optional silent ``gap`` (start, end) in seconds; float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    phase = 2 * np.pi * np.cumsum(f0 * 2 ** (np.sin(2 * np.pi * 5 * t) / 12)) / sr
    y = sum(np.sin(k * phase) / k for k in range(1, harmonics + 1))
    y = 0.4 * y / np.abs(y).max()
    y = y + 0.4 * 10 ** (noise_db / 20) * rng.normal(size=t.shape)
    if gap is not None:
        y[int(gap[0] * sr):int(gap[1] * sr)] = 0.0
    return y.astype(np.float32)


def test_mel_filterbank_matches_jax():
    for sr, n_fft, n_mels, fmin, fmax in ((SR, 2048, 128, 40, 16000), (22050, 1024, 80, 80, 7600),
                                          (SR, 2435, 128, 40, None)):
        np.testing.assert_allclose(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                                   jax_filterbank(sr, n_fft, n_mels, fmin, fmax), atol=1e-6)


@pytest.mark.parametrize("keyshift", [0, 3, -2])
@pytest.mark.parametrize("speed", [1.0, 1.1])
def test_mel_matches_jax(keyshift, speed):
    """``get_mel`` and ``wav2mel_log10`` at the 44.1 kHz config, with the
    keyshift (resized FFT and window) and speed (hop) cases."""
    y = vibrato_tone(1.5, harmonics=8, noise_db=-10.0, seed=1)[None]
    port, ref = MelSpectrogram(**MEL_44K, device="cpu"), JaxMel(**MEL_44K)
    got = port.get_mel(torch.from_numpy(y), keyshift, speed).numpy()
    want = np.asarray(ref.get_mel(jnp.asarray(y), keyshift, speed))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    got10 = port.wav2mel_log10(y, keyshift, speed).numpy()
    np.testing.assert_allclose(got10, np.asarray(ref.wav2mel_log10(jnp.asarray(y), keyshift,
                                                                   speed)), atol=1e-4)
    np.testing.assert_array_equal(got10, (got * LN_TO_LOG10).transpose(0, 2, 1))


@pytest.mark.parametrize("interp_uv", [False, True])
def test_acf_matches_jax(interp_uv):
    """A 2 s vibrato tone (220 Hz +- 1 semitone), -30 dB noise, a silent gap:
    identical voicing, f0 within 1e-3 relative on the voiced frames."""
    y = vibrato_tone(2.0, gap=(0.8, 1.1), seed=2)
    n = len(y) // 512 + 1
    got_f0, got_uv = ACF({}, device="cpu").get_pitch(y, SR, n, hop_size=512, interp_uv=interp_uv)
    want_f0, want_uv = JaxACF({}).get_pitch(y, SR, n, hop_size=512, interp_uv=interp_uv)
    assert got_f0.shape == want_f0.shape == (n,)
    np.testing.assert_array_equal(got_uv, want_uv)
    assert 0 < want_uv.sum() < n - 20  # the gap is unvoiced, the tone voiced
    voiced = ~want_uv
    np.testing.assert_allclose(got_f0[voiced], want_f0[voiced], rtol=1e-3)
    if interp_uv:
        np.testing.assert_allclose(got_f0, want_f0, rtol=1e-3)
        assert (got_f0 > 0).all()
    else:
        assert (got_f0[got_uv] == 0).all()
    assert np.all(np.abs(np.log2(got_f0[voiced] / 220.0)) < 1.1 / 12)


def test_pe_registry():
    """``parselmouth`` without its library falls back to ACF, as in the JAX
    package; ``rmvpe`` is the port's RMVPE; an unknown name raises."""
    assert get_pe_cls("acf") is ACF and get_pe_cls("ACF") is ACF
    if importlib.util.find_spec("parselmouth") is None:
        assert jax_get_pe_cls("parselmouth") is JaxACF
        assert get_pe_cls("parselmouth") is ACF
    from prodiff_tpu_torch.pe.rmvpe import RMVPE

    assert get_pe_cls("rmvpe") is RMVPE
    with pytest.raises(ValueError, match="Unknown pitch extractor"):
        get_pe_cls("crepe")
    with pytest.raises(NotImplementedError):
        BasePitchExtractor({}).get_pitch(np.zeros(4), SR, 1, hop_size=512)


def test_interp_f0_and_pad_frames_match_jax():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(100, 400, 50).astype(np.float32)
    f0[[0, 1, 10, 11, 12, 30, 49]] = 0
    for case in (f0, np.zeros(8, np.float32), np.full(8, 200.0, np.float32)):
        (got, got_uv), (want, want_uv) = interp_f0(case.copy()), jax_interp_f0(case.copy())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_uv, want_uv)
    for n_samples, n_expect in ((50 * 512, 50), (52 * 512, 48), (40 * 512, 56), (50 * 512, 53)):
        np.testing.assert_array_equal(pad_frames(f0, 512, n_samples, n_expect),
                                      jax_pad_frames(f0, 512, n_samples, n_expect))


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32", "stereo"])
def test_load_wav_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(4)
    y = rng.uniform(-0.9, 0.9, 1000)
    data = {"int16": (y * 32767).astype(np.int16), "int32": (y * 2 ** 31).astype(np.int32),
            "uint8": (y * 127 + 128).astype(np.uint8), "float32": y.astype(np.float32),
            "stereo": (np.stack([y, -0.5 * y], 1) * 32767).astype(np.int16)}[kind]
    path = str(tmp_path / "in.wav")
    wavfile.write(path, 22050, data)
    (got, sr), (want, want_sr) = load_wav(path, sr=22050), jax_load_wav(path, sr=22050)
    assert sr == want_sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_base_vocoder_interface():
    """The registry's base class has the JAX package's spec2wav/wav2spec."""
    with pytest.raises(NotImplementedError):
        BaseVocoder({}).spec2wav(np.zeros((4, 16), np.float32))
    with pytest.raises(NotImplementedError):
        BaseVocoder.wav2spec("in.wav", {})


def _nsf_state_dict():
    torch.manual_seed(0)
    gen = Generator.from_config(VOCODER_H)
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return gen.state_dict()


def test_nsf_spec2wav_and_wav2spec(tmp_path):
    """``NsfHifiGAN.spec2wav`` renders one [T, M] mel to a numpy [T*upp] wav
    through ``spec2wav_batch``; ``wav2spec`` is the base-config mel of a file."""
    voc = get_vocoder_cls("nsfhifigan")({"vocoder_deterministic": True},
                                        state_dict=_nsf_state_dict(), config=VOCODER_H,
                                        device="cpu")
    rng = np.random.default_rng(5)
    mel = rng.normal(-4, 1, (20, 16)).astype(np.float32)
    f0 = rng.uniform(100, 300, 20).astype(np.float32)
    wav = voc.spec2wav(mel, f0=f0)
    assert isinstance(wav, np.ndarray) and wav.shape == (20 * 32,)
    np.testing.assert_array_equal(wav, voc.spec2wav_batch(mel[None], f0[None])[0].numpy())
    path = str(tmp_path / "in.wav")
    y = vibrato_tone(0.3, harmonics=8, noise_db=-10.0, seed=6)
    wavfile.write(path, SR, y)
    hp = dict(NSF_AUDIO, fft_size=2048, win_size=2048, hop_size=512, audio_num_mel_bins=128)
    got_wav, got_mel = voc.wav2spec(path, hparams=hp, keyshift=2, device="cpu")
    want_wav, want_mel = jax_get_vocoder_cls("nsfhifigan").wav2spec(path, hp, keyshift=2)
    np.testing.assert_array_equal(got_wav, want_wav)
    assert got_mel.shape == want_mel.shape and got_mel.shape[1] == 128
    np.testing.assert_allclose(got_mel, want_mel, atol=1e-4)


def test_fastdiff_spec2wav_ignores_f0():
    """``vocode wav2wav`` hands every vocoder ``f0``; FastDiff's render ignores it."""
    torch.manual_seed(1)
    voc = get_vocoder_cls("fastdiff")({}, state_dict=FastDiffNet.from_config(FD_CFG).state_dict(),
                                      config=FD_CFG, device="cpu")
    mel = np.random.default_rng(7).normal(size=(2, 16)).astype(np.float32)
    a = voc.spec2wav(mel, f0=np.full(2, 200.0, np.float32))
    b = voc.spec2wav(mel)
    assert a.shape == (2 * 256,)
    np.testing.assert_array_equal(a, b)


def _write_nsf(tmp_path):
    voc_dir = tmp_path / "nsf_hifigan"
    voc_dir.mkdir()
    torch.save({"generator": _nsf_state_dict()}, voc_dir / "model")
    with open(voc_dir / "config.json", "w") as f:
        json.dump(dict(VOCODER_H, n_fft=512, win_size=512, hop_size=32, fmin=40, fmax=16000), f)
    return dict(NSF_AUDIO, vocoder="nsfhifigan", vocoder_ckpt=str(voc_dir / "model"),
                pitch_extractor="parselmouth", interp_uv=True, vocoder_deterministic=True)


def _write_fastdiff(tmp_path):
    voc_dir = tmp_path / "fastdiff"
    voc_dir.mkdir()
    torch.manual_seed(2)
    net = FastDiffNet.from_config(FD_CFG)
    with torch.no_grad():  # with the noise at 0.05, the random-weight render stays in [-1, 1]
        net.final_conv[0].weight.mul_(0.1)
    torch.save({"state_dict": {"model": net.state_dict()}}, voc_dir / "model_ckpt_steps_10.ckpt")
    with open(voc_dir / "config.yaml", "w") as f:
        yaml.dump(FD_CFG, f)
    return dict(FD_AUDIO, vocoder="fastdiff", vocoder_ckpt=str(voc_dir),
                pitch_extractor="acf", fastdiff_reverse_step=4)


def _jax_wav2wav(cfg_fn, wav_file, keyshift, out_path, render):
    """``main.py vocode wav2wav``'s body for one file, function by function."""
    hp = jax_load_config(cfg_fn)
    vocoder = jax_get_vocoder_cls(hp["vocoder"])(hp)
    pe = jax_get_pe_cls(hp.get("pitch_extractor", "parselmouth"))(hp)
    wave, mel = vocoder.wav2spec(wav_file, hparams=hp, keyshift=keyshift)
    f0, _ = pe.get_pitch(wave, hp["audio_sample_rate"], len(mel), hop_size=hp["hop_size"],
                         interp_uv=hp.get("interp_uv", True))
    if keyshift != 0:
        f0 = jax_shift_pitch(f0, keyshift)
    res = render(vocoder, mel, np.asarray(f0, np.float32))
    jax_save_wav(res, out_path, hp["audio_sample_rate"])
    return mel


def _assert_wavs_close(got_path, want_path, n_samples):
    (sr_g, got), (sr_w, want) = wavfile.read(got_path), wavfile.read(want_path)
    assert sr_g == sr_w and got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == (n_samples,)
    peak = float(np.abs(want.astype(np.float64)).max())
    assert 1000 < peak < 32000  # a render, not silence, and no int16 wrap-around
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= 1e-4 * peak + 1, (err, peak)


def _write_inputs(tmp_path, sr, seconds, names):
    in_dir = tmp_path / "wavs"
    in_dir.mkdir()
    for i, name in enumerate(names):
        wavfile.write(str(in_dir / f"{name}.wav"), sr,
                      vibrato_tone(seconds, sr=sr, f0=200.0 + 40 * i, harmonics=4, seed=10 + i))
    (in_dir / "notes.txt").write_text("not a wav")
    return in_dir


@pytest.mark.parametrize("keyshift", [0, 3])
def test_vocode_cli_nsf_matches_jax(keyshift, tmp_path):
    """``vocode wav2wav`` on a directory of two wavs through NSF-HiFiGAN
    (deterministic source, parselmouth -> ACF) vs the JAX pipeline."""
    hp = _write_nsf(tmp_path)
    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.dump(hp))
    in_dir = _write_inputs(tmp_path, SR, 0.4, ["a", "b"])
    out = tmp_path / "out"
    port_cli(["vocode", "wav2wav", str(in_dir), "--config", str(cfg), "--keyshift", str(keyshift),
              "--output_dir", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["a.wav", "b.wav"]
    for name in ("a", "b"):
        want_path = str(tmp_path / f"jax_{name}.wav")
        mel = _jax_wav2wav(str(cfg), str(in_dir / f"{name}.wav"), keyshift, want_path,
                           lambda v, m, f0: v.spec2wav(m, f0=f0))
        _assert_wavs_close(str(out / f"{name}.wav"), want_path, len(mel) * 32)


def test_vocode_cli_fastdiff_matches_jax(tmp_path, monkeypatch):
    """``vocode wav2wav`` on one wav through a 2-layer FastDiff (ACF pitch,
    ignored by the vocoder), keyshift +3, the same noise injected into the
    port's render and the JAX sampler (at 0.05 of a unit normal, so the
    random-weight render stays inside the int16 range of ``save_wav``)."""
    hp = _write_fastdiff(tmp_path)
    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.dump(hp))
    in_dir = _write_inputs(tmp_path, 22050, 0.25, ["a"])
    n_mel = (int(round(0.25 * 22050)) + (1024 - 256) - 1024) // 256 + 1
    t = n_mel * 256
    rng = np.random.default_rng(8)
    init = (0.05 * rng.normal(size=(1, t, 1))).astype(np.float32)
    step_n = (0.05 * rng.normal(size=(4, 1, t, 1))).astype(np.float32)
    render = FastDiffVocoder.spec2wav
    monkeypatch.setattr(FastDiffVocoder, "spec2wav", lambda self, mel, **kw: render(
        self, mel, init_noise=torch.from_numpy(init), step_noises=torch.from_numpy(step_n), **kw))
    out = tmp_path / "out"
    port_cli(["vocode", "wav2wav", str(in_dir / "a.wav"), "--config", str(cfg), "--keyshift", "3",
              "--output_dir", str(out), "--device", "cpu"])

    def jax_render(v, mel, f0):
        c = jnp.asarray(mel)[None]
        return np.asarray(jax_sampling(
            lambda p, x, cc, tt: v.model.apply(p, x, cc, tt), v.params, jax.random.PRNGKey(0),
            c.shape[1] * 256, c, v.beta_infer, v.alpha_infer, v.sigma_infer, v.steps_infer,
            init_noise=jnp.asarray(init), step_noises=jnp.asarray(step_n))[0])

    want_path = str(tmp_path / "jax_a.wav")
    mel = _jax_wav2wav(str(cfg), str(in_dir / "a.wav"), 3, want_path, jax_render)
    assert len(mel) == n_mel
    _assert_wavs_close(str(out / "a.wav"), want_path, t)


def test_chip_smoke_mirrors_the_vocode_cells():
    """``chip_smoke.py``'s vocode phase: NSF-HiFiGAN at the base config's
    audio settings with the openvpi 44.1 kHz generator, FastDiff at its
    LJSpeech config and audio settings, both with the ACF extractor, on the
    input lengths the phase names."""
    import chip_smoke

    base = jax_load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "prodiff_tpu", "assets", "base_config.yaml"))
    keys = ("audio_sample_rate", "audio_num_mel_bins", "fft_size", "win_size", "hop_size",
            "fmin", "fmax")
    for key in keys:
        assert chip_smoke.VOCODE_NSF_AUDIO[key] == base[key], key
    assert chip_smoke.VOCODE_NSF_AUDIO["audio_num_mel_bins"] == chip_smoke.VOCODER_H["num_mels"]
    assert int(np.prod(chip_smoke.VOCODER_H["upsample_rates"])) == base["hop_size"]
    lj = {"audio_sample_rate": 22050, "audio_num_mel_bins": 80, "fft_size": 1024,
          "win_size": 1024, "hop_size": 256, "fmin": 80, "fmax": 7600}
    assert {k: chip_smoke.VOCODE_FD_AUDIO[k] for k in keys} == lj
    assert chip_smoke.FD_CONFIG["cond_channels"] == lj["audio_num_mel_bins"]
    assert int(np.prod(chip_smoke.FD_CONFIG["upsample_ratios"])) == lj["hop_size"]
    for audio in (chip_smoke.VOCODE_NSF_AUDIO, chip_smoke.VOCODE_FD_AUDIO):
        assert audio["pitch_extractor"] == "acf"
    assert chip_smoke.VOCODE_NSF_SAMPLES == 264600  # 6.0 s at 44.1 kHz: 516 frames
    assert chip_smoke.VOCODE_FD_SAMPLES == 131072  # 512 frames at hop 256


def test_set_hparams_without_an_experiment(tmp_path):
    """``vocode``'s config route, ``set_hparams(task="vocoder", config_fn=...)``
    with no experiment name, stamps what the JAX function stamps."""
    from prodiff_tpu.config import set_hparams as jax_set_hparams
    from prodiff_tpu_torch.config import set_hparams

    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.dump(dict(NSF_AUDIO, base_config="base", vocoder="nsfhifigan")))
    got = set_hparams(task="vocoder", config_fn=str(cfg))
    want = jax_set_hparams(config_fn=str(cfg), task="vocoder", make_work_dir=False,
                           global_hparams=False)
    assert got == want and "exp_name" not in got and got["hop_size"] == 32
    with pytest.raises(FileNotFoundError, match="Config file not found"):
        set_hparams(task="vocoder", config_fn=str(tmp_path / "missing.yaml"),
                    checkpoints_root=str(tmp_path))
