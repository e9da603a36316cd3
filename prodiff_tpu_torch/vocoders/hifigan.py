"""HiFi-GAN and Parallel WaveGAN vocoders (port of
``prodiff_tpu/vocoders/hifigan.py``).

Checkpoints resolve as in the JAX package: ``{vocoder_ckpt}/config.yaml``
with the newest ``model_ckpt_steps_*.ckpt`` (a framework checkpoint, its
generator under ``model_gen.``), or ``config.json`` with ``generator_v1``
(the official HiFi-GAN release); Parallel WaveGAN reads ``config.yaml`` with
the newest ``model_ckpt_steps_*.ckpt`` or ``checkpoint-*steps.pkl``. Weight
norm is folded at load (``utils/convert.py:load_torch_state_dict``). Either
wrapper also takes an in-memory reference state dict and config.

Hparams read: ``use_nsf`` (HiFi-GAN renders its harmonic source only where
it is set and an f0 is given), ``vocoder_denoise_c`` (spectral subtraction
after HiFi-GAN, :func:`denoise`), and ``hifigan_packed``, the JAX package's
tri-state for its packed runner, which here decides only the tap dtype of
the resblock stages (``device.hifigan_tap_dtype``: bf16 in ``fast`` mode on
the card unless it is false). Neither vocoder has ``spec2wav_batch``, as in
the JAX package: ``vocode wav2wav`` is their path.

The random draws (HiFi-GAN's source phases and noise, Parallel WaveGAN's
input noise ``z``) come from an explicit ``torch.Generator`` (default: seed 0
on the vocoder's device) or are passed in, so that two renders can be held
against each other.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from prodiff_tpu_torch.device import hifigan_tap_dtype, resolve_device
from prodiff_tpu_torch.models.hifigan import Draws, HifiGanGenerator
from prodiff_tpu_torch.models.pwg import ParallelWaveGANGenerator
from prodiff_tpu_torch.ops.stft_extras import istft, stft_complex
from prodiff_tpu_torch.utils.convert import last_checkpoint_path, load_torch_state_dict
from prodiff_tpu_torch.utils.pitch_utils import f0_to_coarse
from prodiff_tpu_torch.vocoders import BaseVocoder, register_vocoder
from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN


def denoise(wav: torch.Tensor, v: float = 0.1, fft_size: int = 2048, hop_size: int = 512,
            win_size: int = 512) -> torch.Tensor:
    """Spectral subtraction of ``v`` from the magnitudes of a centered hann
    STFT (the reference's ``vocoder_utils.py:6-14``), on ``wav [L]``'s device."""
    n = np.arange(win_size)
    win = (0.5 - 0.5 * np.cos(2 * np.pi * n / win_size)).astype(np.float32)
    if win_size < fft_size:
        lp = (fft_size - win_size) // 2
        win = np.pad(win, (lp, fft_size - win_size - lp))
    win = torch.as_tensor(win, device=wav.device)
    spec = stft_complex(wav.float()[None], win, fft_size, hop_size)
    mag = torch.clamp(spec.abs() - v, min=0)
    return istft(torch.polar(mag, spec.angle()), win, fft_size, hop_size, wav.shape[-1])[0]


def _strip_model_gen(sd: dict) -> dict:
    """A framework checkpoint nests the generator under ``model_gen.``."""
    return {(k[len("model_gen."):] if k.startswith("model_gen.") else k): v for k, v in sd.items()}


def _load_generator(model: torch.nn.Module, sd: dict) -> None:
    """Load the generator's own keys of ``sd`` (a training checkpoint also
    holds its discriminators'); a missing key raises."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{type(model).__name__}: checkpoint lacks {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own})


@register_vocoder
class HifiGAN(BaseVocoder):
    def __init__(self, hparams: dict, state_dict: Optional[dict] = None,
                 config: Optional[dict] = None, device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        if state_dict is None:
            base_dir = hparams["vocoder_ckpt"]
            config_path = os.path.join(base_dir, "config.yaml")
            if os.path.exists(config_path):
                from prodiff_tpu_torch.config import load_config

                config = load_config(config_path)
                ckpt = last_checkpoint_path(base_dir)
            else:
                with open(os.path.join(base_dir, "config.json")) as f:
                    config = json.load(f)
                ckpt = os.path.join(base_dir, "generator_v1")
            print("| load HifiGAN:", ckpt)
            state_dict = load_torch_state_dict(ckpt)
        self.config = config
        self.model = HifiGanGenerator.from_config(config, hifigan_tap_dtype(hparams, self.device))
        _load_generator(self.model, _strip_model_gen(state_dict))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None, **kwargs) -> np.ndarray:
        """mel [T, M] (the generator's own log-mel convention), f0 [T] Hz ->
        wav [T*upp] (numpy). With ``use_nsf`` the source's draws are
        ``draws`` or come from ``generator`` (default: seed 0)."""
        c = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)[None]
        f0_t = None
        if f0 is not None and self.hparams.get("use_nsf"):
            f0_t = torch.as_tensor(np.asarray(f0, np.float32), device=self.device)[None]
            if draws is None and generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
        wav = self.model(c, f0_t, generator, draws)[0]
        if self.hparams.get("vocoder_denoise_c", 0.0) > 0:
            wav = denoise(wav, v=self.hparams["vocoder_denoise_c"],
                          fft_size=self.hparams["fft_size"], hop_size=self.hparams["hop_size"],
                          win_size=self.hparams["win_size"])
        return wav.cpu().numpy()

    @staticmethod
    def wav2spec(inp_path, hparams, keyshift=0, speed=1, device=None):
        return NsfHifiGAN.wav2spec(inp_path, hparams, keyshift, speed, device=device)


def _latest_pkl(base_dir: str) -> str:
    pkls = sorted(glob.glob(os.path.join(base_dir, "checkpoint-*steps.pkl")),
                  key=lambda x: int(re.findall(r"checkpoint-(\d+)steps", x)[0]))
    if not pkls:
        raise FileNotFoundError(f"PWG: no model_ckpt_steps_*.ckpt or checkpoint-*steps.pkl "
                                f"in {base_dir}")
    return pkls[-1]


@register_vocoder
class PWG(BaseVocoder):
    def __init__(self, hparams: dict, state_dict: Optional[dict] = None,
                 config: Optional[dict] = None, device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        if state_dict is None:
            import yaml

            base_dir = hparams["vocoder_ckpt"] or "wavegan_pretrained"
            with open(os.path.join(base_dir, "config.yaml")) as f:
                config = yaml.safe_load(f)
            ckpt = last_checkpoint_path(base_dir) or _latest_pkl(base_dir)
            print("| load PWG:", ckpt)
            state_dict = load_torch_state_dict(ckpt)
        self.config = config
        self.model = ParallelWaveGANGenerator.from_config(config)
        _load_generator(self.model, _strip_model_gen(state_dict))
        self.model.to(self.device).eval()

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                 z: Optional[torch.Tensor] = None, **kwargs) -> np.ndarray:
        """mel [T, M], f0 [T] Hz -> wav [T*hop] (numpy). The mel is padded
        by its edge values for the context window; the input noise is ``z``
        [1, T*hop, 1] or drawn from ``generator`` (default: seed 0)."""
        gp = self.config["generator_params"]
        window = gp.get("aux_context_window", 2)
        n = np.asarray(mel).shape[0] * self.config["hop_size"]
        c = np.pad(np.asarray(mel, np.float32), ((window, window), (0, 0)), "edge")
        if z is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            z = torch.randn((1, n, 1), generator=generator, device=self.device)
        pitch = None
        if f0 is not None and gp.get("use_pitch_embed", False):
            p = f0_to_coarse(np.asarray(f0, np.float64).copy())
            pitch = torch.as_tensor(np.pad(p, (window, window), "edge"), device=self.device)[None]
        wav = self.model(z.to(self.device), torch.as_tensor(c, device=self.device)[None], pitch)
        return wav[0].cpu().numpy()

    @staticmethod
    def wav2spec(inp_path, hparams, keyshift=0, speed=1, device=None):
        return NsfHifiGAN.wav2spec(inp_path, hparams, keyshift, speed, device=device)
