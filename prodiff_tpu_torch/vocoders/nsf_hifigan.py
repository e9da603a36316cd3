"""NSF-HiFiGAN vocoder wrapper (port of ``prodiff_tpu/vocoders/nsf_hifigan.py``).

Loads a torch generator checkpoint plus the ``config.json`` beside it
(``vocoder_ckpt``), folding weight norm, or takes an in-memory state dict
and config. The acoustic model works in log10-mel; the generator wants
natural log, hence the ``* LOG10_TO_LN``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.models.nsf_hifigan import Generator
from prodiff_tpu_torch.utils.convert import load_torch_state_dict
from prodiff_tpu_torch.vocoders import BaseVocoder, register_vocoder

LOG10_TO_LN = 2.30259  # the reference's constant (prodiff_tpu/ops/mel.py)


@register_vocoder
class NsfHifiGAN(BaseVocoder):
    def __init__(self, hparams: dict, state_dict: Optional[dict] = None,
                 config: Optional[dict] = None, device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        if state_dict is None:
            model_path = hparams["vocoder_ckpt"]
            if not os.path.exists(model_path):
                raise FileNotFoundError(f"NSF-HiFiGAN model not found: {model_path}")
            with open(os.path.join(os.path.dirname(model_path), "config.json")) as f:
                config = json.load(f)
            state_dict = load_torch_state_dict(model_path)
        self.h = config
        self.model = Generator.from_config(config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def spec2wav_batch(self, mel, f0, generator: Optional[torch.Generator] = None,
                       deterministic: Optional[bool] = None) -> torch.Tensor:
        """mel [B, T, M] log10, f0 [B, T] Hz -> wav [B, T*upp] on the device.

        ``deterministic`` (or hparam ``vocoder_deterministic``) renders with a
        zero-phase, noise-free sine source; otherwise the source's randomness
        comes from ``generator`` (default: seed 0)."""
        if deterministic is None:
            deterministic = bool(self.hparams.get("vocoder_deterministic", False))
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        f0 = torch.as_tensor(f0, dtype=torch.float32, device=self.device)
        if deterministic:
            generator = None
        elif generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return self.model(mel * LOG10_TO_LN, f0, generator)
