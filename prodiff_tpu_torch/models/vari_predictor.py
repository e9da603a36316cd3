"""Variance predictor: multi-variance diffusion over the voicing, breath and
tension curves (port of ``prodiff_tpu/models/vari_predictor.py``).

Condition: the phoneme encoder (+ a duration embed) regulated to frames,
the note encoder regulated through ``mel2note``, the pitch embed
(``log(1 + f0 / 700)``) and a speaker embed (``hparams["num_spk"]`` rows).
The denoiser is the 4-step Gaussian diffusion's WaveNet in multi-variance
mode (``repeat_bins // F`` bins a curve); with ``dilation_cycle_length: 1``
(the base config) it runs K1 on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import Embedding, Linear
from prodiff_tpu_torch.models.diffusion import GaussianDiffusion
from prodiff_tpu_torch.models.encoder import FastspeechEncoder
from prodiff_tpu_torch.models.pitch_predictor import note_condition, note_encoder, phone_condition
from prodiff_tpu_torch.models.wavenet import WaveNet


def variance_list(hparams: dict) -> List[str]:
    """The curves the hparams turn on, in the model's order."""
    return [name for name in ("voicing", "breath", "tension")
            if hparams.get(f"use_{name}_embed", False)]


def variance_clamp_ranges(hparams: dict) -> tuple:
    keys = {"voicing": "voicing_db", "breath": "breath_db", "tension": "tension_logit"}
    return tuple((hparams[f"{keys[n]}_min"], hparams[f"{keys[n]}_max"])
                 for n in variance_list(hparams))


class VariPredictor(nn.Module):
    def __init__(self, vocab_size: int, hparams: Dict[str, Any]):
        super().__init__()
        hp, hidden = hparams, hparams["hidden_size"]
        self.variance_names = variance_list(hp)
        if not self.variance_names:
            raise ValueError("the variance predictor needs one of voicing/breath/tension")
        args = hp["vari_prediction_args"]
        self.with_dur_embed = hp.get("use_dur_embed", True)
        if self.with_dur_embed:
            self.dur_embed = Linear(1, hidden)
        self.encoder = FastspeechEncoder(vocab_size, hidden, hp["enc_layers"],
                                         hp["enc_ffn_kernel_size"], hp["num_heads"],
                                         hp["dropout"])
        self.note_encoder = note_encoder(args)
        self.note_encode_out_linear = Linear(args["encoder_args"]["hidden_size"], hidden)
        self.with_spk_embed = hp.get("use_spk_id", True)
        if self.with_spk_embed:
            self.spk_embed = Embedding(hp["num_spk"], hidden, padding_idx=None)
        self.pitch_embed = Linear(1, hidden)
        n_feat = len(self.variance_names)
        repeat_bins = args["repeat_bins"] // n_feat
        den = args["denoise_args"]
        self.diffusion = GaussianDiffusion(
            WaveNet(n_feat * repeat_bins, hidden, den["residual_layers"],
                    den["residual_channels"], den["dilation_cycle_length"]),
            out_dims=repeat_bins, timesteps=args["timesteps"], schedule_type=hp["schedule_type"],
            max_beta=hp.get("max_beta", 0.06), num_features=n_feat, repeat_bins=repeat_bins,
            clamp_ranges=variance_clamp_ranges(hp))

    def forward_condition(self, txt_tokens: torch.Tensor, mel2ph: torch.Tensor,
                          note_midi: torch.Tensor, note_rest: torch.Tensor,
                          mel2note: torch.Tensor, f0: torch.Tensor,
                          spk_embed_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T_ph], mel2ph/mel2note/f0 [B, T_mel] (f0 in Hz), notes
        [B, T_note], spk_embed_id [B] -> condition [B, T_mel, H]."""
        condition = phone_condition(self, txt_tokens, mel2ph)
        condition = note_condition(self, condition, note_midi, note_rest, mel2note)
        condition = condition + self.pitch_embed(torch.log(1 + f0 / 700)[:, :, None])
        if self.with_spk_embed:
            condition = condition + self.spk_embed(spk_embed_id)[:, None, :]
        return condition

    def forward(self, txt_tokens, mel2ph, note_midi, note_rest, mel2note, f0,
                gt_curves: torch.Tensor, spk_embed_id: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Training: ``gt_curves`` [B, F, T_mel] (the curves of
        :func:`variance_list`, in that order) -> the diffusion's (x0_pred,
        x0), both [B, F, T_mel, repeat_bins]; ``t``/``noise``/``generator``
        as :meth:`GaussianDiffusion.forward`."""
        condition = self.forward_condition(txt_tokens, mel2ph, note_midi, note_rest, mel2note,
                                           f0, spk_embed_id)
        return self.diffusion(condition, gt_curves, t=t, noise=noise, generator=generator)

    @torch.no_grad()
    def infer(self, txt_tokens, mel2ph, note_midi, note_rest, mel2note, f0,
              spk_embed_id=None, infer_step: int = 4, init_noise=None, step_noises=None,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """-> {curve name: [B, T_mel]}; the noise as
        :meth:`GaussianDiffusion.infer` takes it."""
        condition = self.forward_condition(txt_tokens, mel2ph, note_midi, note_rest, mel2note,
                                           f0, spk_embed_id)
        curves = self.diffusion.infer(condition, infer_step=infer_step, init_noise=init_noise,
                                      step_noises=step_noises, generator=generator)
        return {name: curves[:, i] for i, name in enumerate(self.variance_names)}
