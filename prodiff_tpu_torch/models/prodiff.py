"""ProDiffTeacher, the SVS acoustic model (port of
``prodiff_tpu/models/prodiff.py``).

Phoneme encoder with duration/language extra embeds -> length-regulate to
frames through mel2ph -> add pitch/speaker/gender/voicing/breath
conditioning -> zero padded frames -> the mel's diffusion: the 4-step
x0-prediction DDPM (``diff_type: prodiff``) or a rectified flow integrated
over ``sampling_steps`` (``diff_type: reflow``, the mel min-max normalised
by ``spec_min``/``spec_max``; its start point is its only noise).
:meth:`ProDiffTeacher.forward` is the training call (``gt_spec`` -> the
DDPM's ``(x0_pred, x0)`` or the flow's ``(v_pred, v_gt, t)``),
:meth:`ProDiffTeacher.infer` samples either.

The bf16 compute policy follows ``prodiff_tpu/models/prodiff.py:63-66``:
``bf16`` or ``amp`` true (in training, as the task resolved it) builds the
encoder and the WaveNet with ``dtype=bfloat16``; the embeddings, the
duration/pitch/curve projections and every parameter stay float32. The
WaveNet's kernel route also reads ``pallas_wavenet_dtype``
(``device.kernel_operand_dtype``).

``tp`` (a ``parallel.megatron.TensorParallel``; the trainer's at
``model_parallel > 1``) goes to the encoder and the WaveNet, as the JAX
teacher gives both its ``model`` axis (``prodiff_tpu/models/prodiff.py:76-78,
109-111``). Without it the teacher is the one-process model, whatever
``model_parallel`` says (a render of a tensor-parallel run's checkpoint).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from prodiff_tpu_torch import device
from prodiff_tpu_torch.models.common import Embedding, Linear
from prodiff_tpu_torch.models.diffusion import GaussianDiffusion
from prodiff_tpu_torch.models.encoder import FastspeechEncoder
from prodiff_tpu_torch.models.reflow import RectifiedFlow
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops.seq import mel2ph_to_dur, regulate_hidden


class ProDiffTeacher(nn.Module):
    def __init__(self, vocab_size: int, hparams: Dict[str, Any], tp=None):
        super().__init__()
        hp = hparams
        device.check_tp_dilation(hp)
        self.diff_type = hp.get("diff_type", "prodiff")
        if self.diff_type not in ("prodiff", "reflow"):
            raise NotImplementedError(f"diff_type {self.diff_type!r}")
        hidden = hp["hidden_size"]
        self.mel_bins = hp["audio_num_mel_bins"]
        dtype = device.module_dtype(hp)
        self.encoder = FastspeechEncoder(
            vocab_size, hidden, hp["enc_layers"], hp["enc_ffn_kernel_size"], hp["num_heads"],
            hp.get("dropout", 0.1), dtype=dtype, tp=tp,
        )
        self.with_dur_embed = hp.get("use_dur_embed", True)
        if self.with_dur_embed:
            self.dur_embed = Linear(1, hidden)
        self.with_spk_embed = hp.get("use_spk_id", True)
        if self.with_spk_embed:
            self.spk_embed = Embedding(hp["num_spk"], hidden, padding_idx=None)
        self.with_gender_embed = hp.get("use_gender_id", False)
        if self.with_gender_embed:
            self.gender_embed = Embedding(2, hidden, padding_idx=None)
        self.with_lang_embed = hp.get("use_lang_id", True)
        if self.with_lang_embed:
            self.lang_embed = Embedding(len(hp["languages"]) + 1, hidden, padding_idx=0)
        self.pitch_embed = Linear(1, hidden)
        self.with_voicing_embed = hp.get("use_voicing_embed", False)
        if self.with_voicing_embed:
            self.voicing_embed = Linear(1, hidden)
        self.with_breath_embed = hp.get("use_breath_embed", False)
        if self.with_breath_embed:
            self.breath_embed = Linear(1, hidden)
        denoiser = WaveNet(
            in_dims=self.mel_bins, hidden_size=hidden,
            residual_layers=hp["residual_layers"],
            residual_channels=hp["residual_channels"],
            dilation_cycle_length=hp["dilation_cycle_length"],
            dtype=dtype, stream_dtype=device.stream_dtype(hp), tp=tp,
        )
        if self.diff_type == "prodiff":
            self.diffusion = GaussianDiffusion(
                denoise_fn=denoiser, out_dims=self.mel_bins, timesteps=hp["timesteps"],
                schedule_type=hp["schedule_type"], max_beta=hp.get("max_beta", 0.06),
                noise_init=hp.get("diff_noise_init", "uniform"),
            )
        else:
            self.diffusion = RectifiedFlow(
                denoise_fn=denoiser, out_dims=self.mel_bins, time_scale=hp["timescale"],
                sampling_algorithm=hp.get("sampling_algorithm", "euler"),
                spec_min=tuple(hp["spec_min"]), spec_max=tuple(hp["spec_max"]),
            )

    def forward_condition(
        self,
        txt_tokens: torch.Tensor,
        mel2ph: torch.Tensor,
        f0: torch.Tensor,
        lang_seq: Optional[torch.Tensor] = None,
        spk_embed_id: Optional[torch.Tensor] = None,
        spk_mix_embed: Optional[torch.Tensor] = None,
        gender_embed_id: Optional[torch.Tensor] = None,
        gender_mix_embed: Optional[torch.Tensor] = None,
        voicing: Optional[torch.Tensor] = None,
        breath: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[B, T_txt] tokens, [B, T_mel] mel2ph/f0 (+ optional curves and
        mixes) -> condition [B, T_mel, H], zero on padding frames."""
        extra_embed = None
        if self.with_dur_embed:
            dur = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]).float()
            extra_embed = self.dur_embed(dur[:, :, None])
        if self.with_lang_embed:
            if lang_seq is None:
                raise ValueError("use_lang_id is True, lang_seq is required")
            lang = self.lang_embed(lang_seq)
            extra_embed = lang if extra_embed is None else extra_embed + lang
        condition = regulate_hidden(self.encoder(txt_tokens, extra_embed), mel2ph)
        condition = condition + self.pitch_embed(torch.log(1 + f0 / 700)[:, :, None])
        if self.with_spk_embed:
            if spk_mix_embed is not None:
                condition = condition + spk_mix_embed
            else:
                condition = condition + self.spk_embed(spk_embed_id)[:, None, :]
        if self.with_gender_embed:
            if gender_mix_embed is not None:
                condition = condition + gender_mix_embed
            else:
                condition = condition + self.gender_embed(gender_embed_id)[:, None, :]
        for name, curve in (("voicing", voicing), ("breath", breath)):
            if getattr(self, f"with_{name}_embed"):
                if curve is None:
                    raise ValueError(f"use_{name}_embed is True, {name} is required")
                condition = condition + getattr(self, f"{name}_embed")(curve[:, :, None])
        return condition * (mel2ph > 0).to(condition.dtype)[:, :, None]

    def forward(self, txt_tokens, mel2ph, f0, gt_spec: torch.Tensor,
                t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **cond_kw):
        """Training: ``gt_spec`` [B, T_mel, M] -> (x0_pred, x0), both
        [B, 1, T_mel, M], or with ``diff_type: reflow`` (v_pred, v_gt, t).
        ``t``/``noise``/``generator`` as :meth:`GaussianDiffusion.forward`
        (:meth:`RectifiedFlow.forward`: t in [0, 1], noise the start point);
        ``cond_kw`` as :meth:`infer`."""
        condition = self.forward_condition(txt_tokens, mel2ph, f0, **cond_kw)
        return self.diffusion(condition, gt_spec[:, None], t=t, noise=noise, generator=generator)

    @torch.no_grad()
    def infer(self, txt_tokens, mel2ph, f0, infer_step: int = 4,
              init_noise: Optional[torch.Tensor] = None,
              step_noises: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None, **cond_kw) -> torch.Tensor:
        """Sample a mel [B, T_mel, M]; ``cond_kw`` are the optional inputs of
        :meth:`forward_condition`. A reflow teacher integrates ``infer_step``
        steps from ``init_noise`` and takes no ``step_noises``."""
        condition = self.forward_condition(txt_tokens, mel2ph, f0, **cond_kw)
        if self.diff_type == "reflow":
            mel = self.diffusion.infer(condition, infer_step=infer_step, init_noise=init_noise,
                                       generator=generator)
        else:
            mel = self.diffusion.infer(
                condition, infer_step=infer_step, init_noise=init_noise,
                step_noises=step_noises, generator=generator,
            )
        return mel[:, 0]
