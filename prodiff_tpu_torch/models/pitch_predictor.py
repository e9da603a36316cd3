"""Pitch predictor: rectified flow over the pitch's delta from the smoothed
base melody (port of ``prodiff_tpu/models/pitch_predictor.py``).

Condition: the phoneme-category encoder (+ a duration embed; its vocabulary
is ``vocab_size + 1``, as in the JAX module) regulated to frames, the note
encoder regulated through ``mel2note``, a speaker embed (one row per entry
of ``hparams["datasets"]``), the retake embed (its two rows mixed by
``pitch_expr`` at inference) and the delta-pitch embed (the known delta
outside the retake region, else zero). The denoiser (WaveNet with
``dilation_cycle_length: 5`` in the base config) runs its plain module loop
on every device: no kernel serves that shape in either package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import Embedding, Linear
from prodiff_tpu_torch.models.encoder import FastspeechEncoder, NoteEncoder
from prodiff_tpu_torch.models.reflow import RectifiedFlow
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops.seq import mel2ph_to_dur, regulate_hidden


def note_condition(model: nn.Module, condition: torch.Tensor, note_midi: torch.Tensor,
                   note_rest: torch.Tensor, mel2note: torch.Tensor) -> torch.Tensor:
    """``condition`` + the note encoder's output (through
    ``note_encode_out_linear``) regulated to frames by ``mel2note``."""
    note_dur = mel2ph_to_dur(mel2note, note_midi.shape[1]).to(condition.dtype)
    notes = model.note_encode_out_linear(model.note_encoder(note_midi, note_rest, note_dur))
    return condition + regulate_hidden(notes, mel2note)


def phone_condition(model: nn.Module, txt_tokens: torch.Tensor,
                    mel2ph: torch.Tensor) -> torch.Tensor:
    """The phoneme encoder (+ its duration embed) regulated to frames."""
    extra_embed = None
    if model.with_dur_embed:
        dur = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]).float()
        extra_embed = model.dur_embed(dur[:, :, None])
    return regulate_hidden(model.encoder(txt_tokens, extra_embed), mel2ph)


def note_encoder(args: Dict[str, Any]) -> NoteEncoder:
    enc = args["encoder_args"]
    return NoteEncoder(enc["hidden_size"], enc["num_layers"], enc["ffn_kernel_size"],
                       enc["num_heads"])


class PitchPredictor(nn.Module):
    def __init__(self, vocab_size: int, hparams: Dict[str, Any]):
        super().__init__()
        hp, hidden = hparams, hparams["hidden_size"]
        args = hp["f0_prediction_args"]
        self.encoder = FastspeechEncoder(vocab_size + 1, hidden, hp["enc_layers"],
                                         hp["enc_ffn_kernel_size"], hp["num_heads"],
                                         hp["dropout"])
        self.with_dur_embed = hp.get("use_dur_embed", True)
        if self.with_dur_embed:
            self.dur_embed = Linear(1, hidden)
        self.note_encoder = note_encoder(args)
        self.note_encode_out_linear = Linear(args["encoder_args"]["hidden_size"], hidden)
        self.with_spk_embed = hp.get("use_spk_id", True)
        if self.with_spk_embed:
            self.spk_embed = Embedding(len(hp["datasets"]), hidden, padding_idx=None)
        self.delta_pitch_embed = Linear(1, hidden)
        self.pitch_retake_embed = Embedding(2, hidden, padding_idx=None)
        den = args["denoise_args"]
        self.diffusion = RectifiedFlow(
            WaveNet(args["repeat_bins"], hidden, den["residual_layers"],
                    den["residual_channels"], den["dilation_cycle_length"]),
            out_dims=args["repeat_bins"], time_scale=args["timescale"], num_features=1,
            sampling_algorithm=hp.get("sampling_algorithm", "euler"),
            spec_min=(args["spec_min"],), spec_max=(args["spec_max"],),
            repeat_bins=args["repeat_bins"], clamp_min=args["clamp_min"],
            clamp_max=args["clamp_max"])

    def forward_condition(self, txt_tokens: torch.Tensor, mel2ph: torch.Tensor,
                          note_midi: torch.Tensor, note_rest: torch.Tensor,
                          mel2note: torch.Tensor, base_pitch: torch.Tensor,
                          pitch: Optional[torch.Tensor] = None,
                          pitch_retake: Optional[torch.Tensor] = None,
                          pitch_expr: Optional[torch.Tensor] = None,
                          spk_id: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T_ph], mel2ph/mel2note [B, T_mel], notes [B, T_note],
        base_pitch (and pitch) [B, T_mel] in MIDI, pitch_retake [B, T_mel]
        (1 where the pitch is predicted; default everywhere), pitch_expr [B,
        1], spk_id [B] -> condition [B, T_mel, H]."""
        condition = phone_condition(self, txt_tokens, mel2ph)
        condition = note_condition(self, condition, note_midi, note_rest, mel2note)
        if self.with_spk_embed:
            condition = condition + self.spk_embed(spk_id)[:, None, :]
        is_retake = pitch_retake is not None
        if not is_retake:
            pitch_retake = torch.ones_like(mel2note, dtype=torch.long)
        if pitch_expr is None:
            condition = condition + self.pitch_retake_embed(pitch_retake.long())
        else:
            retake_true, retake_false = self.pitch_retake_embed.weight[1], \
                self.pitch_retake_embed.weight[0]
            expr = (pitch_expr * pitch_retake.to(condition.dtype))[:, :, None]
            condition = condition + retake_true * expr + retake_false * (1 - expr)
        if is_retake:
            delta_pitch = (pitch - base_pitch) * (1 - pitch_retake.to(base_pitch.dtype))
        else:
            delta_pitch = torch.zeros_like(base_pitch)
        return condition + self.delta_pitch_embed(delta_pitch[:, :, None])

    def forward(self, txt_tokens, mel2ph, note_midi, note_rest, mel2note, base_pitch,
                pitch: torch.Tensor, t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, **cond_kw):
        """Training: the flow's (v_pred, v_gt, t) for the target delta
        ``pitch - base_pitch`` [B, T_mel] (MIDI) as a one-feature curve;
        ``cond_kw`` (``pitch_retake``, ``pitch_expr``, ``spk_id``) as
        :meth:`forward_condition`; ``t``/``noise``/``generator`` as
        :meth:`RectifiedFlow.forward`."""
        condition = self.forward_condition(txt_tokens, mel2ph, note_midi, note_rest, mel2note,
                                           base_pitch, pitch=pitch, **cond_kw)
        return self.diffusion(condition, (pitch - base_pitch)[:, None, :], t=t, noise=noise,
                              generator=generator)

    @torch.no_grad()
    def infer(self, txt_tokens, mel2ph, note_midi, note_rest, mel2note, base_pitch,
              infer_step: int = 20, init_noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None, **cond_kw) -> torch.Tensor:
        """-> the predicted delta pitch [B, T_mel] (MIDI); ``cond_kw`` as
        :meth:`forward_condition`; the start point ``init_noise`` [B, 1,
        T_mel, repeat_bins] or a draw from ``generator``."""
        condition = self.forward_condition(txt_tokens, mel2ph, note_midi, note_rest, mel2note,
                                           base_pitch, **cond_kw)
        out = self.diffusion.infer(condition, infer_step=infer_step, init_noise=init_noise,
                                   generator=generator)
        return out[:, 0]
