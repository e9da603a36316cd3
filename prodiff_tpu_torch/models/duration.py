"""Duration predictor (port of ``prodiff_tpu/models/duration.py``).

A conv stack over the phoneme encoder's output predicts log-domain
durations; ``exp() - offset`` gives frames-or-seconds, clamped at 0 only at
inference. Its LayerNorm epsilon is 1e-12, as in the JAX module (the FFT
blocks' is flax's 1e-6). State-dict names follow the torch reference:
``dur_pred.conv.{i}.0`` (conv), ``dur_pred.conv.{i}.2`` (LayerNorm),
``dur_pred.linear``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import Dropout, Embedding, Linear
from prodiff_tpu_torch.models.encoder import FastspeechEncoder

DUR_LN_EPS = 1e-12


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over dim 1 of ``[B, C, T]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, -1)).transpose(1, -1)


class DurationPredictor(nn.Module):
    def __init__(self, in_dims: int, n_layers: int = 2, n_chans: int = 384,
                 kernel_size: int = 3, dropout_rate: float = 0.1, offset: float = 1.0):
        super().__init__()
        self.offset = offset
        self.conv = nn.ModuleList(
            nn.Sequential(nn.Conv1d(in_dims if i == 0 else n_chans, n_chans, kernel_size,
                                    padding="same"),
                          nn.ReLU(), ChannelLayerNorm(n_chans, eps=DUR_LN_EPS),
                          Dropout(dropout_rate))
            for i in range(n_layers))
        self.linear = Linear(n_chans, 1)

    def forward(self, xs: torch.Tensor, x_masks: torch.Tensor, infer: bool = True) -> torch.Tensor:
        """xs [B, T, H], x_masks [B, T] True at padding -> durations [B, T]."""
        nonpad = (~x_masks).to(xs.dtype)[:, None, :]
        xs = xs.transpose(1, 2)
        for layer in self.conv:
            xs = layer(xs) * nonpad
        xs = self.linear(xs.transpose(1, 2))[..., 0] * nonpad[:, 0]  # log domain
        dur = torch.exp(xs) - self.offset
        return dur.clamp_min(0.0) if infer else dur


class DurPredictor(nn.Module):
    """Phoneme encoder (+ onset and word-duration embeds) -> DurationPredictor."""

    def __init__(self, vocab_size: int, hparams: Dict[str, Any]):
        super().__init__()
        hp, hidden = hparams, hparams["hidden_size"]
        self.encoder = FastspeechEncoder(vocab_size, hidden, hp["enc_layers"],
                                         hp["enc_ffn_kernel_size"], hp["num_heads"])
        dur_hp = hp["dur_prediction_args"]
        self.onset_embed = Embedding(2, hidden, padding_idx=None)
        self.word_dur_embed = Linear(1, hidden)
        self.dur_pred = DurationPredictor(
            hidden, n_layers=dur_hp["num_layers"], n_chans=dur_hp["hidden_size"],
            kernel_size=dur_hp["kernel_size"], dropout_rate=dur_hp["dropout"],
            offset=dur_hp["log_offset"])

    def forward(self, txt_tokens: torch.Tensor, onset: torch.Tensor, word_dur: torch.Tensor,
                infer: bool = True) -> torch.Tensor:
        """tokens, onset [B, T_ph] int, word_dur [B, T_ph] float -> [B, T_ph]."""
        extra_embed = self.onset_embed(onset) + self.word_dur_embed(word_dur[:, :, None])
        encoder_out = self.encoder(txt_tokens, extra_embed)
        return self.dur_pred(encoder_out, txt_tokens == 0, infer=infer)
