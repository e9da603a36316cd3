"""Phoneme and note encoders (port of ``prodiff_tpu/models/encoder.py``:
``FastspeechEncoder`` and ``NoteEncoder``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import (
    Dropout,
    Embedding,
    FFTBlocks,
    Linear,
    SinusoidalPositionalEmbedding,
)


class FastspeechEncoder(FFTBlocks):
    """Token embedding (x sqrt(H)) + optional extra embed + sinusoidal
    positions -> FFT blocks. Padding = token id 0. Like the reference, the
    encoder IS the block stack, so its state-dict names are
    ``embed_tokens``, ``layers.{i}.op...`` and ``layer_norm``. ``dtype`` is
    the blocks' compute dtype (flax's); the embeddings stay float32. ``tp``
    splits the blocks' heads and filter channels over the model axis."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 kernel_size: int = 9, num_heads: int = 2, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None, tp=None):
        super().__init__(hidden_size, num_layers, kernel_size, num_heads, dropout, dtype, tp)
        self.hidden_size = hidden_size
        self.embed_tokens = Embedding(vocab_size, hidden_size, padding_idx=0)
        self.embed_positions = SinusoidalPositionalEmbedding(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, txt_tokens: torch.Tensor,
                extra_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding_mask = txt_tokens == 0
        x = self.hidden_size ** 0.5 * self.embed_tokens(txt_tokens)
        if extra_embed is not None:
            x = x + extra_embed
        x = self.dropout(x + self.embed_positions(~padding_mask))
        return self.run_layers(x, padding_mask)


class NoteEncoder(FFTBlocks):
    """Note-midi/dur conditioning encoder (the pitch and variance
    predictors'). Padding = ``note_midi < 0``; rest notes zero their midi
    embedding; sinusoidal positions count the non-padding notes. State-dict
    names: ``note_midi_embed``, ``note_dur_embed``, then the block stack's.
    ``dtype`` as :class:`FastspeechEncoder`'s; as in the JAX package, no
    caller sets it."""

    def __init__(self, hidden_size: int, num_layers: int, kernel_size: int = 9,
                 num_heads: int = 2, dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__(hidden_size, num_layers, kernel_size, num_heads, dropout, dtype)
        self.hidden_size = hidden_size
        self.note_midi_embed = Linear(1, hidden_size)
        self.note_dur_embed = Linear(1, hidden_size)
        self.embed_positions = SinusoidalPositionalEmbedding(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, note_midi: torch.Tensor, note_rest: torch.Tensor,
                note_dur: torch.Tensor) -> torch.Tensor:
        """note_midi, note_dur [B, T_note] float, note_rest [B, T_note] bool
        -> [B, T_note, H], zero on padding notes."""
        padding_mask = note_midi < 0
        x = self.hidden_size ** 0.5 * self.note_midi_embed(note_midi[:, :, None]) \
            * (~note_rest[:, :, None]).to(note_midi.dtype)
        x = x + self.note_dur_embed(note_dur[:, :, None])
        x = self.dropout(x + self.embed_positions(~padding_mask))
        return self.run_layers(x, padding_mask)
