"""Phoneme encoder (port of ``prodiff_tpu/models/encoder.py:FastspeechEncoder``)."""

from __future__ import annotations

from typing import Optional

import torch

from prodiff_tpu_torch.models.common import Embedding, FFTBlocks, SinusoidalPositionalEmbedding


class FastspeechEncoder(FFTBlocks):
    """Token embedding (x sqrt(H)) + optional extra embed + sinusoidal
    positions -> FFT blocks. Padding = token id 0. Like the reference, the
    encoder IS the block stack, so its state-dict names are
    ``embed_tokens``, ``layers.{i}.op...`` and ``layer_norm``."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 kernel_size: int = 9, num_heads: int = 2):
        super().__init__(hidden_size, num_layers, kernel_size, num_heads)
        self.hidden_size = hidden_size
        self.embed_tokens = Embedding(vocab_size, hidden_size, padding_idx=0)
        self.embed_positions = SinusoidalPositionalEmbedding(hidden_size)

    def forward(self, txt_tokens: torch.Tensor,
                extra_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        padding_mask = txt_tokens == 0
        x = self.hidden_size ** 0.5 * self.embed_tokens(txt_tokens)
        if extra_embed is not None:
            x = x + extra_embed
        x = x + self.embed_positions(~padding_mask)
        return self.run_layers(x, padding_mask)
