"""Sequence-regulation ops (port of ``prodiff_tpu/ops/seq.py``).

``mel2ph`` is 1-indexed: ``mel2ph[b, t] == k`` means frame ``t`` belongs to
token ``k-1``; ``0`` marks padding frames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int, max_dur: Optional[int] = None) -> torch.Tensor:
    """[B, T_mel] token map -> per-token frame counts [B, t_txt] (int64)."""
    dur = torch.zeros(mel2ph.shape[0], t_txt + 1, dtype=torch.long, device=mel2ph.device)
    dur.scatter_add_(1, mel2ph.long(), torch.ones_like(mel2ph, dtype=torch.long))
    dur = dur[:, 1:]
    if max_dur is not None:
        dur = dur.clamp(max=max_dur)
    return dur


def regulate_hidden(encoder_out: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Gather token hiddens [B, T_txt, H] to frames [B, T_mel, H] through
    mel2ph; padding frames (``mel2ph == 0``) gather zeros."""
    padded = F.pad(encoder_out, (0, 0, 1, 0))
    idx = mel2ph.long()[..., None].expand(-1, -1, encoder_out.shape[-1])
    return torch.gather(padded, 1, idx)
