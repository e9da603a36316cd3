"""Sequence-regulation ops (port of ``prodiff_tpu/ops/seq.py``).

``mel2ph`` is 1-indexed: ``mel2ph[b, t] == k`` means frame ``t`` belongs to
token ``k-1``; ``0`` marks padding frames.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def length_regulator(dur: torch.Tensor, max_frames: int, alpha: float = 1.0) -> torch.Tensor:
    """Integer token durations [B, T_txt] (padding tokens 0) -> the frame to
    token map [B, max_frames] (int32): 1-indexed token ids, 0 past the total.
    ``alpha`` rescales the durations (rounded half to even, as ``jnp.round``)."""
    dur = torch.round(dur.float() * alpha).int()
    cumsum = torch.cumsum(dur, dim=1)
    pos = torch.arange(max_frames, dtype=cumsum.dtype, device=dur.device).expand(dur.shape[0], -1)
    mel2ph = torch.searchsorted(cumsum.contiguous(), pos.contiguous(), right=True).int() + 1
    return torch.where(pos < cumsum[:, -1:], mel2ph, torch.zeros_like(mel2ph))


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


def dur_to_mel2ph_host(ph_dur_sec, timestep: float, length: int) -> np.ndarray:
    """Host-side durations in seconds -> mel2ph ``[length]`` (int64), by the
    cumsum + round(+0.5) rule; frames past the durations' end repeat the last
    token."""
    ph_acc = np.round(np.cumsum(np.asarray(ph_dur_sec, dtype=np.float64)) / timestep
                      + 0.5).astype(np.int64)
    ph_dur = np.diff(ph_acc, prepend=0)
    cumsum = np.cumsum(ph_dur)
    total = int(cumsum[-1]) if len(cumsum) else 0
    mel2ph = np.zeros(max(length, total), dtype=np.int64)
    prev = 0
    for i, c in enumerate(cumsum):
        mel2ph[prev:c] = i + 1
        prev = c
    if total < length:
        mel2ph[total:length] = mel2ph[total - 1] if total > 0 else 0
    return mel2ph[:length]
