"""Complex STFT and inverse STFT (port of ``prodiff_tpu/ops/stft_extras.py``).

``torch.stft``/``torch.istft`` conventions, used by the k-th-harmonic
extraction (``binarize/utils.py:get_kth_harmonic``) and the VR separation
model (``models/vr.py``). They run where their input lies: ``torch.fft`` and
one ``F.fold`` overlap-add, no hand-written kernel.

:func:`istft` divides the overlap-add by ``max(sum of squared windows,
1e-11)`` as the JAX function does, instead of calling ``torch.istft``: the
Nuttall window is 0 at its first sample, where ``torch.istft``'s
window-overlap check can refuse the input that the JAX code divides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def nuttall_window(win_size: int) -> np.ndarray:
    """The periodic 4-term Nuttall window, float32 (0 at n = 0)."""
    phase = np.arange(win_size, dtype=np.float64) / win_size * 2 * np.pi
    return (0.355768 - 0.487396 * np.cos(phase) + 0.144232 * np.cos(2 * phase)
            - 0.012604 * np.cos(3 * phase)).astype(np.float32)


def stft_complex(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """y [B, L] -> complex spec [B, n_fft//2 + 1, n_frames]; ``center``
    reflect-pads ``n_fft // 2`` samples on each side. ``window`` has
    ``n_fft`` samples."""
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * window  # [B, n_frames, n_fft]
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[B, n_frames, n] -> [B, n + hop * (n_frames - 1)], each frame added
    at ``hop * index``."""
    b, n_frames, n = frames.shape
    total = n + hop * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, n),
                 stride=(1, hop))
    return out.reshape(b, total)


def istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
          length: int) -> torch.Tensor:
    """Complex spec [B, F, n_frames] -> [B, length] (``torch.istft`` with
    ``center=True``): the windowed frames overlap-added and divided by the
    summed squared window (floored at 1e-11), then ``n_fft // 2`` samples
    dropped at the start, zero-padded up to ``length`` where short."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[1]
    wav = _overlap_add(frames, hop)
    wsq = _overlap_add((window ** 2).expand(1, n_frames, n_fft), hop)
    wav = wav / torch.clamp(wsq, min=1e-11)
    start = n_fft // 2
    avail = wav.shape[1] - start
    if avail < length:
        wav = F.pad(wav, (0, length - avail))
    return wav[:, start:start + length]
