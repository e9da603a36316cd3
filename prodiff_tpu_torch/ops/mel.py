"""STFT + mel spectrogram (port of ``prodiff_tpu/ops/mel.py``).

The nvSTFT mel pipeline: reflect pad by ``((win-hop)//2, (win-hop+1)//2)``,
non-centred framing, periodic Hann window, the windowed frame zero-padded
symmetrically to ``n_fft``, rFFT magnitude, the Slaney mel filterbank, then
natural-log compression with clip 1e-5. ``wav2mel_log10`` converts ln ->
log10 with the reference's truncated ``0.434294``; the NSF-HiFiGAN wrapper
converts back with ``2.30259``. The filterbank is computed on the host in
numpy, as in the JAX package (librosa-equivalent, no librosa). The rest runs
on the card unless the caller names the CPU; it has no hand-written kernel
(``torch.fft.rfft`` and one matrix product).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from prodiff_tpu_torch.device import resolve_device

LN_TO_LOG10 = 0.434294  # the reference's truncated constant at binarize
LOG10_TO_LN = 2.30259  # and this one at vocode


def hz_to_mel(frequencies, htk: bool = False):
    frequencies = np.asarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    return np.where(
        log_t,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney") -> np.ndarray:
    """Triangular mel filterbank, [n_mels, n_fft//2 + 1] (librosa-equivalent)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]  # [n_mels+2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def hann_window(win_size: int) -> np.ndarray:
    """The periodic Hann window (``torch.hann_window``'s default), float32."""
    n = np.arange(win_size, dtype=np.float32)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_size)).astype(np.float32)


def stft_magnitude(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
                   win_size: int) -> torch.Tensor:
    """|STFT| of non-centred frames: y [B, L] -> [B, n_fft//2 + 1, n_frames]."""
    frames = y.unfold(-1, win_size, hop) * window  # [B, n_frames, win]
    if win_size < n_fft:  # torch zero-pads the windowed frame symmetrically
        lpad = (n_fft - win_size) // 2
        frames = F.pad(frames, (lpad, n_fft - win_size - lpad))
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs().transpose(-1, -2)


class MelSpectrogram:
    """nvSTFT-equivalent mel extractor with keyshift/speed support:
    ``keyshift`` rescales n_fft and the window, ``speed`` the hop, as in the
    reference (``nvSTFT.py:58-61``). Runs on ``device`` (default: the card)."""

    def __init__(self, sr: int = 44100, n_mels: int = 128, n_fft: int = 2048,
                 win_size: int = 2048, hop_length: int = 512, fmin: float = 40,
                 fmax: float = 16000, clip_val: float = 1e-5,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.sr, self.n_mels, self.n_fft = sr, n_mels, n_fft
        self.win_size, self.hop_length = win_size, hop_length
        self.fmin, self.fmax, self.clip_val = fmin, fmax, clip_val
        self.mel_basis = torch.from_numpy(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(self.device)  # [M, F]

    def get_mel(self, y, keyshift: int = 0, speed: float = 1.0) -> torch.Tensor:
        """y [B, L] in [-1, 1] -> log-mel (natural log) [B, M, T] on the device."""
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        factor = 2 ** (keyshift / 12)
        n_fft_new = int(np.round(self.n_fft * factor))
        win_size_new = int(np.round(self.win_size * factor))
        hop_new = int(np.round(self.hop_length * speed))
        pad_l = (win_size_new - hop_new) // 2
        pad_r = (win_size_new - hop_new + 1) // 2
        y = F.pad(y[:, None], (pad_l, pad_r), mode="reflect")[:, 0]
        window = torch.from_numpy(hann_window(win_size_new)).to(self.device)
        spec = stft_magnitude(y, window, n_fft_new, hop_new, win_size_new)  # [B, F_new, T]
        if keyshift != 0:
            size = self.n_fft // 2 + 1
            resize = spec.shape[1]
            if resize < size:
                spec = F.pad(spec, (0, 0, 0, size - resize))
            spec = spec[:, :size, :] * self.win_size / win_size_new
        mel = torch.matmul(self.mel_basis, spec)
        return torch.log(torch.clamp(mel, min=self.clip_val))

    def wav2mel_log10(self, y, keyshift: int = 0, speed: float = 1.0) -> torch.Tensor:
        """[B, L] -> [B, T, M] log10-mel, the training convention (the
        reference's ``binarizer_utils.get_mel_spec``)."""
        mel = self.get_mel(y, keyshift=keyshift, speed=speed) * LN_TO_LOG10
        return mel.transpose(1, 2)
