"""Wav helpers (the port's copy of the parts of ``prodiff_tpu/utils/audio.py``
the port uses)."""

from __future__ import annotations

import numpy as np


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Write a float wav in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float64)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Linearly cross-fade segment ``b`` into ``a`` starting at sample ``idx``
    (stitches the per-segment renders of a long song)."""
    result = np.zeros(idx + b.shape[0])
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx: a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0]:] = b[fade_len:]
    return result
