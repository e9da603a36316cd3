"""Wav helpers (the port's copy of the parts of ``prodiff_tpu/utils/audio.py``
the port uses)."""

from __future__ import annotations

import numpy as np


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Write a float wav in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float64)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))


def load_wav(path: str, sr: int = None) -> tuple:
    """Load a wav as float32 in [-1, 1] (int16/int32/uint8 scaled, several
    channels averaged to mono); resample on the host if ``sr`` differs, which
    needs librosa (imported only then)."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr is not None and file_sr != sr:
        import librosa

        data = librosa.resample(data, orig_sr=file_sr, target_sr=sr)
        file_sr = sr
    return data, file_sr


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20 * np.log10(np.maximum(1e-5, x))


def db_to_amp(x: np.ndarray) -> np.ndarray:
    return 10.0 ** (x * 0.05)


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
