"""Pitch-curve helpers (the port's copy of the parts of
``prodiff_tpu/utils/pitch_utils.py`` the port uses)."""

from __future__ import annotations

import numpy as np

f0_bin = 256
f0_max = 1100.0
f0_min = 50.0
f0_mel_min = 1127 * np.log(1 + f0_min / 700)
f0_mel_max = 1127 * np.log(1 + f0_max / 700)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize f0 (Hz) to 256 mel-spaced bins; bin 0 reserved, 1..255 used
    (Parallel WaveGAN's pitch ids)."""
    f0_mel = 1127 * np.log(1 + np.asarray(f0) / 700)
    f0_mel[f0_mel > 0] = (f0_mel[f0_mel > 0] - f0_mel_min) * (f0_bin - 2) / (
        f0_mel_max - f0_mel_min
    ) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > f0_bin - 1] = f0_bin - 1
    f0_coarse = np.rint(f0_mel).astype(np.int64)
    assert f0_coarse.max() <= 255 and f0_coarse.min() >= 1, (f0_coarse.max(), f0_coarse.min())
    return f0_coarse


def norm_f0(f0, uv=None):
    """log2 f0, ``-inf`` where unvoiced (the reference's ``pitch_norm: log``)."""
    if uv is None:
        uv = f0 == 0
    f0 = f0.astype(np.float64) if f0.dtype.kind != "f" else f0.copy()
    f0 = np.log2(f0 + uv)
    f0[uv] = -np.inf
    return f0


def denorm_f0(f0, uv=None):
    """Inverse of :func:`norm_f0`; 0 where ``uv``."""
    f0 = 2 ** np.asarray(f0, dtype=np.float64)
    if uv is not None:
        f0[uv > 0] = 0
    return f0


def interp_f0(f0, uv=None):
    """Linearly interpolate f0 over unvoiced regions (in the log2 domain)
    -> (f0, uv)."""
    if uv is None:
        uv = f0 == 0
    f0 = norm_f0(f0, uv)
    if uv.any() and not uv.all():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return denorm_f0(f0, uv=None), uv


def resample_align_curve(points: np.ndarray, original_timestep: float,
                         target_timestep: float, align_length: int) -> np.ndarray:
    """Resample a control curve to a new time grid and pad/trim to a length."""
    t_max = (len(points) - 1) * original_timestep
    curve_interp = np.interp(
        np.arange(0, t_max, target_timestep),
        original_timestep * np.arange(len(points)),
        points,
    ).astype(points.dtype)
    delta_l = align_length - len(curve_interp)
    if delta_l < 0:
        curve_interp = curve_interp[:align_length]
    elif delta_l > 0:
        curve_interp = np.concatenate(
            (curve_interp, np.full(delta_l, fill_value=curve_interp[-1])), axis=0
        )
    return curve_interp


def shift_pitch(f0, n_semitones):
    return f0 * (2 ** (n_semitones / 12))


def midi_to_hz(midi):
    midi = np.asarray(midi, dtype=np.float64)
    return 440.0 * 2 ** ((midi - 69) / 12)


def hz_to_midi(hz):
    hz = np.asarray(hz, dtype=np.float64)
    return 69.0 + 12.0 * np.log2(np.maximum(hz, 1e-5) / 440.0)


def random_continuous_masks(rng: np.random.Generator, *shape: int, dim: int) -> np.ndarray:
    """Random ``[start, end)`` span masks along ``dim``, independent per
    leading index: one ``rng.integers(0, shape[dim] + 1)`` draw of the
    (start, end) pairs, sorted, as the JAX package draws them."""
    bounds = np.sort(
        rng.integers(0, shape[dim] + 1, size=(*shape[:dim], 2, *((1,) * (len(shape) - dim - 1)))),
        axis=dim)
    start = np.take(bounds, [0], axis=dim)
    end = np.take(bounds, [1], axis=dim)
    idx = np.arange(shape[dim]).reshape(*((1,) * dim), shape[dim], *((1,) * (len(shape) - dim - 1)))
    return (idx >= start) & (idx < end)
