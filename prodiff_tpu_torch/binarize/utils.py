"""Curve helpers (the port's copy of ``prodiff_tpu/binarize/utils.py:sinusoidal_smooth``)."""

from __future__ import annotations

import numpy as np


def sinusoidal_smooth(curve: np.ndarray, kernel_size: int) -> np.ndarray:
    """Half-sine smoothing kernel with replicate padding (the reference's
    ``SinusoidalSmoothingConv1d``)."""
    if len(curve) == 0:
        return np.asarray(curve, np.float32)
    kernel = np.sin(np.linspace(0, 1, kernel_size) * np.pi)
    kernel /= kernel.sum()
    lpad = (kernel_size - 1) // 2
    rpad = kernel_size - 1 - lpad
    padded = np.concatenate([np.full(lpad, curve[0]), curve, np.full(rpad, curve[-1])])
    # torch conv = correlation; the kernel is symmetric anyway
    return np.convolve(padded, kernel[::-1], mode="valid").astype(np.float32)
