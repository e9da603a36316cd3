"""The pitch predictor's base melody (the port's copy of
``prodiff_tpu/binarize/pitch_predictor.py:base_pitch_curve``)."""

from __future__ import annotations

import numpy as np

from prodiff_tpu_torch.binarize.utils import sinusoidal_smooth


def base_pitch_curve(note_midi, mel2note, smooth_kernel: int) -> np.ndarray:
    """Note midi gathered to frames (``mel2note`` 1-indexed, 0 = -1) then
    half-sine smoothed over ``smooth_kernel`` frames."""
    frame_pitch = np.concatenate([[-1.0], note_midi])[mel2note]
    return sinusoidal_smooth(frame_pitch.astype(np.float32), smooth_kernel)
