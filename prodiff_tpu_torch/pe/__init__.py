"""Pitch-extractor registry (port of ``prodiff_tpu/pe/__init__.py``).

``acf`` is the built-in autocorrelation extractor; ``parselmouth`` wraps the
praat-parselmouth library and falls back to ACF where that library is
absent, as in the JAX package; ``rmvpe`` (``pe/rmvpe.py``, a DeepUnet +
BiGRU model, the base config's extractor) reads its checkpoint from
``pe_ckpt`` and raises where that names no file, as in the JAX package.
"""

from __future__ import annotations

import importlib.util
from typing import Dict

PITCHEXTRACTORS: Dict[str, type] = {}


def register_pe(cls):
    PITCHEXTRACTORS[cls.__name__.lower()] = cls
    return cls


def get_pe_cls(name: str):
    from prodiff_tpu_torch.pe import acf, parselmouth_pe, rmvpe  # noqa: F401

    key = name.lower()
    if key == "parselmouth" and importlib.util.find_spec("parselmouth") is None:
        # the library is absent: the built-in autocorrelation extractor keeps
        # the pipeline usable
        print(f"| pitch extractor {name!r} unavailable; falling back to built-in ACF PE")
        return PITCHEXTRACTORS["acf"]
    if key not in PITCHEXTRACTORS:
        raise ValueError(f"Unknown pitch extractor: {name}")
    return PITCHEXTRACTORS[key]


class BasePitchExtractor:
    def __init__(self, hparams: dict, device=None):
        """``device``: where an extractor with a device part runs (ACF,
        RMVPE); a host-only extractor ignores it."""
        self.hparams = hparams

    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False):
        """-> (f0 [length], uv [length])"""
        raise NotImplementedError


def pad_frames(frames, hop_size, n_samples, n_expect):
    """Centre-pad a frame-rate curve to the mel frame count (the reference's
    ``utils/data_gen_utils.pad_frames``)."""
    import numpy as np

    n_frames = len(frames)
    lpad = (int(n_samples // hop_size) - n_frames + 1) // 2
    rpad = n_expect - n_frames - lpad
    if rpad < 0:
        frames = frames[: n_expect - lpad]
        rpad = 0
    if lpad > 0 or rpad > 0:
        frames = np.pad(frames, (max(lpad, 0), rpad), mode="constant")
    if lpad < 0:
        frames = frames[-lpad:]
    return frames[:n_expect]
