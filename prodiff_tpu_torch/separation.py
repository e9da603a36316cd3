"""Harmonic/aperiodic separation with the VR model (port of
``prodiff_tpu/separation.py``): the entry point the binarizers, the infer
handler and the web server use.

The separation model is loaded once per (checkpoint path, device) and kept;
the JAX package keeps one model for its process, whatever path comes next.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from prodiff_tpu_torch.device import resolve_device

_VR_MODELS: Dict[Tuple[str, str], object] = {}


def extract_harmonic_aperiodic(waveform: np.ndarray, model_path: str, device=None):
    """-> (harmonic part, aperiodic part = wav - harmonic), host numpy; the
    model runs on ``device`` (default: the card)."""
    from prodiff_tpu_torch.models.vr import load_sep_model

    device = resolve_device(device)
    key = (os.path.abspath(model_path), str(device))
    if key not in _VR_MODELS:
        _VR_MODELS[key] = load_sep_model(model_path, device)
    wav = np.asarray(waveform, np.float32)
    harmonic = _VR_MODELS[key].predict_from_audio(wav)
    return harmonic, wav - harmonic


def get_kth_harmonic(k, harmonic_part, f0, hop_size, win_size, samplerate, half_width=3.5,
                     device=None):
    from prodiff_tpu_torch.binarize.utils import get_kth_harmonic as _impl

    return _impl(k, harmonic_part, f0, hop_size, win_size, samplerate, half_width, device=device)
