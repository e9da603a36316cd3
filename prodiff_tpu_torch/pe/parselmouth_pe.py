"""Praat autocorrelation pitch extractor through the praat-parselmouth
library (port of ``prodiff_tpu/pe/parselmouth_pe.py``). The library is
imported when a pitch is asked for; :func:`~prodiff_tpu_torch.pe.get_pe_cls`
hands out ACF instead where it is absent."""

from __future__ import annotations

import numpy as np

from prodiff_tpu_torch.pe import BasePitchExtractor, pad_frames, register_pe
from prodiff_tpu_torch.utils.pitch_utils import interp_f0


@register_pe
class Parselmouth(BasePitchExtractor):
    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False):
        import parselmouth

        hop = int(np.round(hop_size * speed))
        f0 = (
            parselmouth.Sound(waveform, samplerate)
            .to_pitch_ac(time_step=hop / samplerate, voicing_threshold=0.6,
                         pitch_floor=f0_min, pitch_ceiling=f0_max)
            .selected_array["frequency"]
            .astype(np.float32)
        )
        f0 = pad_frames(f0, hop, waveform.shape[0], length)
        uv = f0 == 0
        if interp_uv:
            f0, uv = interp_f0(f0, uv)
        return f0, uv
