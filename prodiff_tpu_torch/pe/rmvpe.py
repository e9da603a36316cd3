"""The RMVPE pitch extractor (port of ``prodiff_tpu/pe/rmvpe.py``).

Resample to 16 kHz on the host (``scipy.signal.resample_poly``, as the JAX
package does) -> 128-bin htk log-mel (centred, hop 160) -> ``E2E0`` on the
extractor's device, the frames padded to a multiple of 32 -> the
local-average decode on the host -> the 10 ms curve interpolated over
unvoiced frames and resampled onto the hop grid. The checkpoint is
``pe_ckpt``: a torch state dict under the reference's names.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import resample_poly

from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.models.rmvpe import (E2E0, MEL_FMAX, MEL_FMIN, N_MELS, SAMPLE_RATE,
                                            WINDOW_LENGTH, rmvpe_checkpoint,
                                            to_local_average_f0, to_viterbi_f0)
from prodiff_tpu_torch.ops.mel import mel_filterbank, stft_magnitude
from prodiff_tpu_torch.pe import BasePitchExtractor, register_pe
from prodiff_tpu_torch.utils.pitch_utils import interp_f0, resample_align_curve


@register_pe
class RMVPE(BasePitchExtractor):
    def __init__(self, hparams: dict, model_path: str = None, hop_length: int = 160, device=None):
        from prodiff_tpu_torch.utils.convert import load_torch_state_dict

        self.hparams, self.hop_length = hparams, hop_length
        self.device = resolve_device(device)
        self.model = E2E0(4, 1, (2, 2))
        self.model.load_state_dict(rmvpe_checkpoint(
            load_torch_state_dict(model_path or hparams["pe_ckpt"])))
        self.model.to(self.device).eval()
        self.mel_basis = torch.from_numpy(mel_filterbank(
            SAMPLE_RATE, WINDOW_LENGTH, N_MELS, MEL_FMIN, MEL_FMAX, htk=True, norm="slaney",
        )).to(self.device)
        n = np.arange(WINDOW_LENGTH)
        self.window = torch.from_numpy(
            (0.5 - 0.5 * np.cos(2 * np.pi * n / WINDOW_LENGTH)).astype(np.float32)).to(self.device)

    def mel(self, audio16k: np.ndarray) -> torch.Tensor:
        """16 kHz audio [L] -> natural-log htk mel [1, M, T] on the device."""
        y = torch.as_tensor(np.asarray(audio16k, np.float32), device=self.device)[None, None]
        y = F.pad(y, (WINDOW_LENGTH // 2, WINDOW_LENGTH // 2), mode="reflect")[:, 0]
        spec = stft_magnitude(y, self.window, WINDOW_LENGTH, self.hop_length, WINDOW_LENGTH)
        return torch.log(torch.clamp(torch.matmul(self.mel_basis, spec), min=1e-5))

    @torch.no_grad()
    def salience(self, audio16k: np.ndarray) -> np.ndarray:
        """16 kHz audio -> E2E0's salience [T, N_CLASS] (host numpy)."""
        mel = self.mel(audio16k)
        n_frames = mel.shape[-1]
        mel = F.pad(mel, (0, 32 * ((n_frames - 1) // 32 + 1) - n_frames))
        return self.model(mel.transpose(1, 2))[0, :n_frames].cpu().numpy()

    def infer_from_audio(self, audio: np.ndarray, sample_rate=16000, thred=0.03,
                         use_viterbi=False) -> np.ndarray:
        if sample_rate != SAMPLE_RATE:
            g = gcd(int(sample_rate), SAMPLE_RATE)
            audio = resample_poly(audio, SAMPLE_RATE // g, int(sample_rate) // g)
        hidden = self.salience(audio)
        return (to_viterbi_f0 if use_viterbi else to_local_average_f0)(hidden, thred=thred)

    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False):
        f0 = self.infer_from_audio(np.asarray(waveform, np.float32), samplerate)
        uv = f0 == 0
        f0, uv = interp_f0(f0, uv)
        time_step = int(np.round(hop_size * speed)) / samplerate
        f0_res = resample_align_curve(f0.astype(np.float32), 0.01, time_step, length)
        uv_res = resample_align_curve(uv.astype(np.float32), 0.01, time_step, length) > 0.5
        if not interp_uv:
            f0_res[uv_res] = 0
        return f0_res, uv_res
