"""Built-in autocorrelation pitch extractor, Boersma (1993), Praat's
``Sound: To Pitch (ac)`` (port of ``prodiff_tpu/pe/acf.py``).

1. Frames of 3 periods of ``f0_min``, mean removed, Hann windowed; the
   normalised autocorrelation by FFT, divided by the window's (Boersma
   eq. 9). This part runs on the card unless the caller names the CPU
   (``torch.fft``; no hand-written kernel).
2. On the host, in numpy as in the JAX package: per frame up to 15
   candidates refined on the windowed-sinc-interpolated ACF (depth 30 per
   side), voiced/unvoiced strengths (eqs. 23, 26), and a Viterbi path with
   octave-jump and voicing-flip costs scaled by 0.01 / time_step.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.pe import BasePitchExtractor, pad_frames, register_pe
from prodiff_tpu_torch.utils.pitch_utils import interp_f0

MAX_CANDIDATES = 15
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14
SINC_DEPTH = 30  # Praat NUM_PEAK_INTERPOLATE_SINC70 band (depth 30/side)


def _sinc_values(r: np.ndarray, t: np.ndarray, depth: int = SINC_DEPTH) -> np.ndarray:
    """Windowed-sinc interpolation of each frame's ACF at fractional lags.

    r: [N, L]; t: [N, K, P] fractional lags -> values [N, K, P]
    (Praat ``NUM_interpolate_sinc``: sinc kernel of ``depth`` taps per side
    under a raised-cosine taper).
    """
    n, L = r.shape
    base = np.floor(t).astype(np.int64)
    taps = np.arange(-depth + 1, depth + 1)
    idx = base[..., None] + taps  # [N, K, P, 2*depth]
    d = t[..., None] - idx
    idx = np.clip(idx, 0, L - 1)
    taper = np.where(
        np.abs(d) < depth + 1,
        0.5 * (1.0 + np.cos(np.pi * d / (depth + 1))),
        0.0,
    )
    kern = np.sinc(d) * taper
    vals = r[np.arange(n)[:, None, None, None], idx]
    return (vals * kern).sum(axis=-1)


def _sinc_refine(r: np.ndarray, best_lag: np.ndarray, chunk: int = 256):
    """Two-stage grid search on the sinc-interpolated ACF around each integer
    candidate lag (replaces parabolic refinement for exact-Praat accuracy;
    final resolution 0.01 sample + parabolic, i.e. sub-0.1-cent at audio
    rates). Returns (lag_ref, r_ref), each [N, K]."""
    n = r.shape[0]
    lag_out = np.zeros(best_lag.shape, np.float64)
    r_out = np.zeros(best_lag.shape, np.float64)
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        lag0 = best_lag[sl].astype(np.float64)
        t_best = lag0
        for half_width, pts in [(1.0, 21), (0.1, 21)]:
            offs = np.linspace(-half_width, half_width, pts)
            t = t_best[..., None] + offs  # [n, K, P]
            v = _sinc_values(r[sl], t)
            k = np.argmax(v, axis=-1)
            # parabolic touch-up on the grid triplet around the max
            k_in = np.clip(k, 1, pts - 2)
            ii = np.indices(k.shape)
            vm1, v0, vp1 = (
                v[ii[0], ii[1], k_in - 1],
                v[ii[0], ii[1], k_in],
                v[ii[0], ii[1], k_in + 1],
            )
            denom = 2 * (2 * v0 - vm1 - vp1)
            shift = np.where(
                np.abs(denom) > 1e-12, (vp1 - vm1) / np.where(denom == 0, 1, denom), 0.0
            )
            shift = np.clip(shift, -1.0, 1.0)
            step = offs[1] - offs[0]
            t_best = np.take_along_axis(t, k_in[..., None], -1)[..., 0] + shift * step
        r_out[sl] = _sinc_values(r[sl], t_best[..., None])[..., 0]
        lag_out[sl] = t_best
    return lag_out, r_out


def _acf_frames(x: torch.Tensor, window: torch.Tensor, frame_len: int, hop: int,
                fft_len: int):
    """-> (normalised lag-domain ACF [n_frames, frame_len], frame peaks), on
    x's device."""
    frames = x.unfold(0, frame_len, hop)  # [n_frames, frame_len]
    peaks = frames.abs().amax(dim=1)
    frames = frames - frames.mean(dim=1, keepdim=True)
    spec = torch.fft.rfft(frames * window, n=fft_len, dim=1)
    acf = torch.fft.irfft(spec.abs() ** 2, n=fft_len, dim=1)[:, :frame_len]
    acf = acf / torch.clamp(acf[:, :1], min=1e-12)
    # window autocorrelation for normalisation (Boersma eq. 9)
    wspec = torch.fft.rfft(window, n=fft_len)
    wacf = torch.fft.irfft(wspec.abs() ** 2, n=fft_len)[:frame_len]
    wacf = wacf / torch.clamp(wacf[0], min=1e-12)
    return acf / torch.clamp(wacf[None, :], min=1e-3), peaks


def _candidates(r, peaks, global_peak, sr, f0_min, f0_max, voicing_threshold):
    """Per-frame pitch candidates.

    Returns freq [N, K] (0 = unvoiced candidate at k=0) and strength [N, K].
    """
    n_frames, frame_len = r.shape
    lag_min = max(2, int(np.floor(sr / f0_max)))
    lag_max = min(frame_len - 2, int(np.ceil(sr / f0_min)))

    # local maxima inside the band
    interior = r[:, 1:-1]
    is_max = (interior > r[:, :-2]) & (interior >= r[:, 2:])
    lags = np.arange(1, frame_len - 1)
    band = (lags >= lag_min) & (lags <= lag_max)
    cand_mask = is_max & band[None, :]

    # keep the strongest K-1 voiced candidates per frame
    k_voiced = MAX_CANDIDATES - 1
    masked_r = np.where(cand_mask, interior, -np.inf)
    top = np.argpartition(-masked_r, k_voiced, axis=1)[:, :k_voiced]
    rows = np.arange(n_frames)[:, None]
    top_r = masked_r[rows, top]
    best_lag = top + 1  # interior offset

    # windowed-sinc peak refinement, depth 30 per side (Praat
    # NUM_PEAK_INTERPOLATE_SINC70; closes the round-2 "parabolic only" delta)
    lag_ref, r_ref = _sinc_refine(r, best_lag)
    # values > 1 are normalisation artefacts: reflect (Praat)
    r_ref = np.where(r_ref > 1.0, 1.0 / np.maximum(r_ref, 1e-9), r_ref)

    freq = sr / np.maximum(lag_ref, 1e-9)
    valid = np.isfinite(top_r) & (freq >= f0_min) & (freq <= f0_max)
    strength = np.where(
        valid,
        r_ref - OCTAVE_COST * np.log2(np.maximum(f0_min * lag_ref / sr, 1e-9)),
        -np.inf,
    )
    freq = np.where(valid, freq, 0.0)

    # unvoiced candidate (k=0)
    intensity = peaks / max(global_peak, 1e-12)
    r_unvoiced = voicing_threshold + np.maximum(
        0.0, 2.0 - intensity / (SILENCE_THRESHOLD / (1.0 + voicing_threshold))
    )
    freq_all = np.concatenate([np.zeros((n_frames, 1)), freq], axis=1)
    str_all = np.concatenate([r_unvoiced[:, None], strength], axis=1)
    return freq_all, str_all


def _path_finder(freq, strength, time_step):
    """Viterbi over candidates, maximising Σ strength − Σ transition cost."""
    n_frames, k = freq.shape
    correction = 0.01 / max(time_step, 1e-6)
    jump_cost = OCTAVE_JUMP_COST * correction
    vuv_cost = VOICED_UNVOICED_COST * correction

    voiced = freq > 0
    logf = np.where(voiced, np.log2(np.maximum(freq, 1e-9)), 0.0)

    score = strength[0].copy()
    back = np.zeros((n_frames, k), np.int32)
    for i in range(1, n_frames):
        # transition [from, to]
        both_v = voiced[i - 1][:, None] & voiced[i][None, :]
        flip = voiced[i - 1][:, None] != voiced[i][None, :]
        trans = np.where(
            both_v,
            jump_cost * np.abs(logf[i - 1][:, None] - logf[i][None, :]),
            np.where(flip, vuv_cost, 0.0),
        )
        total = score[:, None] - trans
        back[i] = np.argmax(total, axis=0)
        score = total[back[i], np.arange(k)] + strength[i]

    path = np.zeros(n_frames, np.int32)
    path[-1] = int(np.argmax(score))
    for i in range(n_frames - 1, 0, -1):
        path[i - 1] = back[i, path[i]]
    return freq[np.arange(n_frames), path]


@register_pe
class ACF(BasePitchExtractor):
    def __init__(self, hparams: dict, device: Optional[Union[str, torch.device]] = None):
        super().__init__(hparams)
        self.device = resolve_device(device)  # the card unless the CPU is named

    def get_pitch(self, waveform, samplerate, length, *, hop_size,
                  f0_min=65, f0_max=1100, speed=1, interp_uv=False,
                  voicing_threshold=0.6):
        """-> (f0 [length] Hz, uv [length]), numpy."""
        waveform = np.asarray(waveform, np.float32)
        hop = int(np.round(hop_size * speed))
        # 3 periods of f0_min (Praat periods_per_window for the AC method)
        frame_len = int(round(3 * samplerate / f0_min))
        fft_len = int(2 ** np.ceil(np.log2(2 * frame_len)))
        pad = frame_len // 2
        x = np.pad(waveform, (pad, pad))
        window = np.hanning(frame_len).astype(np.float32)

        r, peaks = _acf_frames(torch.from_numpy(x).to(self.device),
                               torch.from_numpy(window).to(self.device), frame_len, hop, fft_len)
        r, peaks = r.cpu().numpy(), peaks.cpu().numpy()
        global_peak = float(np.abs(waveform).max())

        freq, strength = _candidates(
            r, peaks, global_peak, samplerate, f0_min, f0_max, voicing_threshold
        )
        f0 = _path_finder(freq, strength, hop / samplerate).astype(np.float32)

        f0 = pad_frames(f0, hop, waveform.shape[0], length)
        uv = f0 == 0
        if interp_uv:
            f0, uv = interp_f0(f0, uv)
        return f0, uv
