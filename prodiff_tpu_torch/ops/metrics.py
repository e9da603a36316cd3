"""Quality metrics: mel-cepstral distortion (port of
``prodiff_tpu/ops/metrics.py``), on tensors of any device."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def _dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_out, n_in] (sptk/librosa mfcc convention)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= np.sqrt(0.5)
    return basis.astype(np.float32)


def mel_to_cepstra(log_mel: torch.Tensor, n_mfcc: int = 13) -> torch.Tensor:
    """log-mel [T, M] (any log base: scale-invariant up to a constant) ->
    cepstra [T, n_mfcc] via DCT-II."""
    dct = torch.as_tensor(_dct_matrix(log_mel.shape[-1], n_mfcc), device=log_mel.device)
    return log_mel @ dct.T


def mel_cepstral_distortion(mel_a: torch.Tensor, mel_b: torch.Tensor, n_mfcc: int = 13,
                            exclude_c0: bool = True) -> torch.Tensor:
    """MCD in dB between two log10-mel spectrograms [T, M] (equal length):
    ``(10 / ln 10) * sqrt(2 * sum_k (c_a[k] - c_b[k])^2)`` averaged over
    frames, c0 (the overall energy) left out by convention."""
    ca = mel_to_cepstra(mel_a * np.log(10), n_mfcc)  # natural-log cepstra, the MCD domain
    cb = mel_to_cepstra(mel_b * np.log(10), n_mfcc)
    if exclude_c0:
        ca, cb = ca[:, 1:], cb[:, 1:]
    dist = torch.sqrt(2.0 * torch.sum((ca - cb) ** 2, dim=-1))
    return (10.0 / np.log(10)) * torch.mean(dist)
