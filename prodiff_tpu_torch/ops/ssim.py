"""SSIM on spectrogram "images" (port of ``prodiff_tpu/ops/ssim.py``).

The reference's window-11 Gaussian SSIM (``modules/commons/ssim.py:330-391``):
a per-channel 2-D Gaussian blur (sigma 1.5) with SAME zero padding,
C1 = 0.01^2, C2 = 0.03^2, on ``[B, C, H, W]`` images.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=4)
def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D convolution with SAME zero padding. img: [B, C, H, W]."""
    c = img.shape[1]
    kernel = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img, kernel, padding=window.shape[-1] // 2, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [B, C, H, W] images."""
    window = torch.from_numpy(gaussian_window(window_size)).to(img1.device, img1.dtype)
    mu1, mu2 = _blur(img1, window), _blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
