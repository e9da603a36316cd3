"""Diffusion noise schedules on the host (the port's copy of
``prodiff_tpu/ops/schedules.py``: the schedule list and
``DiffusionCoefficients``)."""

from __future__ import annotations

import numpy as np


def vpsde_beta_t(t: int, T: int, min_beta: float, max_beta: float) -> float:
    t_coef = (2 * t - 1) / (T ** 2)
    return 1.0 - np.exp(-min_beta / T - 0.5 * (max_beta - min_beta) * t_coef)


def logsnr_schedule_cosine(t: float, *, logsnr_min: float, logsnr_max: float) -> float:
    b = np.arctan(np.exp(-0.5 * logsnr_max))
    a = np.arctan(np.exp(-0.5 * logsnr_min)) - b
    return -2.0 * np.log(np.tan(a * t + b))


def get_noise_schedule_list(schedule_mode: str, timesteps: int, min_beta: float = 0.0,
                            max_beta: float = 0.01, s: float = 0.008) -> np.ndarray:
    if schedule_mode == "linear":
        return np.linspace(1e-4, max_beta, timesteps)
    if schedule_mode == "cosine":
        steps = timesteps + 1
        x = np.linspace(0, steps, steps)
        alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        return np.clip(betas, a_min=0, a_max=0.999)
    if schedule_mode == "vpsde":
        return np.array([vpsde_beta_t(t, timesteps, min_beta, max_beta)
                         for t in range(1, timesteps + 1)])
    if schedule_mode == "logsnr":
        return np.array([logsnr_schedule_cosine(t / timesteps, logsnr_min=-20.0, logsnr_max=20.0)
                         for t in range(1, timesteps + 1)])
    raise NotImplementedError(schedule_mode)


class DiffusionCoefficients:
    """The q-sample and posterior coefficients of an x0-prediction DDPM, each
    of length ``timesteps + 1`` (the schedule is built with ``timesteps + 1``
    entries)."""

    def __init__(self, timesteps: int, schedule_type: str = "vpsde",
                 max_beta: float = 0.02, min_beta: float = 0.1):
        betas = get_noise_schedule_list(schedule_type, timesteps + 1, min_beta=min_beta,
                                        max_beta=max_beta, s=0.008)
        betas = np.asarray(betas, dtype=np.float64)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        self.sqrt_alphas_cumprod = np.sqrt(alphas_cumprod).astype(np.float32)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - alphas_cumprod).astype(np.float32)
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        self.posterior_log_variance_clipped = np.log(
            np.maximum(posterior_variance, 1e-20)).astype(np.float32)
        self.posterior_mean_coef1 = (
            betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)).astype(np.float32)
        self.posterior_mean_coef2 = (
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ).astype(np.float32)
