"""x0-prediction DDPM sampling (port of the inference branch of
``prodiff_tpu/models/diffusion.py:GaussianDiffusion``).

Tensors are ``[B, F, T, M]`` (the denoiser sees ``[B, T, F*M]``). The
sampling loop is a Python loop over the (default 4) steps. Inference starts
from **uniform** noise by default, the reference's quirk that the JAX package
keeps (``noise_init: "gaussian"`` for the standard start). ``init_noise`` /
``step_noises`` inject the randomness explicitly; otherwise it is drawn from
the ``torch.Generator`` the caller passes. Training (``q_sample`` and the
loss) waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from prodiff_tpu.ops.schedules import DiffusionCoefficients


class GaussianDiffusion(nn.Module):
    def __init__(self, denoise_fn: nn.Module, out_dims: int, timesteps: int = 4,
                 schedule_type: str = "vpsde", max_beta: float = 0.02,
                 min_beta: float = 0.1, noise_init: str = "uniform",
                 num_features: int = 1):
        super().__init__()
        if noise_init not in ("uniform", "gaussian"):
            raise ValueError(f"noise_init must be uniform|gaussian, got {noise_init!r}")
        self.denoise_fn = denoise_fn
        self.out_dims, self.timesteps = out_dims, timesteps
        self.noise_init, self.num_features = noise_init, num_features
        coefs = DiffusionCoefficients(
            timesteps=timesteps, schedule_type=schedule_type,
            max_beta=max_beta, min_beta=min_beta,
        )
        for name in ("posterior_mean_coef1", "posterior_mean_coef2",
                     "posterior_log_variance_clipped"):
            self.register_buffer(name, torch.from_numpy(getattr(coefs, name)), persistent=False)

    def _denoise(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b, f, tt, m = x.shape
        flat = x.permute(0, 2, 1, 3).reshape(b, tt, f * m)
        out = self.denoise_fn(flat, t, cond)
        return out.reshape(b, tt, f, m).permute(0, 2, 1, 3)

    def q_posterior_sample(self, x_0: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor,
                           noise: torch.Tensor) -> torch.Tensor:
        """One posterior step; ``t`` [B] int, all tensors [B, F, T, M]."""
        def coef(a):
            return a[t][:, None, None, None]

        mean = coef(self.posterior_mean_coef1) * x_0 + coef(self.posterior_mean_coef2) * x_t
        nonzero = (t != 0).to(x_0.dtype)[:, None, None, None]
        return mean + nonzero * torch.exp(0.5 * coef(self.posterior_log_variance_clipped)) * noise

    @torch.no_grad()
    def infer(self, cond: torch.Tensor, infer_step: int = 4,
              init_noise: Optional[torch.Tensor] = None,
              step_noises: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """cond [B, T, H] -> sampled spec [B, F, T, M].

        ``init_noise`` [B, F, T, M] / ``step_noises`` [infer_step, B, F, T, M];
        whichever is missing is drawn from ``generator``."""
        b, t_mel = cond.shape[0], cond.shape[1]
        infer_step = max(1, min(int(infer_step), self.timesteps))
        shape = (b, self.num_features, t_mel, self.out_dims)
        kw = dict(generator=generator, device=cond.device, dtype=cond.dtype)
        if init_noise is not None:
            x = init_noise
        elif self.noise_init == "uniform":
            x = torch.rand(shape, **kw)
        else:
            x = torch.randn(shape, **kw)
        for i, t_i in enumerate(range(infer_step - 1, -1, -1)):
            t_b = torch.full((b,), t_i, dtype=torch.long, device=cond.device)
            noise = step_noises[i] if step_noises is not None else torch.randn(shape, **kw)
            x_0_pred = self._denoise(x, t_b, cond)
            x = self.q_posterior_sample(x_0_pred, x, t_b, noise)
        return x
