"""Rectified flow: velocity-field flow matching with ODE samplers (port of
``prodiff_tpu/models/reflow.py:RectifiedFlow``).

Sampling integrates the learned velocity from the start point x0 ~ N(0, 1)
to t = 1 with the euler, rk2, rk4 or rk5 stepper (an unknown name falls back to euler, as in
the JAX module). Specs are min-max normalised to [-1, 1]. Training
(:meth:`RectifiedFlow.forward`) predicts the velocity at x_t = x0 + t (x1 -
x0), x1 the normalised target, x0 ~ N(0, 1), t ~ U(0, 1); the loss lives in
``ops/losses.py:spec_loss_reflow``. Tensors are ``[B, F, T, M]``; the
denoiser sees ``[B, T, F*M]``.

Curve mode (``repeat_bins``, the pitch predictor's): a 1-D curve ``[B, F,
T]`` is clamped to ``[clamp_min, clamp_max]``, repeated to ``repeat_bins``
and normalised by per-feature bounds; a sample is mean-decoded and clamped
again. The start point is ``init_noise`` when given, else drawn from the
caller's ``torch.Generator``; so are a training call's t and x0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from prodiff_tpu_torch.parallel.mesh import draw_rows


class RectifiedFlow(nn.Module):
    def __init__(self, denoise_fn: nn.Module, out_dims: int, time_scale: float = 1000,
                 num_features: int = 1, sampling_algorithm: str = "euler",
                 spec_min: Sequence[float] = (-12.0,), spec_max: Sequence[float] = (0.0,),
                 repeat_bins: Optional[int] = None, clamp_min: Optional[float] = None,
                 clamp_max: Optional[float] = None):
        super().__init__()
        self.denoise_fn = denoise_fn
        self.out_dims, self.time_scale, self.num_features = out_dims, time_scale, num_features
        self.sampling_algorithm = sampling_algorithm
        self.repeat_bins = repeat_bins
        self.clamp = None if clamp_min is None or clamp_max is None else (clamp_min, clamp_max)
        smin = torch.tensor(list(spec_min), dtype=torch.float32)
        smax = torch.tensor(list(spec_max), dtype=torch.float32)
        # per-feature scalars [1, F, 1, 1] in curve mode, else per mel bin [1, 1, 1, M]
        view = (1, -1, 1, 1) if repeat_bins is not None else (1, 1, 1, -1)
        self.register_buffer("spec_min", smin.view(view), persistent=False)
        self.register_buffer("spec_max", smax.view(view), persistent=False)

    def norm_spec(self, x: torch.Tensor) -> torch.Tensor:
        if self.repeat_bins is not None:
            if self.clamp is not None:
                x = x.clamp(*self.clamp)
            x = x[..., None].expand(*x.shape, self.repeat_bins)  # [B, F, T, R]
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2 - 1

    def denorm_spec(self, x: torch.Tensor) -> torch.Tensor:
        x = (x + 1) / 2 * (self.spec_max - self.spec_min) + self.spec_min
        if self.repeat_bins is not None:
            x = x.mean(dim=-1)  # [B, F, T]
            if self.clamp is not None:
                x = x.clamp(*self.clamp)
        return x

    def _velocity(self, x: torch.Tensor, t_scaled: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b, f, tt, m = x.shape
        flat = x.permute(0, 2, 1, 3).reshape(b, tt, f * m)
        out = self.denoise_fn(flat, t_scaled, cond)
        return out.reshape(b, tt, f, m).permute(0, 2, 1, 3)

    def forward(self, cond: torch.Tensor, gt_spec: torch.Tensor, t: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Training: cond [B, T, H], gt_spec [B, F, T, M] (``[B, F, T]`` in
        curve mode) -> (v_pred, v_gt, t): the predicted and the true
        velocity, both [B, F, T, M or R], and t [B]. ``t`` (float in [0, 1])
        and ``noise`` (the start point x0, the normalised target's shape)
        are drawn from ``generator`` where not given."""
        x_end = self.norm_spec(gt_spec)
        if t is None:
            t = draw_rows(lambda s: torch.rand(s, generator=generator, device=x_end.device),
                          x_end.shape[:1])
        if noise is None:
            noise = draw_rows(lambda s: torch.randn(s, generator=generator, device=x_end.device,
                                                    dtype=x_end.dtype), x_end.shape)
        x_t = noise + t[:, None, None, None] * (x_end - noise)
        v_pred = self._velocity(x_t, t * self.time_scale, cond)
        return v_pred, x_end - noise, t

    @torch.no_grad()
    def infer(self, cond: torch.Tensor, infer_step: int = 20,
              init_noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """cond [B, T, H] -> the denormalised sample, [B, F, T, M] (``[B, F,
        T]`` in curve mode), integrated over ``infer_step`` steps from
        ``init_noise`` [B, F, T, M or R] (else a draw from ``generator``)."""
        b, t_mel = cond.shape[0], cond.shape[1]
        if init_noise is not None:
            x = init_noise
        else:
            shape = (b, self.num_features, t_mel,
                     self.out_dims if self.repeat_bins is None else self.repeat_bins)
            x = torch.randn(shape, generator=generator, device=cond.device, dtype=cond.dtype)
        n = max(1, int(infer_step))
        dt = 1.0 / n
        scale = np.float32(self.time_scale)

        def velocity(x, t):  # t: a float32 time in [0, 1], as the JAX scan carries it
            return self._velocity(x, torch.full((b,), float(np.float32(t) * scale),
                                                device=cond.device), cond)

        def half(t, frac):
            return np.float32(t) + np.float32(frac * dt)

        def euler(x, t):
            return x + velocity(x, t) * dt

        def rk2(x, t):
            k1 = velocity(x, t)
            k2 = velocity(x + 0.5 * k1 * dt, half(t, 0.5))
            return x + k2 * dt

        def rk4(x, t):
            k1 = velocity(x, t)
            k2 = velocity(x + 0.5 * k1 * dt, half(t, 0.5))
            k3 = velocity(x + 0.5 * k2 * dt, half(t, 0.5))
            k4 = velocity(x + k3 * dt, half(t, 1.0))
            return x + (k1 + 2 * k2 + 2 * k3 + k4) * dt / 6

        def rk5(x, t):
            k1 = velocity(x, t)
            k2 = velocity(x + 0.25 * k1 * dt, half(t, 0.25))
            k3 = velocity(x + 0.125 * (k2 + k1) * dt, half(t, 0.25))
            k4 = velocity(x + 0.5 * (-k2 + 2 * k3) * dt, half(t, 0.5))
            k5 = velocity(x + 0.0625 * (3 * k1 + 9 * k4) * dt, half(t, 0.75))
            k6 = velocity(x + (-3 * k1 + 2 * k2 + 12 * k3 - 12 * k4 + 8 * k5) * dt / 7,
                          half(t, 1.0))
            return x + (7 * k1 + 32 * k3 + 12 * k4 + 32 * k5 + 7 * k6) * dt / 90

        stepper = {"euler": euler, "rk2": rk2, "rk4": rk4, "rk5": rk5}.get(
            self.sampling_algorithm, euler)
        for t in np.arange(n, dtype=np.float32) * np.float32(dt):
            x = stepper(x, t)
        return self.denorm_spec(x)
