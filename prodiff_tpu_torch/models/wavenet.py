"""WaveNet diffusion denoiser (port of ``prodiff_tpu/models/wavenet.py``).

Non-causal gated dilated-conv stack on ``[B, T, C]``. Two routes compute the
same function:

- the plain module loop (the JAX linen path), used on the CPU and whenever
  ``dilation_cycle_length != 1``;
- the kernels (CUDA tensors, every layer of dilation 1, where the JAX
  package routes to Pallas): ``ops/wavenet_train.py:differentiable_stack``,
  which runs K1 (``ops/wavenet_stack.py``) when no gradient is needed and
  otherwise the trainable stack (K5's save-forward and backward chain), so
  a backward pass reaches every parameter and ``cond``.

State-dict names follow the torch reference (``input_projection``,
``mlp.0``/``mlp.2``, ``residual_layers.{i}.dilated_conv`` ...).
"""

from __future__ import annotations

import math
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.models.common import Linear, SinusoidalPosEmb, mish, params_key
from prodiff_tpu_torch.ops.wavenet_stack import StackedWaveNet
from prodiff_tpu_torch.ops.wavenet_train import differentiable_stack


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def conv1x1(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """A kernel-size-1 ``Conv1d`` applied to ``[B, T, C]``."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def _conv(cin: int, cout: int, k: int = 1, dilation: int = 1) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation)
    nn.init.kaiming_normal_(conv.weight)
    return conv


class ResidualBlock(nn.Module):
    def __init__(self, hidden_size: int, residual_channels: int, dilation: int):
        super().__init__()
        c = residual_channels
        self.dilated_conv = _conv(c, 2 * c, 3, dilation)
        self.diffusion_projection = Linear(c, c)
        self.conditioner_projection = _conv(hidden_size, 2 * c)
        self.output_projection = _conv(c, 2 * c)

    def forward(self, x, cond, step):
        """x [B,T,C], cond [B,T,H], step [B,C] -> (residual out, skip)."""
        c = x.shape[-1]
        y = x + self.diffusion_projection(step)[:, None, :]
        y = self.dilated_conv(y.transpose(1, 2)).transpose(1, 2)
        y = y + conv1x1(cond, self.conditioner_projection)
        y = torch.sigmoid(y[..., :c]) * torch.tanh(y[..., c:])
        y = conv1x1(y, self.output_projection)
        return (x + y[..., :c]) * (2.0 ** -0.5), y[..., c:]


class WaveNet(nn.Module):
    """spec [B, T, in_dims], t [B], cond [B, T, H] -> [B, T, in_dims]."""

    def __init__(self, in_dims: int, hidden_size: int, residual_layers: int = 20,
                 residual_channels: int = 256, dilation_cycle_length: int = 1):
        super().__init__()
        c = residual_channels
        self.dilation_cycle_length = dilation_cycle_length
        self.input_projection = _conv(in_dims, c)
        self.diffusion_embedding = SinusoidalPosEmb(c)
        self.mlp = nn.Sequential(Linear(c, 4 * c), Mish(), Linear(4 * c, c))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(hidden_size, c, 2 ** (i % dilation_cycle_length))
            for i in range(residual_layers)
        )
        self.skip_projection = _conv(c, c)
        self.output_projection = _conv(c, in_dims)
        nn.init.zeros_(self.output_projection.weight)
        self._stacked = None

    def stacked_weights(self) -> StackedWaveNet:
        """The residual layers' weights stacked for the kernels (counterpart
        of ``stack_wavenet_params``). With grad mode on and trainable
        parameters the stack is built anew and differentiable; otherwise it
        is cached and rebuilt when a parameter changes."""
        ls = self.residual_layers

        def build():
            def stack(fn):
                return torch.stack([fn(layer) for layer in ls]).contiguous()

            return StackedWaveNet(
                dilated_w=stack(lambda l: l.dilated_conv.weight.permute(2, 1, 0)),
                dilated_b=stack(lambda l: l.dilated_conv.bias),
                diff_w=stack(lambda l: l.diffusion_projection.weight.t()),
                diff_b=stack(lambda l: l.diffusion_projection.bias),
                cond_w=stack(lambda l: l.conditioner_projection.weight[:, :, 0].t()),
                cond_b=stack(lambda l: l.conditioner_projection.bias),
                out_w=stack(lambda l: l.output_projection.weight[:, :, 0].t()),
                out_b=stack(lambda l: l.output_projection.bias),
            )

        if torch.is_grad_enabled() and any(p.requires_grad for p in ls.parameters()):
            return build()
        key = params_key(self)
        if self._stacked is None or self._stacked[0] != key:
            with torch.no_grad():
                self._stacked = (key, build())
        return self._stacked[1]

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        x = F.relu(conv1x1(spec, self.input_projection))
        step = self.mlp(self.diffusion_embedding(diffusion_step))
        if spec.is_cuda and self.dilation_cycle_length == 1:
            x = differentiable_stack(x, cond, step, self.stacked_weights())
        else:
            skip_sum = torch.zeros_like(x)
            for layer in self.residual_layers:
                x, skip = layer(x, cond, step)
                skip_sum = skip_sum + skip
            x = skip_sum * (1.0 / math.sqrt(len(self.residual_layers)))
        x = F.relu(conv1x1(x, self.skip_projection))
        return conv1x1(x, self.output_projection)
