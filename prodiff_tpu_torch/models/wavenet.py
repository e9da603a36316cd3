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

``dtype`` is flax's ``dtype=`` of the JAX module (the teacher's bf16
policy): the linen route casts every conv's operands to it and carries the
residual and skip sums in it, the diffusion projection and the step MLP stay
float32, and the output is cast to float32. On the kernels the projections
around the stack take ``dtype`` the same way, and the stack's products take
the operand dtype of ``device.kernel_operand_dtype``: the module's dtype in
training, ``stream_dtype`` (``pallas_wavenet_dtype``) at inference in
``fast`` mode, as the JAX kernel route streams bf16 weights; its residual
and skip carries stay float32 there, as in the Pallas kernels.

State-dict names follow the torch reference (``input_projection``,
``mlp.0``/``mlp.2``, ``residual_layers.{i}.dilated_conv`` ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.models.common import Linear, SinusoidalPosEmb, cast, mish, params_key, widen
from prodiff_tpu_torch.ops.wavenet_stack import StackedWaveNet, cast_stack
from prodiff_tpu_torch.ops.wavenet_train import differentiable_stack


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def conv1x1(x: torch.Tensor, conv: nn.Conv1d, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A kernel-size-1 ``Conv1d`` applied to ``[B, T, C]``, its operands in
    ``dtype`` (None: as they are)."""
    return F.linear(*cast(dtype, x, conv.weight[:, :, 0], conv.bias))


def _conv(cin: int, cout: int, k: int = 1, dilation: int = 1) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation)
    nn.init.kaiming_normal_(conv.weight)
    return conv


def on_kernels(x: torch.Tensor, dilation_cycle_length: int) -> bool:
    """The card route: the stack runs on the kernels for CUDA tensors where
    every dilation is 1 (the linen loop otherwise)."""
    return x.is_cuda and dilation_cycle_length == 1


class ResidualBlock(nn.Module):
    def __init__(self, hidden_size: int, residual_channels: int, dilation: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = residual_channels
        self.dtype = dtype
        self.dilated_conv = _conv(c, 2 * c, 3, dilation)
        self.diffusion_projection = Linear(c, c)
        self.conditioner_projection = _conv(hidden_size, 2 * c)
        self.output_projection = _conv(c, 2 * c)

    def forward(self, x, cond, step):
        """x [B,T,C], cond [B,T,H], step [B,C] -> (residual out, skip)."""
        c = x.shape[-1]
        conv = self.dilated_conv
        y = x + self.diffusion_projection(step)[:, None, :]
        y, w, b = cast(self.dtype, y, conv.weight, conv.bias)
        y = F.conv1d(y.transpose(1, 2), w, b, padding=conv.padding,
                     dilation=conv.dilation).transpose(1, 2)
        y = y + conv1x1(cond, self.conditioner_projection, self.dtype)
        y = torch.sigmoid(y[..., :c]) * torch.tanh(y[..., c:])
        y = conv1x1(y, self.output_projection, self.dtype)
        return (x + y[..., :c]) * (2.0 ** -0.5), y[..., c:]


class WaveNet(nn.Module):
    """spec [B, T, in_dims], t [B], cond [B, T, H] -> [B, T, in_dims] float32.

    ``dtype``: the compute dtype (flax's, None = float32); ``stream_dtype``:
    the weight stream of the kernel route at inference in ``fast`` mode
    (``pallas_wavenet_dtype``, bfloat16 as the JAX module's default)."""

    def __init__(self, in_dims: int, hidden_size: int, residual_layers: int = 20,
                 residual_channels: int = 256, dilation_cycle_length: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 stream_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = residual_channels
        self.dilation_cycle_length = dilation_cycle_length
        self.dtype, self.stream_dtype = dtype, stream_dtype
        self.input_projection = _conv(in_dims, c)
        self.diffusion_embedding = SinusoidalPosEmb(c)
        self.mlp = nn.Sequential(Linear(c, 4 * c), Mish(), Linear(4 * c, c))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(hidden_size, c, 2 ** (i % dilation_cycle_length), dtype)
            for i in range(residual_layers)
        )
        self.skip_projection = _conv(c, c)
        self.output_projection = _conv(c, in_dims)
        nn.init.zeros_(self.output_projection.weight)
        self._stacked = None

    def _trains(self) -> bool:
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.residual_layers.parameters())

    def stacked_weights(self, dtype: torch.dtype = torch.float32) -> StackedWaveNet:
        """The residual layers' weights stacked for the kernels (counterpart
        of ``stack_wavenet_params(stream_dtype=dtype)``: the four weight
        matrices in ``dtype``, the biases float32). With grad mode on and
        trainable parameters the stack is built anew, float32 and
        differentiable (the kernels' Function casts it, so the gradients
        reach the parameters in float32); otherwise it is cached, one cast
        a dtype, and rebuilt when a parameter changes."""
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

        if self._trains():
            return build()
        key = params_key(self)
        if self._stacked is None or self._stacked[0] != key:
            self._stacked = (key, {})
        cache = self._stacked[1]
        if dtype not in cache:
            with torch.no_grad():
                base = cache[torch.float32] if torch.float32 in cache else build()
                cache[dtype] = cast_stack(base, dtype)
        return cache[dtype]

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(conv1x1(spec, self.input_projection, dt))
        step = self.mlp(self.diffusion_embedding(diffusion_step))
        if on_kernels(spec, self.dilation_cycle_length):
            train = self._trains()
            op = device.kernel_operand_dtype(dt, self.stream_dtype, train)
            w = self.stacked_weights(torch.float32 if train else op)
            x = differentiable_stack(widen(x), cond, step, w, op)
        else:
            skip_sum = torch.zeros_like(x)
            for layer in self.residual_layers:
                x, skip = layer(x, cond, step)
                skip_sum = skip_sum + skip
            x = skip_sum * (1.0 / math.sqrt(len(self.residual_layers)))
        x = F.relu(conv1x1(x, self.skip_projection, dt))
        return widen(conv1x1(x, self.output_projection, dt))
