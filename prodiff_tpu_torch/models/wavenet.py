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

A third, with ``tp`` (a ``parallel.megatron.TensorParallel``, the JAX
module's ``tp_axis``/``tp_size``), takes precedence over both, as the JAX TP
route does: each residual layer holds its rank's slice of the channels and
the stack runs ``parallel/tp_wavenet.py:wavenet_apply_tp`` in float32, the
projections around it too, whatever ``dtype`` is.

``dtype`` is flax's ``dtype=`` of the JAX module (the teacher's bf16
policy): the linen route casts every conv's operands to it, rounds where
the JAX module rounds (``models/common.py``), carries the residual and
skip sums in it, the diffusion projection and the step MLP stay
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
from prodiff_tpu_torch.models.common import (
    Linear,
    SinusoidalPosEmb,
    conv1d,
    linear,
    mish,
    params_key,
    sigmoid,
    tanh,
    weak,
    widen,
)
from prodiff_tpu_torch.ops.wavenet_stack import StackedWaveNet, cast_stack
from prodiff_tpu_torch.ops.wavenet_train import differentiable_stack
from prodiff_tpu_torch.parallel.halo import halo_width, on_window
from prodiff_tpu_torch.parallel.tp_wavenet import wavenet_apply_tp


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def conv1x1(x: torch.Tensor, conv: nn.Conv1d, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A kernel-size-1 ``Conv1d`` applied to ``[B, T, C]``, its operands in
    ``dtype`` (None: as they are; a bf16 product rounded before its bias is
    added, as ``common.linear``)."""
    return linear(x, conv.weight[:, :, 0], conv.bias, dtype)


def _conv(cin: int, cout: int, k: int = 1, dilation: int = 1) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, k, padding=dilation * (k - 1) // 2, dilation=dilation)
    nn.init.kaiming_normal_(conv.weight)
    return conv


def on_kernels(x: torch.Tensor, dilation_cycle_length: int) -> bool:
    """The card route: the stack runs on the kernels for CUDA tensors where
    every dilation is 1 (the linen loop otherwise)."""
    return x.is_cuda and dilation_cycle_length == 1


class ResidualBlock(nn.Module):
    """One residual layer; with ``tp`` its rank's slices: the rows
    ``[g_i; f_i]`` of the dilated conv and the conditioner projection, the
    input channels ``i`` of the output projection."""

    TP_KINDS = {"dilated_conv.weight": "gate", "dilated_conv.bias": "gate",
                "conditioner_projection.weight": "gate", "conditioner_projection.bias": "gate",
                "output_projection.weight": "in"}

    def __init__(self, hidden_size: int, residual_channels: int, dilation: int,
                 dtype: Optional[torch.dtype] = None, tp=None):
        super().__init__()
        c = residual_channels
        s = c if tp is None else tp.split(c)
        self.dtype = dtype
        if tp is not None:
            self.tp_kinds = self.TP_KINDS
        self.dilated_conv = _conv(c, 2 * s, 3, dilation)
        self.diffusion_projection = Linear(c, c)
        self.conditioner_projection = _conv(hidden_size, 2 * s)
        self.output_projection = _conv(s, 2 * c)

    def forward(self, x, cond, step):
        """x [B,T,C], cond [B,T,H], step [B,C] -> (residual out, skip)."""
        c = x.shape[-1]
        y = x + self.diffusion_projection(step)[:, None, :]
        y = conv1d(y, self.dilated_conv, self.dtype)
        y = y + conv1x1(cond, self.conditioner_projection, self.dtype)
        y = sigmoid(y[..., :c]) * tanh(y[..., c:])
        y = conv1x1(y, self.output_projection, self.dtype)
        x = x + y[..., :c]
        return x * weak(2.0 ** -0.5, x), y[..., c:]


class WaveNet(nn.Module):
    """spec [B, T, in_dims], t [B], cond [B, T, H] -> [B, T, in_dims] float32.

    ``dtype``: the compute dtype (flax's, None = float32); ``stream_dtype``:
    the weight stream of the kernel route at inference in ``fast`` mode
    (``pallas_wavenet_dtype``, bfloat16 as the JAX module's default);
    ``tp``: the model axis of the tensor-parallel route; ``sp``: the
    process group of the sequence-parallel one (spec and cond are then this
    rank's block of frames, and so is the output)."""

    def __init__(self, in_dims: int, hidden_size: int, residual_layers: int = 20,
                 residual_channels: int = 256, dilation_cycle_length: int = 1,
                 dtype: Optional[torch.dtype] = None,
                 stream_dtype: torch.dtype = torch.bfloat16, tp=None, sp=None):
        super().__init__()
        c = residual_channels
        if tp is not None and tp.size > 1 and dilation_cycle_length != 1:
            # the JAX module's words (prodiff_tpu/models/wavenet.py:100-112)
            raise ValueError(
                "model_parallel > 1 requires dilation_cycle_length == 1 "
                f"(got {dilation_cycle_length}); the TP denoiser stacks "
                "per-layer params and needs uniform dilation"
            )
        self.dilation_cycle_length = dilation_cycle_length
        self.dtype, self.stream_dtype, self.tp, self.sp = dtype, stream_dtype, tp, sp
        self.input_projection = _conv(in_dims, c)
        self.diffusion_embedding = SinusoidalPosEmb(c)
        self.mlp = nn.Sequential(Linear(c, 4 * c), Mish(), Linear(4 * c, c))
        self.residual_layers = nn.ModuleList(
            ResidualBlock(hidden_size, c, 2 ** (i % dilation_cycle_length), dtype, tp)
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
        if self.tp is not None:
            x = F.relu(conv1x1(widen(spec), self.input_projection))
            step = self.mlp(self.diffusion_embedding(diffusion_step))
            x = wavenet_apply_tp(self.stacked_weights(), x, widen(cond), step, self.tp)
            x = F.relu(conv1x1(x, self.skip_projection))
            return conv1x1(x, self.output_projection)
        if self.sp is not None:
            h = halo_width(len(self.residual_layers), self.dilation_cycle_length)
            return on_window(lambda s, c: self._denoise(s, diffusion_step, c), self.sp, h,
                             spec, cond)
        return self._denoise(spec, diffusion_step, cond)

    def _denoise(self, spec: torch.Tensor, diffusion_step: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
        """The kernel route or the module loop on the frames given."""
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
            x = skip_sum * weak(1.0 / math.sqrt(len(self.residual_layers)), skip_sum)
        x = F.relu(conv1x1(x, self.skip_projection, dt))
        return widen(conv1x1(x, self.output_projection, dt))
