"""Parallel WaveGAN generator (port of ``prodiff_tpu/models/pwg.py``): a
WaveNet over a noise signal, conditioned on the mel upsampled to the sample
rate (a context conv, then per scale a nearest stretch and a ``2s + 1``-tap
smoothing conv), with an optional coarse-pitch embedding. Inference only.

Runs in PyTorch's ``[B, C, T]`` layout; the call takes ``z [B, T, 1]``,
``c [B, T' + 2 window, A]`` and returns ``wav [B, T]`` like the JAX module.
State-dict names are the reference's (kan-bayashi ``parallel_wavegan``:
``first_conv``, ``conv_layers.{i}.{conv,conv1x1_aux,conv1x1_skip,conv1x1_out}``,
``upsample_net.conv_in``, ``upsample_net.upsample.up_layers.{2i+1}``,
``last_conv_layers.{1,3}``, ``pitch_embed``, ``c_proj``), weight norm folded.
There is no Pallas kernel for it in the JAX package; its convs run in cuDNN.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import Embedding


class PWGResidualBlock(nn.Module):
    def __init__(self, kernel_size: int, residual_channels: int, gate_channels: int,
                 skip_channels: int, aux_channels: int, dilation: int):
        super().__init__()
        self.conv = nn.Conv1d(residual_channels, gate_channels, kernel_size,
                              padding=(kernel_size - 1) // 2 * dilation, dilation=dilation)
        self.conv1x1_aux = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(gate_channels // 2, residual_channels, 1)
        self.conv1x1_skip = nn.Conv1d(gate_channels // 2, skip_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor):
        """x [B, R, T]; c [B, A, T] -> (residual out, skip)."""
        xa, xb = self.conv(x).chunk(2, dim=1)
        ca, cb = self.conv1x1_aux(c).chunk(2, dim=1)
        h = torch.tanh(xa + ca) * torch.sigmoid(xb + cb)
        return (self.conv1x1_out(h) + x) * (2.0 ** -0.5), self.conv1x1_skip(h)


class Stretch2d(nn.Module):
    """Nearest stretch of the time axis (the last) by ``scale``."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.repeat_interleave(x, self.scale, dim=-1)


class UpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Sequence[int]):
        super().__init__()
        self.up_layers = nn.ModuleList()
        for scale in upsample_scales:
            conv = nn.Conv2d(1, 1, (1, 2 * scale + 1), padding=(0, scale), bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * scale + 1))
            self.up_layers.extend([Stretch2d(scale), conv])

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c [B, C, T] -> [B, C, T * prod(scales)]: (freq, time) planes of one channel."""
        x = c[:, None]
        for layer in self.up_layers:
            x = layer(x)
        return x[:, 0]


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Sequence[int], aux_channels: int = 80,
                 aux_context_window: int = 2):
        super().__init__()
        self.conv_in = nn.Conv1d(aux_channels, aux_channels, 2 * aux_context_window + 1,
                                 bias=False)
        self.upsample = UpsampleNetwork(upsample_scales)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c [B, A, T + 2 window] (edge-padded by the caller) -> [B, A, T * prod(scales)]."""
        return self.upsample(self.conv_in(c))


class ParallelWaveGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1, kernel_size: int = 3,
                 layers: int = 30, stacks: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64, aux_channels: int = 80,
                 aux_context_window: int = 2, upsample_scales: Sequence[int] = (4, 4, 4, 4),
                 use_pitch_embed: bool = False):
        super().__init__()
        self.layers, self.use_pitch_embed = layers, use_pitch_embed
        self.aux_context_window = aux_context_window
        self.upsample_scales = tuple(upsample_scales)
        self.first_conv = nn.Conv1d(in_channels, residual_channels, 1)
        self.upsample_net = ConvInUpsampleNetwork(upsample_scales, aux_channels,
                                                  aux_context_window)
        per_stack = layers // stacks
        self.conv_layers = nn.ModuleList(
            PWGResidualBlock(kernel_size, residual_channels, gate_channels, skip_channels,
                             aux_channels, 2 ** (i % per_stack))
            for i in range(layers))
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(skip_channels, skip_channels, 1),
            nn.ReLU(), nn.Conv1d(skip_channels, out_channels, 1)])
        if use_pitch_embed:
            self.pitch_embed = Embedding(300, aux_channels, padding_idx=0)
            self.c_proj = nn.Linear(2 * aux_channels, aux_channels)

    @classmethod
    def from_config(cls, config: dict) -> "ParallelWaveGANGenerator":
        """The ``generator_params`` of a Parallel WaveGAN ``config.yaml``,
        read with the JAX vocoder's defaults (``prodiff_tpu/vocoders/hifigan.py:189-200``)."""
        gp = config["generator_params"]
        return cls(
            layers=gp.get("layers", 30), stacks=gp.get("stacks", 3),
            residual_channels=gp.get("residual_channels", 64),
            gate_channels=gp.get("gate_channels", 128),
            skip_channels=gp.get("skip_channels", 64),
            aux_channels=gp.get("aux_channels", 80),
            aux_context_window=gp.get("aux_context_window", 2),
            upsample_scales=tuple(gp["upsample_params"]["upsample_scales"]),
            use_pitch_embed=gp.get("use_pitch_embed", False),
            kernel_size=gp.get("kernel_size", 3),
        )

    def forward(self, z: torch.Tensor, c: torch.Tensor,
                pitch: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, T, 1] noise; c [B, T' + 2 window, A] edge-padded mel;
        pitch [B, T' + 2 window] coarse ids -> wav [B, T]."""
        if self.use_pitch_embed and pitch is not None:
            c = self.c_proj(torch.cat([c, self.pitch_embed(pitch)], dim=-1))
        c = self.upsample_net(c.transpose(1, 2))
        if c.shape[-1] != z.shape[1]:
            raise ValueError(f"ParallelWaveGAN: the conditioning has {c.shape[-1]} samples, "
                             f"the noise {z.shape[1]}")
        x = self.first_conv(z.transpose(1, 2))
        skips = 0.0
        for layer in self.conv_layers:
            x, s = layer(x, c)
            skips = skips + s
        x = skips * math.sqrt(1.0 / self.layers)
        for layer in self.last_conv_layers:
            x = layer(x)
        return x[:, 0]
