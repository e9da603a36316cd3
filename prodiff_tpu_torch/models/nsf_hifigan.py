"""NSF-HiFiGAN generator (port of the linen path of
``prodiff_tpu/models/nsf_hifigan.py:Generator``).

Runs internally in PyTorch's ``[B, C, T]`` conv layout; the public call takes
``mel [B, T, M]`` and returns ``wav [B, T*upp]`` like the JAX module.
State-dict names follow the torch reference (``conv_pre``, ``ups.{i}``,
``noise_convs.{i}``, ``resblocks.{n}.convs1.{j}``, ``m_source.l_linear``,
``conv_post``), with weight norm already folded.

Each upsample stage ends in the mean of its ResBlock1s. For CUDA tensors
that mean runs as one ``resblock_stage`` kernel call (port of the Pallas K2/K3);
on the CPU it is the plain module loop.
The TPU lane-layout machinery of the JAX module (the packed trunk and its
runner) is not ported: this computes the function it computes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.models.common import params_key
from prodiff_tpu_torch.ops.resblock import LRELU_SLOPE, get_padding, resblock_stage


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=get_padding(kernel_size, d))
            for d in dilation
        )
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1))
            for _ in dilation
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]."""
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


def sine_source(f0: torch.Tensor, upp: int, sampling_rate: int, harmonic_num: int,
                generator: Optional[torch.Generator] = None, sine_amp: float = 0.1,
                noise_std: float = 0.003, voiced_threshold: float = 0.0) -> torch.Tensor:
    """Harmonic sine source at sample rate: f0 [B, T_frames] Hz ->
    [B, T_frames*upp, harmonic_num+1] (``sine_gen``/``_sine_planar``).

    The per-sample phase in frame f is ``base_f + (i+1) * rad_f`` where
    ``base_f`` is the frame-start phase mod 1. The JAX module carries it
    through a float32 scan; here it is a float64 cumsum of the per-frame
    increments reduced mod 1, which neither drifts nor loses precision.
    ``generator=None`` renders deterministically: zero initial overtone phases
    and no additive noise."""
    b, t_frames = f0.shape
    dim = harmonic_num + 1
    harmonics = torch.arange(1, dim + 1, dtype=torch.float32, device=f0.device)
    rad = torch.remainder(f0[:, :, None] * harmonics / sampling_rate, 1.0)  # [B, T_f, D]
    if generator is not None:
        rand_ini = torch.rand((1, dim), generator=generator, device=f0.device)
        rand_ini[:, 0] = 0.0
        rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
    frame_inc = torch.remainder(rad * upp, 1.0).double()
    base = torch.remainder(torch.cumsum(frame_inc, dim=1) - frame_inc, 1.0).float()
    within = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    phase = base[..., None] + within * rad[..., None]  # [B, T_f, D, upp]
    sines = torch.sin(2 * np.pi * phase).permute(0, 1, 3, 2).reshape(b, t_frames * upp, dim)
    uv = torch.repeat_interleave((f0 > voiced_threshold).float()[:, :, None], upp, dim=1)
    if generator is None:
        return sines * sine_amp * uv
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    noise = torch.randn(sines.shape, generator=generator, device=f0.device)
    return sines * sine_amp * uv + noise_amp * noise


class SourceModuleHnNSF(nn.Module):
    def __init__(self, sampling_rate: int, harmonic_num: int = 8):
        super().__init__()
        self.sampling_rate, self.harmonic_num = sampling_rate, harmonic_num
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, upp: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """f0 [B, T_frames] -> merged source [B, T_frames*upp, 1]."""
        sines = sine_source(f0, upp, self.sampling_rate, self.harmonic_num, generator)
        return torch.tanh(self.l_linear(sines))


class Generator(nn.Module):
    """``h``-style constructor arguments: the openvpi NSF-HiFiGAN config.json
    fields (defaults = the 44.1 kHz, 128-mel release)."""

    def __init__(self, num_mels: int = 128, sampling_rate: int = 44100,
                 upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
                 resblock: str = "1", resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3):
        super().__init__()
        if str(resblock) != "1":
            raise NotImplementedError("ResBlock2 generators land with the other-vocoders slice")
        self.upsample_rates = tuple(upsample_rates)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upp = int(np.prod(self.upsample_rates))
        self.m_source = SourceModuleHnNSF(sampling_rate, harmonic_num=8)
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(self.upsample_rates, upsample_kernel_sizes)):
            c_prev = upsample_initial_channel // (2 ** i)
            c_cur = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(c_prev, c_cur, k, u, padding=(k - u) // 2))
            if i + 1 < len(self.upsample_rates):
                s = int(np.prod(self.upsample_rates[i + 1:]))
                self.noise_convs.append(nn.Conv1d(1, c_cur, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(c_cur, rk, rd))
        self.conv_post = nn.Conv1d(c_cur, 1, 7, padding=3)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                nn.init.normal_(m.weight, 0.0, 0.01)
        self._stages = None

    @classmethod
    def from_config(cls, h: dict) -> "Generator":
        return cls(
            num_mels=h["num_mels"], sampling_rate=h["sampling_rate"],
            upsample_initial_channel=h["upsample_initial_channel"],
            upsample_rates=h["upsample_rates"],
            upsample_kernel_sizes=h["upsample_kernel_sizes"],
            resblock=str(h["resblock"]),
            resblock_kernel_sizes=h["resblock_kernel_sizes"],
            resblock_dilation_sizes=h["resblock_dilation_sizes"],
        )

    def stage_weights(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """Per stage, its convs flattened for ``resblock_stage``: weights (each
        conv ``[k, C_in, C_out]``, in resblock/unit/conv1-conv2 order) and
        biases ``[n_convs, C]``; rebuilt when a parameter changes."""
        key = params_key(self)
        if self._stages is None or self._stages[0] != key:
            n = len(self.resblock_kernel_sizes)
            stages = []
            with torch.no_grad():
                for i in range(len(self.ups)):
                    ws, bs = [], []
                    for rb in self.resblocks[i * n: (i + 1) * n]:
                        for c1, c2 in zip(rb.convs1, rb.convs2):
                            for conv in (c1, c2):
                                ws.append(conv.weight.permute(2, 1, 0).reshape(-1))
                                bs.append(conv.bias)
                    stages.append((torch.cat(ws).contiguous(), torch.stack(bs).contiguous()))
            self._stages = (key, tuple(stages))
        return self._stages[1]

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel [B, T, M] natural-log; f0 [B, T] Hz -> wav [B, T*upp].

        ``generator=None`` renders deterministically (zero-phase, noise-free
        sine source)."""
        har_source = self.m_source(f0, self.upp, generator).transpose(1, 2)  # [B, 1, T*upp]
        n = len(self.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(F.leaky_relu(x, LRELU_SLOPE)) + noise_conv(har_source)
            if x.is_cuda:
                w, b = self.stage_weights()[i]
                x = resblock_stage(
                    x.transpose(1, 2), w, b,
                    self.resblock_kernel_sizes, self.resblock_dilation_sizes,
                ).transpose(1, 2)
            else:
                xs = 0.0
                for rb in self.resblocks[i * n: (i + 1) * n]:
                    xs = xs + rb(x)
                x = xs / n
        x = self.conv_post(F.leaky_relu(x))  # torch default slope 0.01 here
        return torch.tanh(x)[:, 0]

