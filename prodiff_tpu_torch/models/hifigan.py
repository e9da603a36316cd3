"""HiFi-GAN generator with an optional NSF harmonic source (port of the linen
path of ``prodiff_tpu/models/hifigan.py:HifiGanGenerator``).

Differences from NSF-HiFiGAN (``models/nsf_hifigan.py``): f0 is
nearest-upsampled to the sample rate *before* the sine source, whose random
initial phase starts the phase sum once (Parallel WaveGAN's
``source.py``), the source and its noise convs exist only with
``use_pitch_embed``, and ``conv_pre`` reads 80 mels. Runs internally in
PyTorch's ``[B, C, T]`` conv layout; the call takes ``mel [B, T, M]`` and
returns ``wav [B, T*upp]``. State-dict names are the torch reference's
(``conv_pre``, ``ups.{i}``, ``noise_convs.{i}``, ``resblocks.{n}.convs1.{j}``
/ ``.convs.{j}``, ``m_source.l_linear``, ``conv_post``), weight norm folded.

The resblock stages route as NSF-HiFiGAN's (:class:`ResBlockStages`): on
the card each ResBlock1 stage is one ``resblock_stage`` call, a ResBlock2
stage its plain modules. ``tap_dtype=torch.bfloat16`` is
``PackedHifiGanRunner(fused_res_dtype=bfloat16)`` (``fused_res_dtype="auto"``
on the JAX accelerator): the stages that the JAX packed route runs on its
fused or streamed resblock kernel, by ``_packed_supported`` at this mel
length and then ``fused_stage_kinds``, take bf16 tap stacks; the others stay
float32. The packed lane layout itself is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.models.nsf_hifigan import (
    LRELU_SLOPE,
    RESBLOCKS,
    ResBlockStages,
    packed_trunk_supported,
)

Draws = Tuple[torch.Tensor, torch.Tensor]  # (initial phases [B, D], noise [B, T, D])


def mod1_cumsum(rad: torch.Tensor) -> torch.Tensor:
    """Cumulative phase mod 1 along axis 1 of ``rad [B, T, D]``. A float64
    sum reduced mod 1, which neither drifts nor loses precision over
    hundreds of thousands of samples; the JAX function gets there with
    float32 chunk sums and a mod-1 scan of their carries. The sum runs
    along the last axis, where a scan over a contiguous row is fastest."""
    phase = torch.cumsum(rad.double().transpose(1, 2).contiguous(), dim=-1)
    return torch.remainder(phase, 1.0).float().transpose(1, 2)


def source_draws(b: int, t: int, harmonic_num: int, generator: Optional[torch.Generator],
                 device=None) -> Draws:
    """The sine source's random draws for ``b`` sequences of ``t`` samples:
    uniform initial phases [B, D] and unit normal noise [B, T, D]."""
    dim = harmonic_num + 1
    return (torch.rand((b, dim), generator=generator, device=device),
            torch.randn((b, t, dim), generator=generator, device=device))


def sine_gen_samplewise(f0_up: torch.Tensor, sampling_rate: int, harmonic_num: int,
                        draws: Draws, sine_amp: float = 0.1, noise_std: float = 0.003,
                        voiced_threshold: float = 0.0) -> torch.Tensor:
    """Sample-rate sine source (``parallel_wavegan/models/source.py``):
    f0_up [B, T] already at the sample rate -> [B, T, H+1]. ``draws``
    (:func:`source_draws`) hold the initial phases, the fundamental's set to
    0 here, and the noise."""
    rand_ini, noise = draws
    dim = harmonic_num + 1
    harmonics = torch.arange(1, dim + 1, dtype=torch.float32, device=f0_up.device)
    rad = torch.remainder(f0_up[:, :, None] * harmonics / sampling_rate, 1.0)
    rand_ini = torch.cat([torch.zeros_like(rand_ini[:, :1]), rand_ini[:, 1:]], dim=1)
    rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
    sines = torch.sin(2 * np.pi * mod1_cumsum(rad)) * sine_amp
    uv = (f0_up > voiced_threshold).float()[:, :, None]
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    return sines * uv + noise_amp * noise


class SourceModuleHnNSF(nn.Module):
    def __init__(self, sampling_rate: int, harmonic_num: int = 8):
        super().__init__()
        self.sampling_rate, self.harmonic_num = sampling_rate, harmonic_num
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0_up: torch.Tensor, draws: Draws) -> torch.Tensor:
        """f0_up [B, T] at the sample rate -> merged source [B, T, 1]."""
        sines = sine_gen_samplewise(f0_up, self.sampling_rate, self.harmonic_num, draws)
        return torch.tanh(self.l_linear(sines))


class HifiGanGenerator(ResBlockStages):
    """The reference ``HifiGanGenerator``'s config fields; defaults are the
    JAX class's (a 128-channel start, so every stage is narrower than 128)."""

    def __init__(self, upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 128, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 use_pitch_embed: bool = False, audio_sample_rate: int = 22050,
                 num_mels: int = 80, tap_dtype: torch.dtype = torch.float32):
        super().__init__()
        self._init_stages(resblock, tap_dtype)
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_initial_channel = upsample_initial_channel
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.use_pitch_embed = use_pitch_embed
        self.upp = int(np.prod(self.upsample_rates))
        self.c_out = 1
        if use_pitch_embed:
            self.m_source = SourceModuleHnNSF(audio_sample_rate, harmonic_num=8)
            self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = RESBLOCKS[self.resblock]
        for i, (u, k) in enumerate(zip(self.upsample_rates, self.upsample_kernel_sizes)):
            c_prev = upsample_initial_channel // (2 ** i)
            c_cur = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(c_prev, c_cur, k, u, padding=(k - u) // 2))
            if use_pitch_embed:
                if i + 1 < len(self.upsample_rates):
                    s = int(np.prod(self.upsample_rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 2 * s, stride=s, padding=s // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, c_cur, 1))
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(block(c_cur, rk, rd))
        self.conv_post = nn.Conv1d(c_cur, self.c_out, 7, padding=3)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                nn.init.normal_(m.weight, 0.0, 0.01)

    @classmethod
    def from_config(cls, h: dict, tap_dtype: torch.dtype = torch.float32) -> "HifiGanGenerator":
        return cls(
            upsample_rates=h["upsample_rates"],
            upsample_kernel_sizes=h["upsample_kernel_sizes"],
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock=str(h["resblock"]),
            resblock_kernel_sizes=h["resblock_kernel_sizes"],
            resblock_dilation_sizes=h["resblock_dilation_sizes"],
            use_pitch_embed=h.get("use_pitch_embed", False),
            audio_sample_rate=h.get("audio_sample_rate", 22050),
            tap_dtype=tap_dtype,
        )

    def _packed_supported(self, t_mel: int) -> bool:
        """``prodiff_tpu/models/hifigan.py:HifiGanGenerator._packed_supported``."""
        return self.c_out == 1 and packed_trunk_supported(
            t_mel, rates=self.upsample_rates, ksizes=self.upsample_kernel_sizes,
            init_ch=self.upsample_initial_channel, resblock=self.resblock,
            res_ksizes=self.resblock_kernel_sizes, has_source=self.use_pitch_embed)

    def forward(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> torch.Tensor:
        """mel [B, T, M]; f0 [B, T] Hz at the frame rate -> wav [B, T*upp].

        The source runs where ``use_pitch_embed`` and ``f0`` is given; its
        random draws are ``draws`` (:func:`source_draws`'s shapes) or drawn
        from ``generator`` (default: seed 0 on f0's device)."""
        har = None
        if self.use_pitch_embed and f0 is not None:
            f0_up = torch.repeat_interleave(f0, self.upp, dim=1)  # nearest upsample
            if draws is None:
                if generator is None:
                    generator = torch.Generator(f0.device).manual_seed(0)
                draws = source_draws(f0_up.shape[0], f0_up.shape[1], self.m_source.harmonic_num,
                                     generator, f0.device)
            har = self.m_source(f0_up, draws).transpose(1, 2)  # [B, 1, T*upp]
        dtypes = self.stage_tap_dtypes(mel.shape[1])
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if har is not None:
                x = x + self.noise_convs[i](har)
            x = self.stage(i, x, dtypes)
        x = self.conv_post(F.leaky_relu(x))  # torch default slope 0.01 here
        return torch.tanh(x)[:, 0]
