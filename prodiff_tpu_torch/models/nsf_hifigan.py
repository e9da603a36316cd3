"""NSF-HiFiGAN generator (port of the linen path of
``prodiff_tpu/models/nsf_hifigan.py:Generator``).

Runs internally in PyTorch's ``[B, C, T]`` conv layout; the public call takes
``mel [B, T, M]`` and returns ``wav [B, T*upp]`` like the JAX module.
State-dict names follow the torch reference (``conv_pre``, ``ups.{i}``,
``noise_convs.{i}``, ``resblocks.{n}.convs1.{j}``, ``m_source.l_linear``,
``conv_post``), with weight norm already folded.

Each upsample stage ends in the mean of its ResBlock1s (or ResBlock2s).
For CUDA tensors a ResBlock1 stage runs as one ``resblock_stage`` kernel call
(port of the Pallas K2/K3); on the CPU it is the plain module loop. A
ResBlock2 stage runs its plain modules on both, decided by the architecture
before any launch: the JAX package has no kernel for it either (its packed
gate refuses ``resblock != "1"`` and its linen stage runs in XLA).
:class:`ResBlockStages` holds that routing for this generator and
``models/hifigan.py:HifiGanGenerator``.
The TPU lane-layout machinery of the JAX module (the packed trunk and its
runner) is not ported: this computes the function it computes.

``tap_dtype=torch.bfloat16`` is ``PackedGeneratorRunner(fused_res_dtype=
bfloat16)``: the stages that the JAX packed route runs on its fused or
streamed resblock kernel (:func:`stage_tap_dtypes`, the JAX gates copied)
take bf16 tap stacks, the others stay float32, as the JAX linen and XLA
stages do. A stage with bf16 stacks runs ``resblock_stage`` on the CPU too
(its bf16 twin), so the CPU holds the route the card takes.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.models.common import params_key
from prodiff_tpu_torch.ops.resblock import LRELU_SLOPE, get_padding, resblock_stage


FUSED_TAP_BYTES_MAX = 9 * 2 ** 20  # the JAX fused stage's VMEM cap on its tap stacks


def hifigan_stage_packs(init_ch: int, n_stages: int) -> Tuple[int, ...]:
    """Packing factor per upsample stage of the JAX packed trunk (1 = plain
    layout); a copy of ``prodiff_tpu/models/nsf_hifigan.py:hifigan_stage_packs``."""
    packs = []
    for i in range(n_stages):
        c = init_ch // (2 ** (i + 1))
        packs.append(128 // c if (c < 128 and 128 % c == 0) else 1)
    return tuple(packs)


def packed_trunk_supported(t_mel: int, *, rates: Sequence[int], ksizes: Sequence[int],
                           init_ch: int, resblock: str, res_ksizes: Sequence[int],
                           has_source: bool) -> bool:
    """The JAX packed trunk's architecture and shape gate; a copy of
    ``prodiff_tpu/models/nsf_hifigan.py:packed_trunk_supported``."""
    n = len(rates)
    if str(resblock) != "1":
        return False
    if any(k != 2 * u for u, k in zip(rates, ksizes)):
        return False
    if any(rk % 2 == 0 for rk in res_ksizes):
        return False
    packs = hifigan_stage_packs(init_ch, n)
    if packs[-1] <= 1:
        return False
    t_audio = t_mel * int(np.prod(rates))
    p_prev, t_cur = 1, t_mel
    for i, (u, p) in enumerate(zip(rates, packs)):
        t_cur *= u
        if p < p_prev or (p > 1 and p % p_prev != 0):
            return False
        if t_cur % p != 0:
            return False
        if has_source:
            s_f0 = int(np.prod(rates[i + 1:])) if i + 1 < n else 1
            p_n = p if p > 1 else 2
            if t_audio % (s_f0 * p_n) != 0:
                return False
        p_prev = p
    return True


def convk_row_offsets(k: int, dilation: int, pack: int) -> Tuple[int, ...]:
    """The packed-row offsets an odd-k dilated SAME conv reaches at pack P; a
    copy of ``prodiff_tpu/ops/packed.py:convk_row_offsets``."""
    taps = [dilation * (j - k // 2) for j in range(k)]
    return tuple(sorted({(p_out + t - p_in) // pack for p_out in range(pack)
                         for p_in in range(pack) for t in taps
                         if (p_out + t - p_in) % pack == 0}))


def fused_stage_kinds(init_ch: int, n_stages: int, res_ksizes: Sequence[int],
                      res_dsizes: Sequence[Sequence[int]], tap_bytes: int = 2
                      ) -> Tuple[Optional[str], ...]:
    """Per stage, the JAX packed trunk's resblock kernel when it is given
    tap stacks of ``tap_bytes`` a value (``prepare_packed_trunk_params``,
    ``prodiff_tpu/models/nsf_hifigan.py:751-800``): ``"stream"``
    (``resblock_group_streamed``: an unpacked stage wider than 128 lanes, a
    multiple of 128), ``"fuse"`` (``resblock_group_packed``: a 128-lane
    stage whose tap stacks fit the VMEM cap) or None (the XLA stage)."""
    packs = hifigan_stage_packs(init_ch, n_stages)
    kinds = []
    for i, p in enumerate(packs):
        c = init_ch // (2 ** (i + 1))
        if p <= 1 and c > 128 and c % 128 == 0:
            kinds.append("stream")
            continue
        fuse = max(p, 1) * c == 128
        if fuse:
            taps = sum(len(convk_row_offsets(k, dd, max(p, 1)))
                       for k, ds in zip(res_ksizes, res_dsizes) for d in ds for dd in (d, 1))
            fuse = taps * 128 * 128 * tap_bytes <= FUSED_TAP_BYTES_MAX
        kinds.append("fuse" if fuse else None)
    return tuple(kinds)


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


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d, padding=get_padding(kernel_size, d))
            for d in dilation
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]."""
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


RESBLOCKS = {"1": ResBlock1, "2": ResBlock2}


class ResBlockStages(nn.Module):
    """The resblock stages of a HiFiGAN-family generator. A subclass sets
    ``ups``, ``resblocks`` (``len(resblock_kernel_sizes)`` a stage),
    ``resblock`` ("1" or "2"), ``resblock_kernel_sizes``,
    ``resblock_dilation_sizes``, ``upsample_rates``,
    ``upsample_kernel_sizes``, ``upsample_initial_channel`` and ``tap_dtype``,
    and defines ``_packed_supported(t_mel)``, the JAX packed route's gate."""

    def _init_stages(self, resblock: str, tap_dtype: torch.dtype) -> None:
        if str(resblock) not in RESBLOCKS:
            raise ValueError(f"resblock must be '1' or '2', got {resblock!r}")
        if tap_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"tap_dtype must be float32 or bfloat16, got {tap_dtype}")
        self.resblock, self.tap_dtype = str(resblock), tap_dtype
        self._stages = None

    def _packed_supported(self, t_mel: int) -> bool:
        raise NotImplementedError

    def stage_tap_dtypes(self, t_mel: int) -> Tuple[torch.dtype, ...]:
        """Per stage, the dtype of its tap stacks for a mel of ``t_mel``
        frames: ``tap_dtype`` where the JAX package's packed route runs the
        fused or streamed resblock kernel (the trunk's gate at this length,
        then the stage's kind, :func:`fused_stage_kinds`), else float32,
        as its linen and XLA stages compute."""
        n = len(self.upsample_rates)
        if self.tap_dtype == torch.float32 or not self._packed_supported(t_mel):
            return (torch.float32,) * n
        kinds = fused_stage_kinds(self.upsample_initial_channel, n, self.resblock_kernel_sizes,
                                  self.resblock_dilation_sizes,
                                  torch.finfo(self.tap_dtype).bits // 8)
        return tuple(self.tap_dtype if kind else torch.float32 for kind in kinds)

    def stage_weights(self, dtypes: Optional[Sequence[torch.dtype]] = None
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """Per stage, its ResBlock1 convs flattened for ``resblock_stage``:
        weights (each conv ``[k, C_in, C_out]``, in resblock/unit/conv1-conv2
        order) in that stage's entry of ``dtypes`` (default float32; bf16
        copies are made here, the parameters stay float32) and float32
        biases ``[n_convs, C]``; rebuilt when a parameter or the dtypes
        change."""
        if self.resblock != "1":
            raise ValueError("stage_weights: only ResBlock1 stages run resblock_stage")
        dtypes = tuple(dtypes or (torch.float32,) * len(self.ups))
        key = (params_key(self), dtypes)
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
                    stages.append((torch.cat(ws).to(dtypes[i]).contiguous(),
                                   torch.stack(bs).contiguous()))
            self._stages = (key, tuple(stages))
        return self._stages[1]

    def stage(self, i: int, x: torch.Tensor, dtypes: Sequence[torch.dtype]) -> torch.Tensor:
        """Stage ``i``'s resblock mean on x [B, C, T]: one ``resblock_stage``
        call for a ResBlock1 stage on the card or with bf16 tap stacks, else
        the plain module loop."""
        n = len(self.resblock_kernel_sizes)
        if self.resblock == "1" and (x.is_cuda or dtypes[i] != torch.float32):
            w, b = self.stage_weights(dtypes)[i]
            return resblock_stage(
                x.transpose(1, 2), w, b, self.resblock_kernel_sizes, self.resblock_dilation_sizes,
            ).transpose(1, 2)
        xs = 0.0
        for rb in self.resblocks[i * n: (i + 1) * n]:
            xs = xs + rb(x)
        return xs / n


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


class Generator(ResBlockStages):
    """``h``-style constructor arguments: the openvpi NSF-HiFiGAN config.json
    fields (defaults = the 44.1 kHz, 128-mel release)."""

    def __init__(self, num_mels: int = 128, sampling_rate: int = 44100,
                 upsample_initial_channel: int = 512,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4),
                 resblock: str = "1", resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 tap_dtype: torch.dtype = torch.float32):
        super().__init__()
        self._init_stages(resblock, tap_dtype)
        self.upsample_initial_channel = upsample_initial_channel
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.upp = int(np.prod(self.upsample_rates))
        self.m_source = SourceModuleHnNSF(sampling_rate, harmonic_num=8)
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        block = RESBLOCKS[self.resblock]
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
                self.resblocks.append(block(c_cur, rk, rd))
        self.conv_post = nn.Conv1d(c_cur, 1, 7, padding=3)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                nn.init.normal_(m.weight, 0.0, 0.01)

    @classmethod
    def from_config(cls, h: dict, tap_dtype: torch.dtype = torch.float32) -> "Generator":
        return cls(
            num_mels=h["num_mels"], sampling_rate=h["sampling_rate"],
            upsample_initial_channel=h["upsample_initial_channel"],
            upsample_rates=h["upsample_rates"],
            upsample_kernel_sizes=h["upsample_kernel_sizes"],
            resblock=str(h["resblock"]),
            resblock_kernel_sizes=h["resblock_kernel_sizes"],
            resblock_dilation_sizes=h["resblock_dilation_sizes"],
            tap_dtype=tap_dtype,
        )

    def _packed_supported(self, t_mel: int) -> bool:
        """``prodiff_tpu/models/nsf_hifigan.py:Generator._packed_supported``."""
        return packed_trunk_supported(
            t_mel, rates=self.upsample_rates, ksizes=self.upsample_kernel_sizes,
            init_ch=self.upsample_initial_channel, resblock=self.resblock,
            res_ksizes=self.resblock_kernel_sizes, has_source=True)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel [B, T, M] natural-log; f0 [B, T] Hz -> wav [B, T*upp].

        ``generator=None`` renders deterministically (zero-phase, noise-free
        sine source)."""
        har_source = self.m_source(f0, self.upp, generator).transpose(1, 2)  # [B, 1, T*upp]
        dtypes = self.stage_tap_dtypes(mel.shape[1])
        x = self.conv_pre(mel.transpose(1, 2))
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(F.leaky_relu(x, LRELU_SLOPE)) + noise_conv(har_source)
            x = self.stage(i, x, dtypes)
        x = self.conv_post(F.leaky_relu(x))  # torch default slope 0.01 here
        return torch.tanh(x)[:, 0]
