"""FastDiff conditional waveform diffusion vocoder (port of
``prodiff_tpu/models/fastdiff.py``, the linen path; inference only).

A downsample pyramid (``DiffusionDBlock``) of the noisy audio, then three
time-aware LVC blocks: each upsamples its input, and a KernelPredictor turns
mel + noise-step embedding into per-frame location-variable conv kernels
that drive the block's layer loop. Epsilon prediction with the 4/6/8/1000-step
reverse schedules of ``vocoders/fastdiff.py``.

Two routes run each LVC layer; both compute ``TimeAwareLVCBlock``'s layer:

- ``fused_layer=True`` (default; the vocoder's ``fastdiff_packed`` unset or
  true): one fused kernel per layer, ``ops/ublock.py`` (port of the Pallas
  ``ublock_layer_packed``);
- ``fused_layer=False`` (``fastdiff_packed: false``): the unfused layer, the
  dilated conv in cuDNN, the LVC through ``ops/lvc.py`` (port of the Pallas
  ``lvc_pallas``), then gate and residual in PyTorch.

With the module constant ``MONO_BLOCK`` set (the counterpart of the JAX
package's ``_MONO_BLOCK``, off by default as there) and the fused layer, a
block that :func:`~prodiff_tpu_torch.ops.ublock.mono_block_supported` admits
(the audio-rate blocks: hops 64 and 256 at the LJSpeech config) runs all its
layers in one launch of ``ops/ublock.py:ublock_block`` (port of the Pallas
``ublock_block_packed``); the others keep the layer route.

A block whose hop its route's kernel does not take (``ops/lvc.py:on_kernels``,
decided from the hop before any launch: K6 takes the multiples of 8, K4
those and the multiples of 4 from hop 64 on, as ``ublock_layer_packed``)
runs the unfused layer, its window product through ``ops/lvc.py:lvc_matmul``,
as the JAX package's XLA einsum computes it there. On CUDA tensors the wrappers launch their kernels; on CPU tensors
they run their plain twins. Per forward that is blocks x layers = 12 launches of the
route's layer kernel, or with ``MONO_BLOCK`` 4 layer launches (block 0) and
2 block launches. The JAX package's packed space-to-depth trunk
(``_packed_forward``, ``ops/packed.py``) is a TPU lane layout and is not
ported; nor are its diagnostic knobs.

The KernelPredictor depends only on (mel, step), so a sampler hoists it out
of its loop (:func:`fastdiff_step_kernels`): one batched KP per block per
segment, stacked ``[n, B, L, layers*3C, 2C]``, which the layer kernels read
in place at (step, layer). With ``kp_dtype=torch.bfloat16`` (the fused
layer in ``fast`` mode on the card, ``device.kernel_predictor_dtype``, as the
JAX packed route off interpret mode) the KernelPredictors compute in bf16
and the stacks are bf16; the layer kernels widen each window value to
float32 where they read it, and the biases stay float32. Layout is
``[B, T, C]`` at the public functions, as in the JAX package; the convs run
channel-first inside.

State-dict names follow the torch reference (``first_audio_conv``,
``downsample.{i}.conv.{j}``, ``lvc_blocks.{i}.kernel_predictor.residual_conv.{1,3,6,8,11,13}``,
``final_conv.0`` ...), with one difference: ``kernel_conv``'s output rows are
held tap-major ``[layers, k, Cin, Cout]`` so the GEMM-ready window kernels are
a plain reshape. A reference checkpoint's ``[layers, Cin, Cout, k]`` rows are
permuted once at load (:func:`tap_major_state_dict`), never per call.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.models.common import Dropout
from prodiff_tpu_torch.ops.lvc import lvc, lvc_matmul, on_kernels
from prodiff_tpu_torch.ops.ublock import (
    LRELU_SLOPE,
    dilated_conv,
    gated_residual,
    mono_block_supported,
    ublock_block,
    ublock_layer,
)

KP_LRELU = 0.1
# Run all layers of an audio-rate LVC block in one kernel launch (K7) instead
# of one launch per layer (K4). Off by default, as the JAX package's
# _MONO_BLOCK; chip_smoke.py sets it to measure the one against the other.
MONO_BLOCK = False
# Hoisting stacks [n_steps, B, L, layers*3C*2C] kernels per block: fine for
# the 4/6/8-step schedules, ruinous for the 1000-step one.
MAX_HOISTED_STEPS = 16

BlockKernels = Tuple[torch.Tensor, torch.Tensor]  # ([n, B, L, layers*3C, 2C], [n, B, L, layers*2C])


def diffusion_step_embedding(steps: torch.Tensor, dim: int) -> torch.Tensor:
    """steps [B, 1] (possibly fractional) -> [B, dim] sin | cos embedding."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=steps.device)
                      * -(math.log(10000) / (half - 1)))
    args = steps.float() * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def kernel_conv_perm(layers: int, cin: int, cout: int, k: int) -> np.ndarray:
    """Row permutation: tap-major ``kernel_conv`` rows = reference rows[perm]."""
    return (np.arange(layers * cin * cout * k).reshape(layers, cin, cout, k)
            .transpose(0, 3, 1, 2).reshape(-1))


def tap_major_state_dict(sd: dict, config: dict) -> dict:
    """A torch-reference state dict -> this port's (``kernel_conv`` rows
    permuted to tap-major; every other entry shared)."""
    cin, k = config["inner_channels"], config["lvc_kernel_size"]
    perm = torch.from_numpy(kernel_conv_perm(config["lvc_layers_each_block"], cin, 2 * cin, k))
    out = dict(sd)
    for i in range(len(config["upsample_ratios"])):
        for name in ("weight", "bias"):
            key = f"lvc_blocks.{i}.kernel_predictor.kernel_conv.{name}"
            out[key] = sd[key][perm]
    return out


class DiffusionDBlock(nn.Module):
    def __init__(self, hidden_size: int, factor: int):
        super().__init__()
        self.factor = factor
        self.residual_dense = nn.Conv1d(hidden_size, hidden_size, 1)
        self.conv = nn.ModuleList(
            nn.Conv1d(hidden_size, hidden_size, 3, dilation=d, padding=d) for d in (1, 2, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] -> [B, C, T // factor] (nearest downsample + dilated convs)."""
        down = x[..., ::self.factor][..., : x.shape[-1] // self.factor]
        h = down
        for conv in self.conv:
            h = conv(F.leaky_relu(h, 0.2))
        return h + self.residual_dense(down)


class KernelPredictor(nn.Module):
    """Port of ``prodiff_tpu/models/fastdiff.py:KernelPredictor`` with
    ``flat=True``. ``dtype`` is flax's ``dtype=``: None computes in float32;
    ``torch.bfloat16`` casts the parameters (kept float32) and the input to
    bf16 at use and runs every conv, bias add, leaky and the residual add in
    bf16, rounding where flax does (``promote_dtype``; a conv's or a head's
    product, then its bias add, each round to bf16: ``_GemmSameConv``). So
    the window kernels come out bf16. These convs run outside any Pallas
    kernel in the JAX package; here cuDNN and cuBLAS compute them."""

    def __init__(self, cond_channels: int, conv_in_channels: int, conv_out_channels: int,
                 conv_layers: int, conv_kernel_size: int = 3, kpnet_hidden_channels: int = 64,
                 kpnet_conv_size: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        hid, ks = kpnet_hidden_channels, kpnet_conv_size
        self.dtype = dtype
        self.conv_size = ks
        self.input_conv = nn.Sequential(nn.Conv1d(cond_channels, hid, 5, padding=2),
                                        nn.LeakyReLU(KP_LRELU))
        layers: List[nn.Module] = []
        for _ in range(3):  # reference Sequential: convs at indices 1, 3, 6, 8, 11, 13
            layers += [Dropout(0.0),
                       nn.Conv1d(hid, hid, ks, padding=(ks - 1) // 2), nn.LeakyReLU(KP_LRELU),
                       nn.Conv1d(hid, hid, ks, padding=(ks - 1) // 2), nn.LeakyReLU(KP_LRELU)]
        self.residual_conv = nn.Sequential(*layers)
        l_w = conv_in_channels * conv_out_channels * conv_kernel_size * conv_layers
        self.kernel_conv = nn.Conv1d(hid, l_w, ks, padding=(ks - 1) // 2)
        self.bias_conv = nn.Conv1d(hid, conv_out_channels * conv_layers, ks, padding=(ks - 1) // 2)

    def _head(self, hu: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
        # a SAME conv as one GEMM on the unfolded input, so the (large) output
        # comes out [B, L, features] contiguous, ready for the window kernels
        w = conv.weight.view(conv.out_channels, -1)
        if self.dtype is None:
            return F.linear(hu, w, conv.bias)
        return F.linear(hu, w.to(self.dtype)) + conv.bias.to(self.dtype)

    def _trunk_bf16(self, c: torch.Tensor) -> torch.Tensor:
        """The input and residual convs in ``self.dtype``, flax's rounding."""
        def conv(h, m):
            return (F.conv1d(h, m.weight.to(self.dtype), None, padding=m.padding)
                    + m.bias.to(self.dtype)[:, None])

        h = F.leaky_relu(conv(c.transpose(1, 2).to(self.dtype), self.input_conv[0]), KP_LRELU)
        r = h
        for m in self.residual_conv:
            if isinstance(m, nn.Conv1d):
                r = F.leaky_relu(conv(r, m), KP_LRELU)
        return h + r

    def forward(self, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """c [B, L, cond] -> flat kernels [B, L, layers*k*Cin*Cout] (tap-major
        ``[layers, k, Cin, Cout]``) and biases [B, L, layers*Cout], both in
        the compute dtype."""
        if self.dtype is None:
            h = self.input_conv(c.transpose(1, 2))
            h = h + self.residual_conv(h)
        else:
            h = self._trunk_bf16(c)
        ks = self.conv_size
        lo = (ks - 1) // 2
        hu = F.pad(h, (lo, ks - 1 - lo)).unfold(2, ks, 1)  # [B, hid, L, ks]
        hu = hu.permute(0, 2, 1, 3).reshape(h.shape[0], h.shape[2], -1)  # column ci*ks + q
        return self._head(hu, self.kernel_conv), self._head(hu, self.bias_conv)


class TimeAwareLVCBlock(nn.Module):
    def __init__(self, in_channels: int, cond_channels: int, upsample_ratio: int,
                 conv_layers: int = 4, cond_hop_length: int = 256,
                 kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 noise_scale_embed_dim_out: int = 512, kp_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, r = in_channels, upsample_ratio
        self.cond_hop_length = cond_hop_length
        self.fc_t = nn.Linear(noise_scale_embed_dim_out, cond_channels)
        self.kernel_predictor = KernelPredictor(cond_channels, c, 2 * c, conv_layers, 3,
                                                kpnet_hidden_channels, kpnet_conv_size, kp_dtype)
        self.upsample = nn.ConvTranspose1d(c, c, 2 * r, stride=r, padding=r // 2 + r % 2,
                                           output_padding=r % 2)
        self.convs = nn.ModuleList(
            nn.Conv1d(c, c, 3, dilation=3 ** i, padding=3 ** i) for i in range(conv_layers))

    def kernels(self, c: torch.Tensor, emb: torch.Tensor) -> BlockKernels:
        """c [n*B, L, cond], emb [n, D] -> this block's window-kernel stack
        ``[n, B, L, layers*3C, 2C]`` in the KernelPredictor's dtype (a view of
        its output, no copy) and bias stack ``[n, B, L, layers*2C]`` in
        float32 (the JAX packed route casts the bf16 biases back,
        ``prodiff_tpu/models/fastdiff.py:548-550``)."""
        n = emb.shape[0]
        nb, L, _ = c.shape
        noise = self.fc_t(emb)  # [n, cond]
        cond = c.view(n, nb // n, L, -1) + noise[:, None, None, :]
        kflat, bflat = self.kernel_predictor(cond.view(nb, L, -1))
        cout = 2 * self.convs[0].in_channels
        return kflat.view(n, nb // n, L, -1, cout), bflat.float().view(n, nb // n, L, -1)

    def forward(self, x: torch.Tensor, audio_down: torch.Tensor, kp: BlockKernels,
                step_idx: int, fused_layer: bool) -> torch.Tensor:
        """x [B, C, T/r] (channel-first), audio_down [B, T, C] -> [B, T, C]."""
        km, lb = kp
        hop = self.cond_hop_length
        x = self.upsample(F.leaky_relu(x, 0.2)).transpose(1, 2).contiguous()
        dilations = [conv.dilation[0] for conv in self.convs]
        kernels = on_kernels(hop, fused_layer)
        if MONO_BLOCK and fused_layer and kernels and mono_block_supported(hop, dilations,
                                                                           km.dtype):
            return ublock_block(x, audio_down, [conv.weight for conv in self.convs],
                                [conv.bias for conv in self.convs], km, lb, dilations, hop,
                                step_idx)
        for i, conv in enumerate(self.convs):
            d = conv.dilation[0]
            if fused_layer and kernels:
                x = ublock_layer(x, audio_down, conv.weight, conv.bias, km, lb, d, hop,
                                 step_idx, i)
            else:
                xa = x + audio_down
                y = F.leaky_relu(dilated_conv(F.leaky_relu(xa, LRELU_SLOPE), conv.weight,
                                              conv.bias, d), LRELU_SLOPE)
                product = lvc if kernels else lvc_matmul
                x = gated_residual(xa, product(y, km, lb, hop, step_idx, i))
        return x


class FastDiff(nn.Module):
    def __init__(self, audio_channels: int = 1, inner_channels: int = 32,
                 cond_channels: int = 80, upsample_ratios: Sequence[int] = (8, 8, 4),
                 lvc_layers_each_block: int = 4, lvc_kernel_size: int = 3,
                 kpnet_hidden_channels: int = 64, kpnet_conv_size: int = 3,
                 diffusion_step_embed_dim_in: int = 128, diffusion_step_embed_dim_mid: int = 512,
                 diffusion_step_embed_dim_out: int = 512, fused_layer: bool = True,
                 kp_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if lvc_kernel_size != 3 or audio_channels != 1:
            raise NotImplementedError("the port runs the reference shape: k=3 LVC, mono audio")
        if kp_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"kp_dtype must be float32 or bfloat16, got {kp_dtype}")
        if kp_dtype == torch.bfloat16 and not fused_layer:
            raise ValueError("bf16 window kernels run on the fused-layer route only: the JAX "
                             "package's unfused (linen) route computes its KernelPredictor in "
                             "float32")
        self.fused_layer = fused_layer
        kp_dtype = None if kp_dtype == torch.float32 else kp_dtype
        self.embed_dim_in = diffusion_step_embed_dim_in
        c = inner_channels
        self.first_audio_conv = nn.Conv1d(audio_channels, c, 7, padding=3)
        self.fc_t1 = nn.Linear(diffusion_step_embed_dim_in, diffusion_step_embed_dim_mid)
        self.fc_t2 = nn.Linear(diffusion_step_embed_dim_mid, diffusion_step_embed_dim_out)
        n_blocks = len(upsample_ratios)
        self.downsample = nn.ModuleList(
            DiffusionDBlock(c, upsample_ratios[n_blocks - i - 1]) for i in range(n_blocks))
        hops = np.cumprod(upsample_ratios)
        self.lvc_blocks = nn.ModuleList(
            TimeAwareLVCBlock(c, cond_channels, r, lvc_layers_each_block, int(hop),
                              kpnet_hidden_channels, kpnet_conv_size,
                              diffusion_step_embed_dim_out, kp_dtype)
            for r, hop in zip(upsample_ratios, hops))
        self.final_conv = nn.Sequential(nn.Conv1d(c, audio_channels, 7, padding=3))

    @classmethod
    def from_config(cls, config: dict, fused_layer: bool = True,
                    kp_dtype: Optional[torch.dtype] = None) -> "FastDiff":
        keys = ("audio_channels", "inner_channels", "cond_channels", "upsample_ratios",
                "lvc_layers_each_block", "lvc_kernel_size", "kpnet_hidden_channels",
                "kpnet_conv_size", "diffusion_step_embed_dim_in", "diffusion_step_embed_dim_mid",
                "diffusion_step_embed_dim_out")
        return cls(**{k: config[k] for k in keys}, fused_layer=fused_layer, kp_dtype=kp_dtype)

    def step_embedding(self, steps: torch.Tensor) -> torch.Tensor:
        """steps [n, 1] -> [n, D_out]."""
        emb = diffusion_step_embedding(steps, self.embed_dim_in)
        return swish(self.fc_t2(swish(self.fc_t1(emb))))

    def forward(self, audio: torch.Tensor, c: torch.Tensor, diffusion_steps: torch.Tensor,
                kp_out: Optional[Tuple[List[BlockKernels], int]] = None) -> torch.Tensor:
        """audio [B, T, 1]; c [B, L, cond] (T == L * prod(ratios));
        diffusion_steps [B, 1] -> epsilon [B, T, 1].

        ``kp_out``: optional hoisted KernelPredictor outputs,
        ``(fastdiff_step_kernels(...), step_idx)``; the layers then read step
        ``step_idx``'s kernels in place and ``diffusion_steps`` is not used."""
        if kp_out is None:
            # B "steps" of one batch row each, regrouped as one step of B rows
            emb = self.step_embedding(diffusion_steps)
            kps = [(km.view(1, -1, *km.shape[2:]), lb.view(1, -1, *lb.shape[2:]))
                   for km, lb in (blk.kernels(c, emb) for blk in self.lvc_blocks)]
            step_idx = 0
        else:
            kps, step_idx = kp_out
        x = self.first_audio_conv(audio.transpose(1, 2))
        downsampled = []
        for blk in self.downsample:
            downsampled.append(x)
            x = blk(x)
        n_blocks = len(self.lvc_blocks)
        for n, blk in enumerate(self.lvc_blocks):
            audio_down = downsampled[n_blocks - 1 - n].transpose(1, 2).contiguous()
            x = blk(x, audio_down, kps[n], step_idx, self.fused_layer).transpose(1, 2)
        return self.final_conv(x).transpose(1, 2)


@torch.no_grad()
def fastdiff_step_kernels(net: FastDiff, c: torch.Tensor, steps: torch.Tensor) -> List[BlockKernels]:
    """The KernelPredictor outputs for a fixed set of diffusion steps, one
    batched KP per block: c [B, L, cond], steps [n] -> per block
    ``(km [n, B, L, layers*3C, 2C], lb [n, B, L, layers*2C])``; layer i is
    rows ``[i*3C, (i+1)*3C)`` of km's dim 3 and columns ``[i*2C, (i+1)*2C)``
    of lb's dim 3, read in place by the layer kernels."""
    n = steps.shape[0]
    emb = net.step_embedding(steps.reshape(n, 1))
    cn = c[None].expand(n, *c.shape).reshape(n * c.shape[0], *c.shape[1:])
    return [blk.kernels(cn, emb) for blk in net.lvc_blocks]


# ---- diffusion hyperparams + sampling (host schedules in float64) -----------


def compute_hyperparams_given_schedule(beta: np.ndarray) -> dict:
    """Cumulative alpha/sigma from a beta schedule."""
    beta = np.asarray(beta, np.float64)
    alpha = 1 - beta
    sigma = beta.copy()
    for t in range(1, len(beta)):
        alpha[t] *= alpha[t - 1]
        sigma[t] *= (1 - alpha[t - 1]) / (1 - alpha[t])
    return {"T": len(beta), "beta": beta, "alpha": np.sqrt(alpha), "sigma": np.sqrt(sigma)}


def map_noise_scale_to_time_step(alpha_infer: float, alpha: np.ndarray) -> float:
    if alpha_infer < alpha[-1]:
        return len(alpha) - 1
    if alpha_infer > alpha[0]:
        return 0
    for t in range(len(alpha) - 1):
        if alpha[t + 1] <= alpha_infer <= alpha[t]:
            return t + float((alpha[t] - alpha_infer) / (alpha[t] - alpha[t + 1]))
    return -1


def prepare_inference_schedule(inference_noise_schedule: np.ndarray, alpha_train: np.ndarray
                               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (beta_infer, alpha_infer, sigma_infer, steps_infer)."""
    beta_infer = np.asarray(inference_noise_schedule, np.float64)
    alpha_infer = 1 - beta_infer
    sigma_infer = beta_infer.copy()
    for n in range(1, len(beta_infer)):
        alpha_infer[n] *= alpha_infer[n - 1]
        sigma_infer[n] *= (1 - alpha_infer[n - 1]) / (1 - alpha_infer[n])
    alpha_infer, sigma_infer = np.sqrt(alpha_infer), np.sqrt(sigma_infer)
    steps, keep = [], []
    for n in range(len(beta_infer)):
        step = map_noise_scale_to_time_step(alpha_infer[n], alpha_train)
        if step >= 0:
            steps.append(step)
            keep.append(n)
    keep = np.asarray(keep, np.int64)
    return beta_infer[keep], alpha_infer[keep], sigma_infer[keep], np.asarray(steps, np.float64)


@torch.no_grad()
def sampling_given_noise_schedule(
    net: FastDiff, cond: torch.Tensor, audio_length: int, beta_infer: np.ndarray,
    alpha_infer: np.ndarray, sigma_infer: np.ndarray, steps_infer: np.ndarray,
    generator: Optional[torch.Generator] = None, init_noise: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None, kp_all: Optional[List[BlockKernels]] = None,
) -> torch.Tensor:
    """Reverse epsilon-prediction diffusion, a loop over i = n-1 .. 0:
    cond [B, L, M] -> wav [B, audio_length].

    ``init_noise`` [B, T, 1] / ``step_noises`` [n, B, T, 1] inject the
    randomness (iteration k uses ``step_noises[k]``; the last one's is unused,
    as the reference adds no noise at i == 0); what is not injected is drawn
    from ``generator``. ``kp_all``: :func:`fastdiff_step_kernels` over
    ``steps_infer``, read in place by every step. The constants are float32."""
    b, dev = cond.shape[0], cond.device
    n = len(steps_infer)
    beta, alpha, sigma, steps = (torch.tensor(np.asarray(a, np.float32))
                                 for a in (beta_infer, alpha_infer, sigma_infer, steps_infer))
    c_eps = (beta / torch.sqrt(1 - alpha ** 2)).to(dev)
    c_div = torch.sqrt(1 - beta).to(dev)
    sigma = sigma.to(dev)
    kw = dict(generator=generator, device=dev, dtype=torch.float32)
    x = init_noise[..., 0] if init_noise is not None else torch.randn((b, audio_length), **kw)
    for k, i in enumerate(range(n - 1, -1, -1)):
        t = torch.full((b, 1), float(steps[i]), device=dev)
        kp_out = None if kp_all is None else (kp_all, i)
        eps = net(x[..., None], cond, t, kp_out)[..., 0]
        x = (x - c_eps[i] * eps) / c_div[i]
        if i > 0:
            noise = step_noises[k, ..., 0] if step_noises is not None \
                else torch.randn((b, audio_length), **kw)
            x = x + sigma[i] * noise
    return x
