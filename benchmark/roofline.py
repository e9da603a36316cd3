"""Frozen yardstick: the H100's published peaks, the least time each kernel
call could take from its shapes, and the model's operations on real frames.

The kernel formulas are the ones the port's kernel table was measured
against (operations at the float32 rate, every input byte read once and
every output byte written once); a kernel's roofline share is the sum of
its calls' bounds over the time the trace gives its kernels."""

from __future__ import annotations

from typing import Sequence

FP32_PEAK = 67e12  # H100 SXM, float32 outside the tensor cores, 700 W
HBM_RATE = 3.35e12  # bytes/s
F32 = 4


def bound_s(flops: float, nbytes: float, peak: float = FP32_PEAK) -> float:
    """The least seconds: operations at ``peak`` or bytes at the HBM rate,
    whichever is longer."""
    return max(flops / peak, nbytes / HBM_RATE)


def k1(b: int, t: int, c: int = 256, h: int = 256, n_layers: int = 20) -> tuple:
    """(flops, bytes) of one K1 call, the inference stack of ``n_layers``
    gated layers on [b, t, c] with condition width ``h``."""
    layer = 3 * c * 2 * c + h * 2 * c + c * 2 * c
    flops = 2 * b * t * n_layers * layer + 2 * b * n_layers * c * c
    nbytes = F32 * (2 * b * t * c + b * t * h + b * c + n_layers * (layer + c * c + 7 * c))
    return flops, nbytes


def resblock_stage(b: int, t: int, c: int, ksizes: Sequence[int] = (3, 7, 11),
                   units: int = 3) -> tuple:
    """(flops, bytes) of one ResBlock1 stage call (K2/K3): ``2 * units`` convs
    of each kernel size on [b, t, c]."""
    taps = 2 * units * sum(ksizes)
    n_convs = 2 * units * len(ksizes)
    return (2 * taps * c * c * t * b,
            F32 * (2 * b * t * c + taps * c * c + n_convs * c))


def k5_save(b: int, t: int, c: int = 256, h: int = 256, n_layers: int = 20) -> tuple:
    """(flops, bytes) of K5a, the training stack's forward that saves every
    layer's input and pre-activations."""
    bt = b * t
    layer = 3 * c * 2 * c + h * 2 * c + c * 2 * c
    flops = 2 * bt * n_layers * layer + 2 * b * n_layers * c * c
    nbytes = F32 * (bt * (c + h + c) + b * c + n_layers * (layer + c * c + 7 * c)
                    + n_layers * bt * 3 * c)
    return flops, nbytes


def k5_chain(b: int, t: int, c: int = 256, n_layers: int = 20) -> tuple:
    """(flops, bytes) of K5b, the backward chain through the layers."""
    bt = b * t
    flops = 2 * bt * n_layers * (2 * c * c + 3 * 2 * c * c)
    nbytes = F32 * (n_layers * bt * 2 * c + bt * c + n_layers * (3 * c * 2 * c + c * 2 * c)
                    + n_layers * bt * 3 * c + bt * c)
    return flops, nbytes


# ---- the model's operations on real frames (multiply-adds x 2) -------------

def encoder_flops(tokens: int, length: int, hp: dict) -> float:
    """One encoder pass over a phrase of ``tokens`` real tokens (attention
    over ``length`` keys)."""
    h, k = hp["hidden_size"], hp["enc_ffn_kernel_size"]
    per_token = 3 * h * h + h * h + 2 * length * h + k * h * 4 * h + 4 * h * h
    return 2.0 * hp["enc_layers"] * tokens * per_token


def wavenet_flops(frames: int, hp: dict) -> float:
    """One denoiser call over ``frames`` real frames."""
    c, h, m = hp["residual_channels"], hp["hidden_size"], hp["audio_num_mel_bins"]
    layer = 3 * c * 2 * c + h * 2 * c + c * 2 * c
    return 2.0 * frames * (m * c + hp["residual_layers"] * layer + c * c + c * m)


def vocoder_flops(frames: int, h: dict) -> float:
    """NSF-HiFiGAN over ``frames`` real mel frames: conv_pre, the upsamplers,
    the source's convs, the ResBlock1 stages and conv_post."""
    c = h["upsample_initial_channel"]
    macs = 7 * h["num_mels"] * c
    per_frame = 1
    rates = h["upsample_rates"]
    taps = 2 * len(h["resblock_dilation_sizes"][0]) * sum(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        c_out = c // 2
        per_frame *= u
        s = 1
        for r in rates[i + 1:]:
            s *= r
        noise_taps = 2 * s if i + 1 < len(rates) else 1
        macs += per_frame * (c * c_out * k / u + c_out * noise_taps + taps * c_out * c_out)
        c = c_out
    macs += per_frame * (7 * c + 9)
    return 2.0 * frames * macs


def render_flops(tokens: int, frames: int, hp: dict, h: dict, steps: int) -> float:
    """A phrase's render: the encoder, ``steps`` denoiser calls, the vocoder."""
    return (encoder_flops(tokens, tokens, hp) + steps * wavenet_flops(frames, hp)
            + vocoder_flops(frames, h))


def train_flops(tokens: int, frames: int, hp: dict) -> float:
    """A corpus item's training step: forward (encoder, one denoiser call,
    the SSIM's five 11 x 11 blurs) and a backward of twice its operations."""
    ssim = 5 * 121 * 2.0 * frames * hp["audio_num_mel_bins"]
    return 3 * (encoder_flops(tokens, tokens, hp) + wavenet_flops(frames, hp) + ssim)
