"""RMVPE, the deep-learning f0 extractor (port of ``prodiff_tpu/models/rmvpe.py``).

``E2E0`` = ``DeepUnet0`` (a U-Net of ``ConvBlockRes`` encoder, intermediate
and decoder blocks over a 128-bin htk log-mel) + a 3-channel conv + a
bidirectional GRU -> a 360-way sigmoid over 20-cent pitch bins.
Inference only: the BatchNorms run in eval mode on their stored statistics
(``model.eval()`` is the caller's). Module and parameter names are the
reference's torch ones (``modules/rmvpe/``), so a released checkpoint loads
with ``load_state_dict`` and ``prodiff_tpu.models.rmvpe.convert_rmvpe``
takes this module's ``state_dict()`` unchanged. The reference's
``TimbreFilter`` (``unet.tf.*``) is dead in its forward pass and is not
built; :func:`rmvpe_checkpoint` drops its keys.

The JAX package emulates ``nn.ConvTranspose2d(k=3, padding=1)`` with a
flipped kernel and ``lhs_dilation`` (``ConvTranspose2dTorch``) and runs the
GRU as two ``lax.scan``s; here both are the torch layers (cuDNN on the card).
The decoders (:func:`to_local_average_f0`, :func:`to_viterbi_f0`) are
numpy on the host, copied.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from prodiff_tpu_torch.models.common import Dropout

SAMPLE_RATE = 16000
N_CLASS = 360
N_MELS = 128
MEL_FMIN = 30
MEL_FMAX = 8000
WINDOW_LENGTH = 1024
CONST = 1997.3794084376191
BN_MOMENTUM = 0.01  # the reference's; eval mode never reads it


class ConvBlockRes(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=BN_MOMENTUM),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False),
            nn.BatchNorm2d(out_channels, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        res = self.shortcut(x) if hasattr(self, "shortcut") else x
        return self.conv(x) + res


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Optional[Tuple[int, int]], n_blocks: int = 1):
        super().__init__()
        self.conv = nn.ModuleList([ConvBlockRes(in_channels if i == 0 else out_channels,
                                                out_channels) for i in range(n_blocks)])
        self.pool = nn.AvgPool2d(kernel_size) if kernel_size is not None else None

    def forward(self, x):
        for block in self.conv:
            x = block(x)
        if self.pool is None:
            return x
        return x, self.pool(x)


class Encoder(nn.Module):
    def __init__(self, in_channels: int, n_encoders: int, kernel_size, n_blocks: int,
                 out_channels: int = 16):
        super().__init__()
        self.bn = nn.BatchNorm2d(in_channels, momentum=BN_MOMENTUM)
        self.layers = nn.ModuleList()
        for _ in range(n_encoders):
            self.layers.append(ResEncoderBlock(in_channels, out_channels, kernel_size, n_blocks))
            in_channels, out_channels = out_channels, out_channels * 2
        self.out_channel = out_channels

    def forward(self, x):
        skips = []
        x = self.bn(x)
        for layer in self.layers:
            skip, x = layer(x)
            skips.append(skip)
        return x, skips


class Intermediate(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_inters: int, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList([
            ResEncoderBlock(in_channels if i == 0 else out_channels, out_channels, None, n_blocks)
            for i in range(n_inters)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride, n_blocks: int = 1):
        super().__init__()
        out_padding = (0, 1) if tuple(stride) == (1, 2) else (1, 1)
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride, 1, out_padding, bias=False),
            nn.BatchNorm2d(out_channels, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )
        self.conv2 = nn.ModuleList([ConvBlockRes(out_channels * 2 if i == 0 else out_channels,
                                                 out_channels) for i in range(n_blocks)])

    def forward(self, x, concat):
        x = torch.cat((self.conv1(x), concat), dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class Decoder(nn.Module):
    def __init__(self, in_channels: int, n_decoders: int, stride, n_blocks: int):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(n_decoders):
            self.layers.append(ResDecoderBlock(in_channels, in_channels // 2, stride, n_blocks))
            in_channels //= 2

    def forward(self, x, skips):
        for i, layer in enumerate(self.layers):
            x = layer(x, skips[-1 - i])
        return x


class DeepUnet0(nn.Module):
    def __init__(self, kernel_size=(2, 2), n_blocks: int = 4, en_de_layers: int = 5,
                 inter_layers: int = 4, in_channels: int = 1, en_out_channels: int = 16):
        super().__init__()
        self.encoder = Encoder(in_channels, en_de_layers, kernel_size, n_blocks, en_out_channels)
        self.intermediate = Intermediate(self.encoder.out_channel // 2, self.encoder.out_channel,
                                         inter_layers, n_blocks)
        self.decoder = Decoder(self.encoder.out_channel, en_de_layers, kernel_size, n_blocks)

    def forward(self, x):
        """x [B, 1, T, M] -> [B, en_out_channels, T, M]."""
        x, skips = self.encoder(x)
        return self.decoder(self.intermediate(x), skips)


class BiGRU(nn.Module):
    def __init__(self, input_features: int, hidden_features: int, num_layers: int):
        super().__init__()
        self.gru = nn.GRU(input_features, hidden_features, num_layers=num_layers,
                          batch_first=True, bidirectional=True)

    def forward(self, x):
        return self.gru(x)[0]


class E2E0(nn.Module):
    def __init__(self, n_blocks: int = 4, n_gru: int = 1, kernel_size=(2, 2),
                 en_de_layers: int = 5, inter_layers: int = 4, in_channels: int = 1,
                 en_out_channels: int = 16):
        super().__init__()
        if n_gru < 1:
            raise NotImplementedError("E2E0 without its GRU (n_gru=0): the JAX package has none")
        self.unet = DeepUnet0(kernel_size, n_blocks, en_de_layers, inter_layers, in_channels,
                              en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256, n_gru), nn.Linear(512, N_CLASS),
                                Dropout(0.25), nn.Sigmoid())

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] log-mel (T a multiple of 32) -> salience [B, T, N_CLASS]."""
        x = self.cnn(self.unet(mel[:, None]))  # [B, 3, T, M]
        x = x.transpose(1, 2).flatten(-2)  # [B, T, 3 * M], channel-major
        return self.fc(x)


def rmvpe_checkpoint(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference E2E0 state dict without the dead ``TimbreFilter`` keys."""
    return {k: v for k, v in sd.items() if not k.startswith("unet.tf.")}


def _local_average(hidden: np.ndarray, center: np.ndarray, thred: float) -> np.ndarray:
    idx = np.arange(N_CLASS)[None, :]
    idx_cents = idx * 20 + CONST
    start = np.clip(center - 4, 0, None)
    end = np.clip(center + 5, None, N_CLASS)
    weights = hidden * ((idx >= start) & (idx < end))
    product_sum = np.sum(weights * idx_cents, axis=1)
    weight_sum = np.sum(weights, axis=1)
    cents = product_sum / (weight_sum + (weight_sum == 0))
    f0 = 10 * 2 ** (cents / 1200)
    uv = hidden.max(axis=1) < thred
    return (f0 * ~uv).astype(np.float32)


def to_local_average_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """Salience [T, N_CLASS] -> f0 [T] Hz: the weighted mean of the cents of
    the 9 bins around each frame's peak; 0 where the peak is below ``thred``."""
    return _local_average(hidden, np.argmax(hidden, axis=1, keepdims=True), thred)


def to_viterbi_f0(hidden: np.ndarray, thred: float = 0.03) -> np.ndarray:
    """Viterbi path over the 360 bins (transitions within 30 bins, weighted
    ``30 - |i - j|``), then the local average around the path."""
    xx, yy = np.meshgrid(range(N_CLASS), range(N_CLASS))
    transition = np.maximum(30 - np.abs(xx - yy), 0).astype(np.float64)
    transition = transition / transition.sum(axis=1, keepdims=True)
    log_trans = np.log(np.maximum(transition, 1e-12))
    prob = hidden.T.astype(np.float64)
    prob = prob / np.maximum(prob.sum(axis=0, keepdims=True), 1e-12)
    log_prob = np.log(np.maximum(prob, 1e-12))  # [N, T]
    n, t = log_prob.shape
    dp = np.full((t, n), -np.inf)
    back = np.zeros((t, n), np.int64)
    dp[0] = np.log(1.0 / n) + log_prob[:, 0]
    for i in range(1, t):
        scores = dp[i - 1][:, None] + log_trans  # [from, to]
        back[i] = scores.argmax(axis=0)
        dp[i] = scores.max(axis=0) + log_prob[:, i]
    path = np.zeros(t, np.int64)
    path[-1] = dp[-1].argmax()
    for i in range(t - 2, -1, -1):
        path[i] = back[i + 1][path[i + 1]]
    return _local_average(hidden, path[:, None], thred)
