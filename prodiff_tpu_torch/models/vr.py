"""VR, the harmonic/aperiodic separator (port of ``prodiff_tpu/models/vr.py``).

``CascadedNet``: three stages of band-split U-Nets (``BaseNet``: a strided
conv encoder, an ASPP bottleneck, bilinear-upsampling decoders and a
bidirectional-LSTM branch), predicting a bounded complex mask
``tanh(|m|) * m / |m|`` over the STFT. The complex spectrum is carried as two
real channels (real | imag), as the JAX module and the reference's network
boundary do. Inference only: the BatchNorms run in eval mode. Module and
parameter names are the reference's torch ones (``modules/vr/nets.py``,
``layers.py``), so a released checkpoint loads with ``load_state_dict`` and
``prodiff_tpu.models.vr.convert_vr`` takes this module's ``state_dict()``
unchanged.

The ASPP's dilated convs take the scalar dilations the JAX module uses (the
first of each ``dilations`` pair, on both axes), so the port computes what
the JAX package computes.

:class:`SeparationModel` is the wav -> harmonic-part wrapper: the wav padded
to a multiple of 32 frames, :func:`stft_complex` -> mask -> :func:`istft`
on its device. :func:`load_sep_model` reads the checkpoint and the
``config.yaml`` beside it (``n_fft``, ``hop_length``, ``n_out``,
``n_out_lstm``, ``is_mono``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.ops.stft_extras import istft, stft_complex


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to ``out_hw`` with aligned corners."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


class Conv2DBNActiv(nn.Module):
    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1, pad: int = 1,
                 dilation: int = 1, activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(nout),
            nn.ReLU() if activ == "relu" else nn.LeakyReLU(0.01),
        )

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 2, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, 1, 1, activ="leaky")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class Decoder(nn.Module):
    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x, skip=None):
        x = resize_bilinear_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))
        if skip is not None:
            if skip.shape[3] > x.shape[3]:  # centre-crop the skip's time axis
                s = (skip.shape[3] - x.shape[3]) // 2
                skip = skip[..., s:s + x.shape[3]]
            x = torch.cat([x, skip], dim=1)
        return self.conv1(x)


class ASPPModule(nn.Module):
    def __init__(self, nin: int, nout: int, dilations=(4, 8, 12)):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0])
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1])
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2])
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0)

    def forward(self, x):
        feat1 = self.conv1(x).expand(-1, -1, x.shape[2], -1)  # the band mean, broadcast
        out = torch.cat([feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1)
        return self.bottleneck(out)


class LSTMModule(nn.Module):
    def __init__(self, nin_conv: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(nin_lstm, nout_lstm // 2, batch_first=True, bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm), nn.BatchNorm1d(nin_lstm),
                                   nn.ReLU())

    def forward(self, x):
        """x [B, C, F, T] -> [B, 1, F(=nin_lstm), T]."""
        h = self.conv(x)[:, 0].transpose(1, 2)  # [B, T, F]
        h = self.lstm(h)[0]  # [B, T, nout_lstm]
        b, t, _ = h.shape
        h = self.dense(h.reshape(b * t, -1)).reshape(b, t, -1)
        return h.transpose(1, 2)[:, None]


class BaseNet(nn.Module):
    def __init__(self, nin: int, nout: int, nin_lstm: int, nout_lstm: int,
                 dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = Encoder(nout, nout * 2)
        self.enc3 = Encoder(nout * 2, nout * 4)
        self.enc4 = Encoder(nout * 4, nout * 6)
        self.enc5 = Encoder(nout * 6, nout * 8)
        self.aspp = ASPPModule(nout * 8, nout * 8, tuple(d[0] for d in dilations))
        self.dec4 = Decoder(nout * (6 + 8), nout * 6)
        self.dec3 = Decoder(nout * (4 + 6), nout * 4)
        self.dec2 = Decoder(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = Decoder(nout * (1 + 2) + 1, nout)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.dec2(self.dec3(self.dec4(self.aspp(e5), e4), e3), e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    def __init__(self, n_fft: int, hop_length: int, nout: int = 32, nout_lstm: int = 128,
                 is_mono: bool = True):
        super().__init__()
        # mono, as in the JAX package (``is_mono`` is kept for the config's
        # sake; a stereo checkpoint's 4-channel convs do not load)
        self.is_mono = is_mono
        self.n_fft, self.hop_length = n_fft, hop_length
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.nin_lstm = self.max_bin // 2
        nin = 2  # real | imag
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(nin, nout // 2, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(nin, nout // 4, self.nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + nin, nout, self.nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + nin, nout // 2, self.nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + nin, nout, self.nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, nin, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 2, F, T] (real | imag, F = n_fft//2 + 1, T a multiple of 32)
        -> the bounded complex mask, same shape; the top bin replicated."""
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        mask = self.out(self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1)))
        mag = torch.sqrt(torch.sum(mask ** 2, dim=1, keepdim=True))
        mask = torch.tanh(mag) * mask / (mag + 1e-8)
        return F.pad(mask, (0, 0, 0, self.output_bin - mask.shape[2]), mode="replicate")


class SeparationModel:
    """wav -> harmonic part by masked STFT resynthesis on ``device`` (the
    reference's ``CascadedNet.predict_from_audio``)."""

    def __init__(self, model: CascadedNet, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_fft, self.hop_length = model.n_fft, model.hop_length
        n = np.arange(self.n_fft)
        self.window = torch.from_numpy(
            (0.5 - 0.5 * np.cos(2 * np.pi * n / self.n_fft)).astype(np.float32)).to(self.device)

    @torch.no_grad()
    def separate(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, L] (L + n_fft's centre padding a whole number of 32-frame
        blocks) -> harmonic part [B, L] on the device."""
        spec = stft_complex(wav, self.window, self.n_fft, self.hop_length)  # [B, F, T]
        mask = self.model(torch.stack([spec.real, spec.imag], dim=1))
        masked = torch.complex(mask[:, 0], mask[:, 1]) * spec
        return istft(masked, self.window, self.n_fft, self.hop_length, wav.shape[1])

    def predict_from_audio(self, waveform: np.ndarray) -> np.ndarray:
        """waveform [T] -> harmonic part [T] (host numpy)."""
        x = np.asarray(waveform, np.float32)
        n, hop = len(x), self.hop_length
        n_frames = n // hop + 1
        t_pad = (32 * (n_frames // 32 + 1) - 1) * hop - n
        tl_pad = t_pad // 2 // hop * hop
        x = np.pad(x, (tl_pad, t_pad - tl_pad))
        out = self.separate(torch.from_numpy(x).to(self.device)[None])[0]
        return out[tl_pad:tl_pad + n].cpu().numpy()


def load_sep_model(model_path: str, device=None) -> SeparationModel:
    """The VR checkpoint (a torch state dict under the reference's names)
    and the ``config.yaml`` beside it -> :class:`SeparationModel`."""
    import yaml

    from prodiff_tpu_torch.utils.convert import load_torch_state_dict

    with open(os.path.join(os.path.dirname(model_path), "config.yaml")) as f:
        args = yaml.safe_load(f)
    model = CascadedNet(args["n_fft"], args["hop_length"], nout=args["n_out"],
                        nout_lstm=args["n_out_lstm"], is_mono=args.get("is_mono", True))
    model.load_state_dict(load_torch_state_dict(model_path))
    return SeparationModel(model, device)
