"""Vocoder registry (port of ``prodiff_tpu/vocoders/__init__.py``)."""

from __future__ import annotations

VOCODERS = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    return cls


def get_vocoder_cls(name: str):
    from prodiff_tpu_torch.vocoders import fastdiff, hifigan, nsf_hifigan  # noqa: F401

    if name.lower() not in VOCODERS:
        raise ValueError(f"Vocoder {name} not found in {sorted(VOCODERS)}")
    return VOCODERS[name.lower()]


class BaseVocoder:
    def __init__(self, hparams: dict):
        self.hparams = hparams

    def spec2wav(self, mel, **kwargs):
        """mel [T, M] log10-mel -> wav [T'] (numpy)"""
        raise NotImplementedError

    def spec2wav_batch(self, mel, f0, **kwargs):
        """mel [B, T, M] log10-mel -> wav [B, T']"""
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn: str, hparams: dict, keyshift=0, speed=1, device=None):
        """A wav file -> (wav [L] numpy, log10-mel [T, M] numpy)"""
        raise NotImplementedError
