"""Tiny configurations and mixes for the benchmark's CPU tests: the cells'
structure (encoder, WaveNet, sampler, NSF-HiFiGAN, training step) at widths
a test run holds."""

from __future__ import annotations

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

LIMITS = {"batching": 0.0, "mel_gap": 1e-4, "wav_gap": 1e-4, "batch_gap": 0.0,
          "loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}


def config(reflow: bool = False) -> dict:
    with open(os.path.join(BENCH, "configs", "svs-prodiff4-nsf44k.json")) as f:
        cfg = json.load(f)
    cfg["hparams"].update(
        hidden_size=32, residual_channels=16, residual_layers=2, enc_layers=1,
        audio_num_mel_bins=8, hop_size=16, audio_sample_rate=1000, max_tokens=512,
        max_sentences=8, batch_size_buckets=[1, 2, 4, 8], length_bucket_step=32,
        max_frames=128, infer_batch_size=4)
    if reflow:
        cfg["hparams"].update(diff_type="reflow", sampling_steps=3)
    cfg["vocoder"].update(num_mels=8, sampling_rate=1000, upsample_initial_channel=16,
                          upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8])
    cfg["name"] = "tiny-reflow" if reflow else "tiny"
    return cfg


def mix(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        m = json.load(f)
    if m["driver"] == "render":
        # 6 phrases a song, 2 s on average
        m.update(source_songs=1, source_utterances=6, source_hours=12 / 3600, songs_in_setup=3,
                 length_max_s=4.0)
    else:
        # items of 1.6 s on average, at most the tiny config's 128 frames
        m.update(items=40, source_hours=40 * 1.6 / 3600, source_utterances=40, length_max_s=2.0,
                 phoneme_s=0.16, frame_s=0.016, f0_timestep=0.016)
    return m


def driver(mix_name: str, seed: int = 5, reflow: bool = False):
    import torch

    import harness

    m = mix(mix_name)
    return harness.driver_module(m["driver"]).DRIVER(config(reflow), m, seed, [torch.device("cpu")],
                                                     copy.deepcopy(LIMITS))
