"""The one traffic generator: songs of phrases for the render cells and a
binarized corpus for the training cell, both drawn from a mix's parameters
(``traffic/<mix>.json``) and the run's seed.

Sizes follow a public corpus's published statistics, where the mix names
them (``source``: songs, utterances and hours): a song has the corpus's
mean number of phrases, and phrase and item lengths are lognormal with the
corpus's mean length, their spread (``length_sigma``) and clip set by the
mix and listed under its ``assumed``.

Every seed gives the same work in another order and with other content:
the sizes (phrase lengths and phoneme counts, corpus item lengths) come from
a generator seeded with the mix's ``shape_seed``, the run's seed draws the
phonemes, durations, melodies, mels and the order. So runs with different
seeds read alike, and a change to the program is not hidden by a change in
the work."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

PHONES = ["SP", "AP"] + [f"p{i}" for i in range(60)]


def phone_set(language: str) -> Dict[str, str]:
    return {f"{p}/{language}": p for p in PHONES}


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % 2 ** 63 for k in keys])


def phrases_per_song(mix: dict) -> int:
    """The source's utterances a song, rounded."""
    return int(round(mix["source_utterances"] / mix["source_songs"]))


def mean_length_s(mix: dict) -> float:
    """The source's mean utterance length in seconds."""
    return mix["source_hours"] * 3600.0 / mix["source_utterances"]


def lengths_s(mix: dict, n: int, *keys: int) -> np.ndarray:
    """``n`` lengths in seconds, lognormal with the source's mean and the
    mix's ``length_sigma``, clipped to ``length_min_s``-``length_max_s``;
    drawn from ``keys`` alone, so the same for every run seed."""
    sigma = mix["length_sigma"]
    median = mean_length_s(mix) * np.exp(-sigma ** 2 / 2)
    z = _rng(mix["shape_seed"], *keys).standard_normal(n)
    return np.clip(median * np.exp(sigma * z), mix["length_min_s"], mix["length_max_s"])


def phrase_lengths(mix: dict, song: int) -> np.ndarray:
    """Seconds of each phrase of song ``song``; the same for every run seed."""
    return lengths_s(mix, phrases_per_song(mix), song)


def phonemes_in(mix: dict, seconds: float) -> int:
    return max(3, int(round(seconds / mix["phoneme_s"])))


def melody(mix: dict, rng: np.random.Generator, seconds: float) -> np.ndarray:
    """f0 in Hz every ``f0_timestep`` over ``seconds`` (and one step past):
    held notes of ``note_s`` seconds between ``midi_min`` and ``midi_max``,
    with vibrato."""
    step = mix["f0_timestep"]
    n = int(np.ceil(seconds / step)) + 2
    t = np.arange(n) * step
    midi = np.empty(n)
    start = 0.0
    while start < t[-1] + step:
        end = start + rng.uniform(*mix["note_s"])
        midi[(t >= start) & (t < end)] = rng.integers(mix["midi_min"], mix["midi_max"] + 1)
        start = end
    vib = mix["vibrato_semitones"] * np.sin(2 * np.pi * mix["vibrato_hz"] * t
                                            + rng.uniform(0, 2 * np.pi))
    return 440.0 * 2 ** ((midi + vib - 69) / 12)


def song(mix: dict, seed: int, index: int) -> List[dict]:
    """Song ``index`` of the run seeded ``seed``: ``phrases_per_song`` phrases
    as a ``.ds`` project holds them (phoneme names and durations in seconds,
    an f0 curve, language, speaker mix), in a seeded order."""
    rng = _rng(seed, index)
    lengths = phrase_lengths(mix, index)
    phrases = []
    for seconds in lengths[rng.permutation(len(lengths))]:
        n_ph = phonemes_in(mix, seconds)
        dur = rng.uniform(1 - mix["phoneme_jitter"], 1 + mix["phoneme_jitter"], n_ph)
        dur = dur / dur.sum() * seconds
        names = ["SP"] + [PHONES[2 + int(i)] for i in rng.integers(0, 60, n_ph - 2)] + ["SP"]
        phrases.append({
            "ph_seq": " ".join(names),
            "ph_dur": " ".join(repr(float(d)) for d in dur),
            "f0_seq": " ".join(f"{f:.3f}" for f in melody(mix, rng, seconds)),
            "f0_timestep": repr(float(mix["f0_timestep"])),
            "lang": mix["language"],
            "spk_name": mix["speaker_mix"],
            "keyshift": 0,
            "gender": 0.0,
        })
    return phrases


def corpus_shapes(mix: dict) -> np.ndarray:
    """(frames, phonemes) of each corpus item, its length drawn as a
    phrase's; the same for every run seed."""
    frames = np.round(lengths_s(mix, mix["items"]) / mix["frame_s"]).astype(np.int64)
    phonemes = [phonemes_in(mix, f * mix["frame_s"]) for f in frames]
    return np.stack([frames, phonemes], 1).astype(np.int64)


def corpus_items(mix: dict, seed: int, n_mels: int, n_vocab: int, n_spk: int,
                 device="cpu") -> List[dict]:
    """The corpus as binarized items (phoneme ids, frame-to-phoneme map, f0,
    mel, voicing, breath, speaker, language), its mels drawn in one call on
    ``device``."""
    import torch

    rng = _rng(seed)
    shapes = corpus_shapes(mix)
    gen = torch.Generator(device).manual_seed(int(seed) % 2 ** 63)
    mels = (torch.randn((int(shapes[:, 0].sum()), n_mels), generator=gen, device=device) * 2 - 6
            ).cpu().numpy()
    items, row = [], 0
    for t_mel, t_ph in shapes:
        cuts = np.sort(rng.choice(np.arange(1, t_mel), t_ph - 1, replace=False))
        mel2ph = np.repeat(np.arange(1, t_ph + 1), np.diff(np.concatenate([[0], cuts, [t_mel]])))
        f0 = melody(mix, rng, t_mel * mix["frame_s"])[:t_mel]
        items.append({
            "ph_seq": rng.integers(3, n_vocab, t_ph).astype(np.int64),
            "mel2ph": mel2ph.astype(np.int64),
            "f0": f0.astype(np.float32),
            "mel": mels[row:row + t_mel],
            "voicing": rng.uniform(-60, -12, t_mel).astype(np.float32),
            "breath": rng.uniform(-90, -30, t_mel).astype(np.float32),
            "spk_id": int(rng.integers(0, n_spk)),
            "lang_seq": np.ones(t_ph, np.int64),
        })
        row += t_mel
    return items


def write_corpus(task_dir: str, items: List[dict], maps: Dict[str, dict], builder_cls) -> None:
    """The binarizer's layout: the maps, ``train`` shards through
    ``builder_cls`` (the program's item store), lengths and the item-lengths
    sidecar; one item of it as the ``valid`` set."""
    os.makedirs(task_dir, exist_ok=True)
    for name, data in maps.items():
        with open(os.path.join(task_dir, f"{name}.json"), "w") as f:
            json.dump(data, f)
    for prefix, subset in (("train", items), ("valid", items[:1])):
        builder = builder_cls(task_dir, prefix, segment_size=1024)
        for item in subset:
            builder.add_item(item)
        builder.finalize()
        np.save(os.path.join(task_dir, f"{prefix}_lengths.npy"),
                np.array([len(it["mel"]) for it in subset]))
        keys = [k for k, v in subset[0].items() if np.ndim(v) >= 1]
        np.savez(os.path.join(task_dir, f"{prefix}_item_lengths.npz"),
                 **{k: np.array([len(it[k]) for it in subset], np.int64) for k in keys})
