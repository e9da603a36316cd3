"""Binarizer helpers (the port's copy of parts of
``prodiff_tpu/binarize/utils.py``): the map builders, which write the same
JSON files as the JAX package, and the half-sine curve smoother. The signal
features (mel, energy, voicing, breath, tension, the k-th harmonic) land
with the data-pipeline slice."""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder


def build_phone_encoder(data_dir: str, dictionary: dict,
                        languages) -> Tuple[Dict[str, str], TokenTextEncoder]:
    """Per-language phonemes (``{ph}/{lang}``) merged across languages
    through ``dictionary["global"]`` (a CSV) where it exists; writes
    ``phone_set.json`` (the ph/lang -> phoneme map)."""
    ph2global = {}
    if dictionary.get("global", None) and os.path.exists(dictionary["global"]):
        with open(dictionary["global"]) as f:
            for label in csv.DictReader(f):
                for lang, ph in label.items():
                    if lang != "global":
                        ph2global[f"{ph}/{lang}"] = label["global"]
    ph_map = {}
    for lang in languages:
        if lang == "global":
            continue
        ph_map[f"AP/{lang}"] = "AP"
        ph_map[f"SP/{lang}"] = "SP"
        with open(dictionary[lang]["phoneme"]) as f:
            for x in f.readlines():
                ph = x.split("\n")[0].split(" ")[0] + f"/{lang}"
                ph_map[ph] = ph2global.get(ph, ph)
    with open(f"{data_dir}/phone_set.json", "w") as f:
        json.dump(ph_map, f)
    return ph_map, TokenTextEncoder(sorted(set(ph_map.values())), replace_oov="SP")


def build_lang_map(data_dir: str, languages) -> Dict[str, int]:
    """``lang_map.json``: languages numbered from 1 (0 is the padding)."""
    lang_map = {lang: i for i, lang in enumerate(languages, 1)}
    with open(f"{data_dir}/lang_map.json", "w") as f:
        json.dump(lang_map, f)
    return lang_map


def build_spk_map(data_dir: str, datasets: List[dict]) -> Dict[str, int]:
    """``spk_map.json``: each dataset's speaker, numbered from 0."""
    spk_map = {ds["speaker"]: i for i, ds in enumerate(datasets)}
    with open(f"{data_dir}/spk_map.json", "w") as f:
        json.dump(spk_map, f)
    return spk_map


def build_ph_category_encoder(data_dir: str, dictionary: dict,
                              languages) -> Tuple[Dict[str, Dict], TokenTextEncoder]:
    """Phoneme -> articulatory category per language (the third column of
    the phoneme dictionary, ``a vowel vowel``), for the pitch predictor;
    writes ``ph_category_list.json``."""
    ph2category: Dict[str, Dict] = {}
    ph_category_set = {"AP", "SP"}
    for lang in languages:
        ph2category[lang] = {"AP": "AP", "SP": "SP"}
        with open(dictionary[lang]["phoneme"]) as f:
            for x in f.readlines():
                line = x.split("\n")[0].split(" ")
                ph2category[lang][line[0]] = line[2]
                ph_category_set.add(line[2])
    ph_category_list = sorted(ph_category_set)
    with open(f"{data_dir}/ph_category_list.json", "w") as f:
        json.dump(ph_category_list, f)
    return ph2category, TokenTextEncoder(ph_category_list, replace_oov="SP")


def sinusoidal_smooth(curve: np.ndarray, kernel_size: int) -> np.ndarray:
    """Half-sine smoothing kernel with replicate padding (the reference's
    ``SinusoidalSmoothingConv1d``)."""
    if len(curve) == 0:
        return np.asarray(curve, np.float32)
    kernel = np.sin(np.linspace(0, 1, kernel_size) * np.pi)
    kernel /= kernel.sum()
    lpad = (kernel_size - 1) // 2
    rpad = kernel_size - 1 - lpad
    padded = np.concatenate([np.full(lpad, curve[0]), curve, np.full(rpad, curve[-1])])
    # torch conv = correlation; the kernel is symmetric anyway
    return np.convolve(padded, kernel[::-1], mode="valid").astype(np.float32)
