"""The duration-predictor binarizer (port of
``prodiff_tpu/binarize/dur_predictor.py``): each item's phonemes, their
durations (s), the word-onset indicators from ``ph_num`` and each word's
duration gathered back to its phonemes."""

from __future__ import annotations

import json

import numpy as np

from prodiff_tpu_torch.binarize import Binarizer, register_binarizer
from prodiff_tpu_torch.binarize.utils import build_phone_encoder


def ph_num_to_ph2word(ph_num: np.ndarray) -> np.ndarray:
    """[T_w] phoneme counts -> [T_ph] 1-indexed word of each phoneme."""
    return np.repeat(np.arange(1, len(ph_num) + 1), ph_num)


@register_binarizer
class DurPredictorBinarizer(Binarizer):
    def __init__(self, hparams: dict, device=None):
        super().__init__(hparams, device)
        self.ph_map, self.ph_encoder = build_phone_encoder(
            self.data_dir, hparams["dictionary"], hparams["languages"])

    @staticmethod
    def category():
        return "dur"

    def load_meta_data(self) -> list:
        items = []
        for dataset in self.datasets:
            data_dir, lang = dataset["data_dir"], dataset["language"]
            with open(f"{data_dir}/label.json", encoding="utf-8") as f:
                labels = json.load(f)
            for item_name, label in labels.items():
                ph_text = [self.ph_map[f"{p}/{lang}"] for p in label["ph_seq"].split(" ")]
                items.append({
                    "item_name": item_name,
                    "ph_seq": self.ph_encoder.encode(ph_text),
                    "ph_dur": [float(x) for x in label["ph_dur"].split(" ")],
                    "ph_num": [int(x) for x in label["ph_num"].split(" ")],
                })
        return items

    def process_item(self, item: dict) -> dict:
        ph_num = np.asarray(item["ph_num"], np.int64)
        ph2word = ph_num_to_ph2word(ph_num)
        onset = np.diff(ph2word, prepend=0)
        ph_dur = np.asarray(item["ph_dur"], np.float32)
        word_dur = np.zeros(len(ph_num) + 1, np.float32)
        np.add.at(word_dur, ph2word, ph_dur)
        return {
            "ph_seq": np.asarray(item["ph_seq"], np.int64),
            "ph_dur": ph_dur,
            "word_dur": word_dur[ph2word],
            "onset": onset.astype(np.int64),
            "length": len(item["ph_seq"]),
        }
