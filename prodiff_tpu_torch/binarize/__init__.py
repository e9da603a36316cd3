"""Binarizers: labelled audio -> indexed training shards (port of
``prodiff_tpu/binarize/__init__.py``).

The registry and handler mirror the reference
(``component/binarizer/base.py``, ``handler/binarize/handler.py``): items
split into valid / test / train by slices of the item list, each item
processed by the task's binarizer, written with
``utils/indexed_datasets.py``'s builder, with the sidecars the JAX package
writes: ``{prefix}_lengths.npy``, ``{prefix}_item_lengths.npz`` (each key's
leading length per item) and ``{prefix}_f0s_mean_std.npy``. The tasks:
``svs`` and ``svs_rectified`` (``svs.py``), ``vari`` (``vari_predictor.py``),
``dur`` and ``pitch``. The module also keeps the helpers that inference uses
(``utils.py``, ``pitch_predictor.py:base_pitch_curve``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from prodiff_tpu_torch.utils.indexed_datasets import IndexedDatasetBuilder

BINARIZERS: Dict[str, type] = {}


def register_binarizer(cls):
    BINARIZERS[cls.category()] = cls
    return cls


def get_binarizer_cls(task: str):
    from prodiff_tpu_torch.binarize import (dur_predictor, pitch_predictor, svs,  # noqa: F401
                                            vari_predictor)

    if task not in BINARIZERS:
        raise ValueError(f"Binarizer {task} not found in {sorted(BINARIZERS)}")
    return BINARIZERS[task]


class Binarizer:
    def __init__(self, hparams: dict, device=None):
        """``device``: where the feature extractors with a device part run
        (the pitch extractor, the mel, the VR split, the k-th harmonic, the
        distillation teacher)."""
        self.hparams = hparams
        self.datasets: List[dict] = hparams["datasets"]
        self.data_dir = os.path.join(hparams["data_dir"], self.category())
        os.makedirs(self.data_dir, exist_ok=True)

    def load_meta_data(self) -> list:
        raise NotImplementedError

    def process_item(self, item: dict) -> dict:
        raise NotImplementedError

    @staticmethod
    def category() -> str:
        raise NotImplementedError


class BinarizeHandler:
    def __init__(self, hparams: dict, device=None):
        self.hparams = hparams
        self.binarizer: Binarizer = get_binarizer_cls(hparams["task"])(hparams, device=device)
        self.binary_data_dir = self.binarizer.data_dir
        self.transcription_item_list = self.binarizer.load_meta_data()

    def get_transcription_item_list(self, prefix: str):
        """valid: the first ``test_num + valid_num`` items; test: the first
        ``test_num``; train: the rest."""
        hp, n = self.hparams, len(self.transcription_item_list)
        if prefix == "valid":
            idxs = range(0, min(hp["test_num"] + hp["valid_num"], n))
        elif prefix == "test":
            idxs = range(0, min(hp["test_num"], n))
        else:
            idxs = range(min(hp["test_num"] + hp["valid_num"], n), n)
        for i in idxs:
            yield self.transcription_item_list[i]

    def process_data(self, prefix: str) -> None:
        data_dir = self.binary_data_dir
        builder = IndexedDatasetBuilder(
            data_dir, prefix, segment_size=self.hparams.get("idx_ds_segment_size", 1024))
        lengths, f0s, total_sec = [], [], 0.0
        item_lengths: Dict[str, list] = {}
        for item in self.get_transcription_item_list(prefix):
            processed = self.binarizer.process_item(item)
            builder.add_item(processed)
            total_sec += processed.get("sec", 0)
            if "length" not in processed:
                raise ValueError("a binarized item must carry 'length'")
            lengths.append(processed["length"])
            if "f0" in processed:
                f0s.append(processed["f0"])
            for k, v in processed.items():
                arr = np.asarray(v)
                if arr.ndim >= 1:
                    item_lengths.setdefault(k, []).append(arr.shape[0])
        builder.finalize()
        if lengths:
            np.save(f"{data_dir}/{prefix}_lengths.npy", lengths)
            full = {k: np.asarray(v, np.int64) for k, v in item_lengths.items()
                    if len(v) == len(lengths)}
            if full:
                np.savez(f"{data_dir}/{prefix}_item_lengths.npz", **full)
        if f0s:
            f0s = np.concatenate(f0s, 0)
            f0s = f0s[f0s != 0]
            np.save(f"{data_dir}/{prefix}_f0s_mean_std.npy",
                    [np.mean(f0s).item(), np.std(f0s).item()])
        print(f"| binarize {prefix}: {len(lengths)} items"
              + (f", {total_sec:.3f} s" if total_sec > 0 else ""))

    def handle(self) -> None:
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)
