"""Base train task (port of ``prodiff_tpu/tasks/base.py``): owns the model
definition, the datasets and the loss.

A task exposes ``build_model()`` (an ``nn.Module``), ``compute_losses(model,
batch, generator, ...)`` (a dict of scalar tensors whose sum is the loss, as
the reference sums every loss term, ``base_task.py:202-229``),
``params_tree``/``load_params_tree`` (the weights as the JAX package's param
tree, the checkpoints' format) and the train and validation batch
iterators.
"""

from __future__ import annotations

import json
import os

from prodiff_tpu_torch.data.dataset import BaseDataset, BatchIterator
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder


class BaseTask:
    dataset_cls = None

    def __init__(self, hparams: dict):
        self.hparams = hparams
        self.data_dir = os.path.join(hparams["data_dir"], hparams["task"])
        self.max_tokens = hparams["max_tokens"]
        self.max_sentences = hparams["max_sentences"]
        self.max_valid_tokens = hparams.get("max_valid_tokens", -1)
        if self.max_valid_tokens == -1:
            self.max_valid_tokens = self.max_tokens
        self.max_valid_sentences = hparams.get("max_valid_sentences", -1)
        if self.max_valid_sentences == -1:
            self.max_valid_sentences = self.max_sentences
        self.model = None

    def build_phone_encoder(self) -> TokenTextEncoder:
        with open(os.path.join(self.data_dir, "phone_set.json")) as f:
            self.ph_map = json.load(f)
        self.ph_encoder = TokenTextEncoder(sorted(set(self.ph_map.values())), replace_oov="SP")
        return self.ph_encoder

    def build_model(self):
        raise NotImplementedError

    def compute_losses(self, model, batch, generator=None, **kwargs):
        raise NotImplementedError

    def validation_plots(self, *args, **kwargs):
        raise NotImplementedError(
            "validation plots (matplotlib figures) land with the serving-extras slice")

    def train_iterator(self) -> BatchIterator:
        ds: BaseDataset = self.dataset_cls(
            prefix=self.hparams.get("train_set_name", "train"), shuffle=True,
            hparams=self.hparams)
        return BatchIterator(ds, max_tokens=self.max_tokens, max_sentences=self.max_sentences)

    def val_iterator(self) -> BatchIterator:
        ds: BaseDataset = self.dataset_cls(
            prefix=self.hparams.get("valid_set_name", "valid"), shuffle=False,
            hparams=self.hparams)
        return BatchIterator(ds, max_tokens=self.max_valid_tokens,
                             max_sentences=self.max_valid_sentences)
