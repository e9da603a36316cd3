"""Base train task (port of ``prodiff_tpu/tasks/base.py``): owns the model
definition, the datasets and the loss.

A task exposes ``build_model()`` (an ``nn.Module``), ``compute_losses(model,
batch, generator, ...)`` (a dict of scalar tensors whose sum is the loss, as
the reference sums every loss term, ``base_task.py:202-229``), its weight
carrier (``weight_carrier``: a port state dict -> the JAX package's param
tree, the checkpoints' format, and back; ``params_tree``/``load_params_tree``
on a model, ``carrier()`` on any name -> tensor map such as the optimizer's
moments), ``validation_plots`` (host-side figures of the first validation
batch; none here) and the train and validation batch iterators.

The plots import matplotlib when they draw: where it does not import they
log once and draw nothing (the JAX package raises), as ``MetricsWriter``
does without TensorBoard.
"""

from __future__ import annotations

import json
import logging
import os

import torch

from prodiff_tpu_torch.data.dataset import BaseDataset, BatchIterator
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder

log = logging.getLogger("prodiff_tpu_torch.tasks")
_PYPLOT = []  # [matplotlib.pyplot or None], resolved once


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None (logged once) where
    matplotlib does not import."""
    if not _PYPLOT:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            log.warning("| validation plots off: matplotlib does not import (%s)", e)
            plt = None
        _PYPLOT.append(plt)
    return _PYPLOT[0]


def save_figure(plt, fig, out_dir: str, name: str, tag: str, step: int, writer) -> None:
    """``{out_dir}/{name}_step{step}.png`` and, with a writer, a TensorBoard
    figure ``tag``."""
    fig.savefig(os.path.join(out_dir, f"{name}_step{step}.png"))
    if writer is not None:
        writer.add_figure(tag, fig, step)
    plt.close(fig)


def plot_generator(hparams: dict, step: int, device) -> torch.Generator:
    """The validation plots' draws, seeded from (seed, step)."""
    return torch.Generator(device).manual_seed(hparams.get("seed", 1234) * 2 ** 32 + step)


def plot_curves(curves, hparams: dict, step: int, out_dir, writer=None) -> None:
    """``{name}_{i}_step{step}.png`` (TensorBoard ``{name}_val_{i}``): each
    curve's ground truth and prediction over the first ``num_valid_plots``
    items; ``curves`` maps a name to (gt, pred), numpy ``[B, T]`` each."""
    plt = pyplot() if out_dir is not None else None
    if plt is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    for name, (gt, pred) in curves.items():
        for i in range(min(hparams.get("num_valid_plots", 10), len(gt))):
            fig = plt.figure(figsize=(12, 4))
            plt.plot(gt[i], label="gt")
            plt.plot(pred[i], label="pred")
            plt.legend()
            save_figure(plt, fig, out_dir, f"{name}_{i}", f"{name}_val_{i}", step, writer)


class BaseTask:
    dataset_cls = None
    # (port state dict, hparams) -> JAX param tree {"params": ...}, and the inverse
    weight_carrier = None
    # where the model trains, set by the trainer before build_model: it
    # decides the bf16 policy of ``bf16: null`` (device.resolve_train_bf16)
    device = None
    # the model axis (parallel.megatron.TensorParallel) at model_parallel > 1,
    # set by the trainer: the teacher's encoder and WaveNet split over it
    tp = None

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

    def flax_tree(self, state_dict) -> dict:
        return self.weight_carrier[0](state_dict, self.hparams)

    def state_dict_of(self, tree: dict) -> dict:
        return self.weight_carrier[1](tree, self.hparams)

    def carrier(self):
        """(name -> tensor map -> param tree, the inverse): the optimizer's."""
        return self.flax_tree, self.state_dict_of

    def params_tree(self, model) -> dict:
        """The model's weights as the JAX package's param tree (checkpoints)."""
        return self.flax_tree(model.state_dict())

    def load_params_tree(self, model, tree: dict) -> None:
        model.load_state_dict(self.state_dict_of(tree))

    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        """Figures of the first validation batch under ``out_dir`` (and in
        ``writer``'s TensorBoard); none for this task."""

    def train_iterator(self, n_devices: int = 1, local_block=None) -> BatchIterator:
        """Global batches of ``max_tokens`` a device, their rows a multiple of
        ``n_devices``; ``local_block`` as ``BatchIterator``'s."""
        ds: BaseDataset = self.dataset_cls(
            prefix=self.hparams.get("train_set_name", "train"), shuffle=True,
            hparams=self.hparams)
        return BatchIterator(ds, max_tokens=self.max_tokens * n_devices,
                             max_sentences=self.max_sentences,
                             required_batch_size_multiple=n_devices, local_block=local_block)

    def val_iterator(self, n_devices: int = 1, local_block=None) -> BatchIterator:
        ds: BaseDataset = self.dataset_cls(
            prefix=self.hparams.get("valid_set_name", "valid"), shuffle=False,
            hparams=self.hparams)
        return BatchIterator(ds, max_tokens=self.max_valid_tokens,
                             max_sentences=self.max_valid_sentences,
                             required_batch_size_multiple=n_devices, local_block=local_block)
