"""The pitch-predictor train task (port of
``prodiff_tpu/tasks/pitch_predictor.py``): the delta-pitch rectified flow of
``models/pitch_predictor.py`` trained on the logit-normal weighted velocity
loss, with random retake masks (``use_pitch_retake``, default on): a whole
segment a quarter of the time, OR'd with a random span, drawn by the
collater from the dataset's ``numpy`` generator after the shuffle's draws,
as in the JAX package. Its validation plots draw the ground-truth pitch
beside the prediction (base pitch + the sampled delta at ``pitch_expr`` 1),
``pitch_{i}_step{step}.png``."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.collate import collate_1d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
from prodiff_tpu_torch.ops.losses import spec_loss_reflow
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask, plot_curves, plot_generator, pyplot
from prodiff_tpu_torch.utils.convert import pitch_predictor_flax_params, pitch_predictor_state_dict
from prodiff_tpu_torch.utils.pitch_utils import random_continuous_masks
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder


def random_retake_masks(rng: np.random.Generator, b: int, t: int) -> np.ndarray:
    """[b, t] int32: ~1/4 whole segments OR random spans (~1/2 of the frames
    retaken on average)."""
    b_masks = rng.integers(0, 4, size=(b, 1)) == 0
    t_masks = random_continuous_masks(rng, b, t, dim=1)
    return (b_masks | t_masks).astype(np.int32)


def note_batch(samples: List[dict]) -> Dict[str, np.ndarray]:
    """The phoneme and note grids of the pitch and variance datasets:
    notes pad with midi -1 (the note encoder's padding) and rest True."""
    return {
        "nsamples": len(samples),
        "ph_seq": collate_1d([np.asarray(s["ph_seq"], np.int32) for s in samples], 0),
        "mel2ph": collate_1d([np.asarray(s["mel2ph"], np.int32) for s in samples], 0),
        "note_midi": collate_1d([np.asarray(s["note_midi"], np.float32) for s in samples], -1.0),
        "note_rest": collate_1d([np.asarray(s["note_rest"], bool) for s in samples], True),
        "mel2note": collate_1d([np.asarray(s["mel2note"], np.int32) for s in samples], 0),
    }


class PitchPredictorDataset(BaseDataset):
    time_keys = {"ph_seq": 1, "mel2ph": 1, "note_midi": 1, "note_rest": 1, "mel2note": 1,
                 "pitch": 1, "base_pitch": 1, "pitch_retake": 1}
    pad_values = {"note_midi": -1.0, "note_rest": True}
    length_source = {"pitch_retake": "mel2note"}  # a derived mask on the mel axis

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if len(samples) == 0:
            return {}
        batch = note_batch(samples)
        for key in ("pitch", "base_pitch"):
            batch[key] = collate_1d([np.asarray(s[key], np.float32) for s in samples], 0.0)
        if self.hparams.get("use_spk_id", True):
            batch["spk_id"] = np.asarray([s["spk_id"] for s in samples], np.int32)
        if self.hparams.get("use_pitch_retake", True):
            b, t = batch["mel2note"].shape
            batch["pitch_retake"] = random_retake_masks(self._rng, b, t)
        return batch


@register_task("pitch")
class PitchPredictorTask(BaseTask):
    dataset_cls = PitchPredictorDataset
    weight_carrier = (pitch_predictor_flax_params, pitch_predictor_state_dict)

    def __init__(self, hparams):
        super().__init__(hparams)
        self.loss_type = hparams["f0_prediction_args"]["loss_type"]

    def build_phone_category_encoder(self) -> TokenTextEncoder:
        with open(os.path.join(self.data_dir, "ph_category_list.json")) as f:
            self.ph_category_encoder = TokenTextEncoder(json.load(f), replace_oov="SP")
        return self.ph_category_encoder

    def build_model(self) -> PitchPredictor:
        self.build_phone_category_encoder()
        self.model = PitchPredictor(len(self.ph_category_encoder), self.hparams)
        return self.model

    def compute_losses(self, model, batch, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``{"pitch"}``, the velocity loss over the frames with a note;
        ``t``/``noise`` are drawn from ``generator`` where not given."""
        v_pred, v_gt, t = model(batch["ph_seq"], batch["mel2ph"], batch["note_midi"],
                                batch["note_rest"], batch["mel2note"], batch["base_pitch"],
                                batch["pitch"], t=t, noise=noise, generator=generator,
                                pitch_retake=batch.get("pitch_retake"),
                                spk_id=batch.get("spk_id"))
        return spec_loss_reflow(v_pred, v_gt, t, batch["mel2note"] > 0, self.loss_type,
                                log_norm=True, name="pitch")

    def validation_curves(self, model, batch, generator: Optional[torch.Generator] = None,
                          init_noise: Optional[torch.Tensor] = None) -> dict:
        """{"pitch": (gt, pred)}, numpy [B, T_mel] (MIDI): the prediction is
        the base pitch plus the delta sampled at ``pitch_expr`` 1 from
        ``init_noise`` or a draw from ``generator``."""
        b = batch["ph_seq"].shape[0]
        delta = model.infer(batch["ph_seq"], batch["mel2ph"], batch["note_midi"],
                            batch["note_rest"], batch["mel2note"], batch["base_pitch"],
                            init_noise=init_noise, generator=generator,
                            pitch_expr=batch["base_pitch"].new_ones(b, 1),
                            spk_id=batch.get("spk_id"))
        return {"pitch": (batch["pitch"].cpu().numpy(),
                          (batch["base_pitch"] + delta).cpu().numpy())}

    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        if out_dir is None or pyplot() is None:  # no figure: no sampling
            return
        model.eval()
        gen = plot_generator(self.hparams, step, batch["pitch"].device)
        plot_curves(self.validation_curves(model, batch, gen), self.hparams, step, out_dir, writer)
