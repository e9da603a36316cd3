"""The variance-predictor train task (port of
``prodiff_tpu/tasks/vari_predictor.py``): the multi-variance diffusion of
``models/vari_predictor.py`` trained on the stacked, clamped curves of
:func:`~prodiff_tpu_torch.models.vari_predictor.variance_list` with the
ProDiff x0 losses of ``vari_prediction_args.loss_type``. With
``dilation_cycle_length: 1`` (the base config) its denoiser trains through
K5 on the card."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.collate import collate_1d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.vari_predictor import VariPredictor, variance_list
from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask
from prodiff_tpu_torch.tasks.pitch_predictor import note_batch
from prodiff_tpu_torch.utils.convert import vari_predictor_flax_params, vari_predictor_state_dict


class VariPredictorDataset(BaseDataset):
    time_keys = {"ph_seq": 1, "mel2ph": 1, "note_midi": 1, "note_rest": 1, "mel2note": 1,
                 "f0": 1, "voicing": 1, "breath": 1, "tension": 1}
    pad_values = {"note_midi": -1.0, "note_rest": True}

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if len(samples) == 0:
            return {}
        batch = note_batch(samples)
        batch["f0"] = collate_1d([np.asarray(s["f0"], np.float32) for s in samples], 0.0)
        if self.hparams.get("use_spk_id", True):
            batch["spk_id"] = np.asarray([s["spk_id"] for s in samples], np.int32)
        for name in variance_list(self.hparams):
            batch[name] = collate_1d([np.asarray(s[name], np.float32) for s in samples], 0.0)
        return batch


@register_task("vari")
class VariPredictorTask(BaseTask):
    dataset_cls = VariPredictorDataset

    def __init__(self, hparams):
        super().__init__(hparams)
        self.variance_names = variance_list(hparams)
        self.loss_type = parse_loss_spec(hparams["vari_prediction_args"]["loss_type"])

    def build_model(self) -> VariPredictor:
        self.build_phone_encoder()
        self.model = VariPredictor(len(self.ph_encoder), self.hparams)
        return self.model

    def compute_losses(self, model, batch, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``{"vari_l1", "vari_ssim"}`` (the configured terms) over the frames
        with a note; ``t``/``noise`` are drawn from ``generator`` where not
        given."""
        gt_curves = torch.stack([batch[name] for name in self.variance_names], dim=1)
        x0_pred, x0 = model(batch["ph_seq"], batch["mel2ph"], batch["note_midi"],
                            batch["note_rest"], batch["mel2note"], batch["f0"], gt_curves,
                            spk_embed_id=batch.get("spk_id"), t=t, noise=noise,
                            generator=generator)
        return spec_loss_prodiff(x0_pred, x0, batch["mel2note"] > 0, self.loss_type, name="vari")

    def params_tree(self, model) -> dict:
        return vari_predictor_flax_params(model.state_dict(), self.hparams)

    def load_params_tree(self, model, tree: dict) -> None:
        model.load_state_dict(vari_predictor_state_dict(tree, self.hparams))
