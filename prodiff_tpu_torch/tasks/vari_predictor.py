"""The variance-predictor train task (port of
``prodiff_tpu/tasks/vari_predictor.py``): the multi-variance diffusion of
``models/vari_predictor.py`` trained on the stacked, clamped curves of
:func:`~prodiff_tpu_torch.models.vari_predictor.variance_list` with the
ProDiff x0 losses of ``vari_prediction_args.loss_type``. With
``dilation_cycle_length: 1`` (the base config) its denoiser trains through
K5 on the card. Its validation plots draw each curve's ground truth beside
the sampled prediction, ``{name}_{i}_step{step}.png``."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.collate import collate_1d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.vari_predictor import VariPredictor, variance_list
from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask, plot_curves, plot_generator, pyplot
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
    weight_carrier = (vari_predictor_flax_params, vari_predictor_state_dict)

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

    def validation_curves(self, model, batch, generator: Optional[torch.Generator] = None,
                          **noise) -> dict:
        """{curve name: (gt, pred)}, numpy [B, T_mel]; ``noise``
        (``init_noise``, ``step_noises``) injects the sampler's draws,
        otherwise they come from ``generator``."""
        curves = model.infer(batch["ph_seq"], batch["mel2ph"], batch["note_midi"],
                             batch["note_rest"], batch["mel2note"], batch["f0"],
                             spk_embed_id=batch.get("spk_id"), generator=generator, **noise)
        return {name: (batch[name].cpu().numpy(), pred.cpu().numpy())
                for name, pred in curves.items()}

    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        if out_dir is None or pyplot() is None:  # no figure: no sampling
            return
        model.eval()
        gen = plot_generator(self.hparams, step, batch["f0"].device)
        plot_curves(self.validation_curves(model, batch, gen), self.hparams, step, out_dir, writer)
