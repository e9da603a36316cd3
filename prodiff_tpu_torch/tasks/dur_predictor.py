"""The duration-predictor train task (port of
``prodiff_tpu/tasks/dur_predictor.py``): the phoneme encoder and conv
predictor of ``models/duration.py`` trained on the three-level log-domain
duration loss (``ops/losses.py:dur_loss``). Its validation "plot" prints
the first item's phonemes, target and predicted durations, as in the JAX
package."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.collate import collate_1d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.duration import DurPredictor
from prodiff_tpu_torch.ops.losses import dur_loss
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask
from prodiff_tpu_torch.utils.convert import dur_predictor_flax_params, dur_predictor_state_dict


class DurPredictorDataset(BaseDataset):
    time_keys = {"ph_seq": 1, "ph_dur": 1, "word_dur": 1, "onset": 1}

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if len(samples) == 0:
            return {}
        return {
            "nsamples": len(samples),
            "ph_seq": collate_1d([np.asarray(s["ph_seq"], np.int32) for s in samples], 0),
            "ph_dur": collate_1d([np.asarray(s["ph_dur"], np.float32) for s in samples], 0.0),
            "word_dur": collate_1d([np.asarray(s["word_dur"], np.float32) for s in samples], 0.0),
            "onset": collate_1d([np.asarray(s["onset"], np.int32) for s in samples], 0),
        }


@register_task("dur")
class DurPredictorTask(BaseTask):
    dataset_cls = DurPredictorDataset
    weight_carrier = (dur_predictor_flax_params, dur_predictor_state_dict)

    def __init__(self, hparams):
        super().__init__(hparams)
        args = hparams["dur_prediction_args"]
        self.loss_log_offset = args["log_offset"]
        self.lambdas = (args["lambda_pdur_loss"], args["lambda_wdur_loss"],
                        args["lambda_sdur_loss"])

    def build_model(self) -> DurPredictor:
        self.build_phone_encoder()
        self.model = DurPredictor(len(self.ph_encoder), self.hparams)
        return self.model

    def compute_losses(self, model, batch,
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``{"dur"}``; the model draws no noise (its dropout is the module's)."""
        dur_pred = model(batch["ph_seq"], batch["onset"], batch["word_dur"], infer=False)
        return {"dur": dur_loss(dur_pred, batch["ph_dur"], batch["onset"],
                                log_offset=self.loss_log_offset, lambda_pdur=self.lambdas[0],
                                lambda_wdur=self.lambdas[1], lambda_sdur=self.lambdas[2])}

    @torch.no_grad()
    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        model.eval()
        dur_pred = model(batch["ph_seq"], batch["onset"], batch["word_dur"], infer=True)
        ph_text = self.ph_encoder.decode(batch["ph_seq"][0].tolist()).split()
        print(f"ph_text: {ph_text}\ndur_tgt: {batch['ph_dur'][0].cpu().numpy()}\n"
              f"dur_pred: {dur_pred[0].cpu().numpy()}")
