"""The SVS acoustic-model train task (port of ``svs`` in
``prodiff_tpu/tasks/svs.py``): trains the ProDiffTeacher
(``component/train_task/svs/task.py:13-100``), ``diff_type: prodiff`` (the
x0 losses of ``mel_loss``) or ``reflow`` (the velocity loss of its first
term, logit-normal weighted).

``svs_rectified``, bf16 training and the validation plots land with later
slices and raise ``NotImplementedError`` saying which.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.collate import collate_1d, collate_2d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff, spec_loss_reflow
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask
from prodiff_tpu_torch.utils.convert import teacher_flax_params, teacher_state_dict


class SVSDataset(BaseDataset):
    time_keys = {"mel2ph": 1, "f0": 1, "mel": 1, "voicing": 1, "breath": 1, "tension": 1}

    def __init__(self, prefix, shuffle, hparams):
        super().__init__(prefix, shuffle, hparams)
        f0_stats_fn = f"{self.data_dir}/train_f0s_mean_std.npy"
        if os.path.exists(f0_stats_fn):
            self.f0_mean, self.f0_std = np.load(f0_stats_fn)
            hparams["f0_mean"], hparams["f0_std"] = float(self.f0_mean), float(self.f0_std)
        else:
            self.f0_mean = self.f0_std = None

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        if len(samples) == 0:
            return {}
        hp = self.hparams
        batch = {
            "nsamples": len(samples),
            "ph_seq": collate_1d([np.asarray(s["ph_seq"], np.int32) for s in samples], 0),
            "mel2ph": collate_1d([np.asarray(s["mel2ph"], np.int32) for s in samples], 0),
            "f0": collate_1d([np.asarray(s["f0"], np.float32) for s in samples], 0.0),
            "mel": collate_2d([np.asarray(s["mel"], np.float32) for s in samples], 0.0),
        }
        if hp.get("use_spk_id", True):
            batch["spk_id"] = np.asarray([s["spk_id"] for s in samples], np.int32)
        if hp.get("use_gender_id", False):
            batch["gender_id"] = np.asarray([s["gender_id"] for s in samples], np.int32)
        if hp.get("use_lang_id", True):
            batch["lang_seq"] = collate_1d([np.asarray(s["lang_seq"], np.int32) for s in samples], 0)
        for key, flag in (("voicing", "use_voicing_embed"), ("breath", "use_breath_embed"),
                          ("tension", "use_tension_embed")):
            if hp.get(flag, False) and key in samples[0]:
                batch[key] = collate_1d([np.asarray(s[key], np.float32) for s in samples], 0.0)
        return batch


@register_task("svs")
class SVSTask(BaseTask):
    dataset_cls = SVSDataset

    def __init__(self, hparams):
        super().__init__(hparams)
        self.diffusion_type = hparams.get("diff_type", "prodiff")
        if hparams.get("bf16") or hparams.get("amp"):
            raise NotImplementedError(
                "bf16/amp training: the port trains in parity mode (float32, TF32 off); "
                "a fast mode lands with a performance slice")
        self.loss_type = parse_loss_spec(hparams["mel_loss"])
        self.loss_type_list = list(self.loss_type)

    def build_model(self) -> ProDiffTeacher:
        self.build_phone_encoder()
        self.model = ProDiffTeacher(len(self.ph_encoder), self.hparams)
        return self.model

    @staticmethod
    def model_inputs(batch):
        kwargs = dict(lang_seq=batch.get("lang_seq"), spk_embed_id=batch.get("spk_id"),
                      gender_embed_id=batch.get("gender_id"), voicing=batch.get("voicing"),
                      breath=batch.get("breath"))
        return (batch["ph_seq"], batch["mel2ph"], batch["f0"]), kwargs

    def compute_losses(self, model, batch, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The losses of one training forward: ``{"mel_l1", "mel_ssim"}``
        (the configured ``mel_loss`` terms) for ``diff_type: prodiff``, ``{"mel"}``
        for ``reflow``; ``t``/``noise`` are drawn from ``generator`` where not
        given."""
        args, kwargs = self.model_inputs(batch)
        output = model(*args, gt_spec=batch["mel"], t=t, noise=noise, generator=generator,
                       **kwargs)
        non_padding = batch["mel2ph"] > 0
        if self.diffusion_type == "prodiff":
            spec_pred, spec_gt = output
            return spec_loss_prodiff(spec_pred, spec_gt, non_padding, self.loss_type, name="mel")
        v_pred, v_gt, t = output
        return spec_loss_reflow(v_pred, v_gt, t, non_padding, self.loss_type_list[0],
                                log_norm=True, name="mel")

    def params_tree(self, model) -> dict:
        """The model's weights as the JAX package's param tree (checkpoints)."""
        return teacher_flax_params(model.state_dict(), self.hparams)

    def load_params_tree(self, model, tree: dict) -> None:
        model.load_state_dict(teacher_state_dict(tree, self.hparams))


@register_task("svs_rectified")
class SVSRectifiedTask(SVSTask):
    def __init__(self, hparams):
        raise NotImplementedError(
            "svs_rectified (student distillation on teacher pairs) lands with the "
            "distillation slice")
