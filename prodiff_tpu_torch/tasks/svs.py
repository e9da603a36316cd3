"""The SVS acoustic-model train tasks (port of ``prodiff_tpu/tasks/svs.py``).

``svs`` trains the ProDiffTeacher (``component/train_task/svs/task.py:13-100``),
``diff_type: prodiff`` (the x0 losses of ``mel_loss``) or ``reflow`` (the
velocity loss of its first term, logit-normal weighted); its validation
plots sample the first validation batch (``infer_mels``) and draw it beside
the ground truth, ``mel_{i}_step{step}.png``.

``svs_rectified`` trains a bare student on the teacher's binarized
(condition, x_T, x_0) triplets (``task.py:102-171``), the offline
progressive distillation: ``diff_type: prodiff`` a one-step
``GaussianDiffusion`` whose noise is the teacher's start point x_T, ``reflow``
a ``RectifiedFlow``. Its denoiser is the teacher's WaveNet, so with
``dilation_cycle_length: 1`` it trains through K5 on the card. It draws no
plots, as in the JAX package.

Both tasks build their models from ``device.resolve_train_bf16(hparams,
device)`` (``bf16``/``amp`` true, or ``bf16: null`` in ``fast`` mode on the
card): the bf16 compute policy, whose WaveNet trains through K5's bf16
variants on the card. Parameters, the optimizer state and checkpoints stay
float32, and there is no loss scaling, as in the JAX trainer.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch import device as policy
from prodiff_tpu_torch.data.collate import collate_1d, collate_2d
from prodiff_tpu_torch.data.dataset import BaseDataset
from prodiff_tpu_torch.models.diffusion import GaussianDiffusion
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.reflow import RectifiedFlow
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff, spec_loss_reflow
from prodiff_tpu_torch.tasks import register_task
from prodiff_tpu_torch.tasks.base import BaseTask, plot_generator, pyplot, save_figure
from prodiff_tpu_torch.utils.convert import (
    rectified_flax_params,
    rectified_state_dict,
    teacher_flax_params,
    teacher_state_dict,
)


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


class SVSRectifiedDataset(SVSDataset):
    time_keys = dict(SVSDataset.time_keys, condition=1, x_T=1, x_0=1)

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        batch = super().collater(samples)
        # stored per item as [T, M] (condition [T, H]); batched [B, T, M]
        for key in ("condition", "x_T", "x_0"):
            batch[key] = collate_2d([np.asarray(s[key], np.float32) for s in samples], 0.0)
        return batch


@register_task("svs")
class SVSTask(BaseTask):
    dataset_cls = SVSDataset
    weight_carrier = (teacher_flax_params, teacher_state_dict)

    def __init__(self, hparams):
        super().__init__(hparams)
        self.diffusion_type = hparams.get("diff_type", "prodiff")
        self.loss_type = parse_loss_spec(hparams["mel_loss"])
        self.loss_type_list = list(self.loss_type)

    def build_model(self) -> ProDiffTeacher:
        self.build_phone_encoder()
        self.model = ProDiffTeacher(len(self.ph_encoder),
                                    policy.resolve_train_bf16(self.hparams, self.device),
                                    tp=self.tp)
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
        return self._losses(output, batch)

    def _losses(self, output, batch) -> Dict[str, torch.Tensor]:
        non_padding = batch["mel2ph"] > 0
        if self.diffusion_type == "prodiff":
            spec_pred, spec_gt = output
            return spec_loss_prodiff(spec_pred, spec_gt, non_padding, self.loss_type, name="mel")
        v_pred, v_gt, t = output
        return spec_loss_reflow(v_pred, v_gt, t, non_padding, self.loss_type_list[0],
                                log_norm=True, name="mel")

    def infer_mels(self, model, batch, generator: Optional[torch.Generator] = None,
                   infer_step: Optional[int] = None, **noise) -> torch.Tensor:
        """Sampled mels [B, T_mel, M] of a batch, for the validation plots:
        ``sampling_steps`` (reflow) or ``timesteps`` steps unless given;
        ``noise`` (``init_noise``, ``step_noises``) injects the draws,
        otherwise they come from ``generator``."""
        if infer_step is None:
            infer_step = (int(self.hparams.get("sampling_steps", 20))
                          if self.diffusion_type == "reflow"
                          else int(self.hparams.get("timesteps", 4)))
        args, kwargs = self.model_inputs(batch)
        return model.infer(*args, infer_step=infer_step, generator=generator, **noise, **kwargs)

    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        """``mel_{i}_step{step}.png``: the ground truth beside the sampled mel
        (draws seeded from (seed, step)), for the first ``num_valid_plots``
        items. With ``out_dir`` None the mels are rendered and not drawn, as
        by a rank of a tensor-parallel model axis whose rank 0 draws: the
        render needs every rank of the axis (they share one installation,
        so matplotlib imports on all of them or on none)."""
        plt = pyplot()
        if plt is None:
            return
        model.eval()
        gen = plot_generator(self.hparams, step, batch["mel"].device)
        mel_pred = self.infer_mels(model, batch, gen).cpu().numpy()
        if out_dir is None:
            return
        mel_gt = batch["mel"].cpu().numpy()
        os.makedirs(out_dir, exist_ok=True)
        for i in range(min(self.hparams.get("num_valid_plots", 10), len(mel_gt))):
            fig = plt.figure(figsize=(12, 6))
            plt.pcolor(np.concatenate([mel_gt[i], mel_pred[i]], axis=-1).T,
                       vmin=self.hparams.get("mel_vmin", -6), vmax=self.hparams.get("mel_vmax", 1.5))
            save_figure(plt, fig, out_dir, f"mel_{i}", f"mel_val_{i}", step, writer)


@register_task("svs_rectified")
class SVSRectifiedTask(SVSTask):
    """Student distillation on the teacher's (condition, x_T, x_0) triplets."""

    dataset_cls = SVSRectifiedDataset
    weight_carrier = (rectified_flax_params, rectified_state_dict)

    def build_model(self):
        hp = policy.resolve_train_bf16(self.hparams, self.device)
        mel_bins = hp["audio_num_mel_bins"]
        denoiser = WaveNet(in_dims=mel_bins, hidden_size=hp["hidden_size"],
                           residual_layers=hp["residual_layers"],
                           residual_channels=hp["residual_channels"],
                           dilation_cycle_length=hp["dilation_cycle_length"],
                           dtype=policy.module_dtype(hp), stream_dtype=policy.stream_dtype(hp))
        if self.diffusion_type == "prodiff":
            self.model = GaussianDiffusion(denoise_fn=denoiser, out_dims=mel_bins, timesteps=1,
                                           schedule_type=hp["schedule_type"],
                                           max_beta=hp.get("max_beta", 0.06))
        else:
            self.model = RectifiedFlow(denoise_fn=denoiser, out_dims=mel_bins,
                                       time_scale=hp["timescale"], num_features=1,
                                       sampling_algorithm=hp.get("sampling_algorithm", "euler"),
                                       spec_min=tuple(hp["spec_min"]),
                                       spec_max=tuple(hp["spec_max"]))
        return self.model

    def compute_losses(self, model, batch, generator: Optional[torch.Generator] = None,
                       t: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The student's losses on the triplets: ``diff_type: prodiff``
        noises x_0 with the teacher's own start point x_T (so ``noise`` is
        refused) at ``t`` in {0, 1}; ``reflow`` takes ``t`` and the start
        point ``noise``. Whatever is not given is drawn from ``generator``."""
        x_0 = batch["x_0"][:, None]  # [B, 1, T, M]
        if self.diffusion_type == "prodiff":
            if noise is not None:
                raise ValueError("svs_rectified (prodiff) noises with the batch's x_T")
            noise = batch["x_T"][:, None]
        return self._losses(model(batch["condition"], x_0, t=t, noise=noise,
                                  generator=generator), batch)

    def validation_plots(self, model, batch, step: int, out_dir, writer=None) -> None:
        """None, as in the JAX package."""
