"""FastDiff vocoder (port of ``prodiff_tpu/vocoders/fastdiff.py``).

Built from a ``vocoder_ckpt`` directory (``config.yaml`` + the newest
``model_ckpt_steps_*.ckpt``, a torch checkpoint whose weight norm is folded
at load; PyYAML is read only on this route), or in memory from a reference
state dict + config, as :class:`~prodiff_tpu_torch.vocoders.nsf_hifigan.NsfHifiGAN`
is. Selects the 4/6/8/1000-step reverse schedule (``fastdiff_reverse_step``,
default 4) and hoists the KernelPredictors out of the reverse loop for
schedules of at most ``MAX_HOISTED_STEPS`` steps.

Hparams read: ``fastdiff_packed`` false selects the unfused LVC layer (conv
in cuDNN, the LVC kernel, gate and residual apart); unset or true, the fused
layer kernel. The JAX package's ``fastdiff_fused_lvc`` (its opt-in Pallas LVC
inside the linen path) has no effect here: on the card the LVC always runs in
a kernel, the fused layer's or, in the unfused layer, the LVC's.

The KernelPredictors' compute dtype is ``device.kernel_predictor_dtype`` at
construction: bf16 on the fused layer in ``fast`` mode on the card (the
window kernels then run the bf16 builds of K4 and K7), float32 otherwise.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from prodiff_tpu_torch.device import kernel_predictor_dtype, resolve_device
from prodiff_tpu_torch.models.fastdiff import (
    MAX_HOISTED_STEPS,
    FastDiff as FastDiffNet,
    compute_hyperparams_given_schedule,
    fastdiff_step_kernels,
    prepare_inference_schedule,
    sampling_given_noise_schedule,
    tap_major_state_dict,
)
from prodiff_tpu_torch.utils.convert import last_checkpoint_path, load_torch_state_dict
from prodiff_tpu_torch.vocoders import BaseVocoder, register_vocoder
from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

NOISE_SCHEDULES = {
    1000: np.linspace(0.000001, 0.01, 1000),
    200: np.linspace(0.0001, 0.02, 200),
    # derived by the reference's noise predictor
    8: np.array([6.689325005027058e-07, 1.0033881153503899e-05,
                 0.00015496854030061513, 0.002387222135439515,
                 0.035597629845142365, 0.3681158423423767,
                 0.4735414385795593, 0.5]),
    6: np.array([1.7838445955931093e-06, 2.7984189728158526e-05,
                 0.00043231004383414984, 0.006634317338466644,
                 0.09357017278671265, 0.6000000238418579]),
    4: np.array([3.2176e-04, 2.5743e-03, 2.5376e-02, 7.0414e-01]),
    3: np.array([9.0000e-05, 9.0000e-03, 6.0000e-01]),
}


def build_fastdiff(config: dict, state_dict: dict, reverse_step: int = 4,
                   fused_layer: bool = True, kp_dtype: Optional[torch.dtype] = None):
    """-> (model with the reference state dict loaded, the train schedule's
    hyperparams, the reverse noise schedule)."""
    model = FastDiffNet.from_config(config, fused_layer=fused_layer, kp_dtype=kp_dtype)
    model.load_state_dict(tap_major_state_dict(state_dict, config))
    train = np.linspace(float(config["beta_0"]), float(config["beta_T"]), int(config["T"]))
    if config.get("noise_schedule", ""):
        schedule = np.asarray(config["noise_schedule"], np.float64)
    else:
        schedule = NOISE_SCHEDULES[reverse_step]
    return model, compute_hyperparams_given_schedule(train), schedule


def load_fastdiff_model(config_path: str, checkpoint_path: str, reverse_step: int = 4,
                        fused_layer: bool = True, kp_dtype: Optional[torch.dtype] = None):
    """-> (model, hyperparams, noise schedule, config) from the files."""
    import yaml

    with open(config_path) as f:
        config = yaml.safe_load(f)
    return (*build_fastdiff(config, load_torch_state_dict(checkpoint_path), reverse_step,
                            fused_layer, kp_dtype), config)


@register_vocoder
class FastDiff(BaseVocoder):
    def __init__(self, hparams: dict, state_dict: Optional[dict] = None,
                 config: Optional[dict] = None, device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        reverse_step = int(hparams.get("fastdiff_reverse_step", 4))
        fused = hparams.get("fastdiff_packed", None) is not False
        kp_dtype = kernel_predictor_dtype(fused, self.device)
        if state_dict is None:
            base_dir = hparams.get("vocoder_ckpt") or "checkpoint/FastDiff"
            ckpt = last_checkpoint_path(base_dir)
            if ckpt is None:
                raise FileNotFoundError(f"no FastDiff checkpoints in {base_dir}")
            model, dh, schedule, config = load_fastdiff_model(
                os.path.join(base_dir, "config.yaml"), ckpt, reverse_step, fused, kp_dtype)
        else:
            model, dh, schedule = build_fastdiff(config, state_dict, reverse_step, fused, kp_dtype)
        self.config = config
        self.model = model.to(self.device).eval()
        self.hop = int(np.prod(config["upsample_ratios"]))
        self.beta_infer, self.alpha_infer, self.sigma_infer, self.steps_infer = \
            prepare_inference_schedule(schedule, dh["alpha"])

    @torch.no_grad()
    def spec2wav(self, mel, generator: Optional[torch.Generator] = None,
                 init_noise: Optional[torch.Tensor] = None,
                 step_noises: Optional[torch.Tensor] = None, **kwargs) -> np.ndarray:
        """mel [T, M] as the acoustic model emits it -> wav [T * hop].

        The noise is ``init_noise`` [1, T*hop, 1] / ``step_noises``
        [n, 1, T*hop, 1] where given, else drawn from ``generator`` (default:
        seed 0). Other keywords (the ``f0`` the vocode route hands every
        vocoder) are ignored: FastDiff is conditioned on the mel alone."""
        c = torch.as_tensor(mel, dtype=torch.float32, device=self.device)[None]
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        kp_all = None
        if len(self.steps_infer) <= MAX_HOISTED_STEPS:
            steps = torch.tensor(np.asarray(self.steps_infer, np.float32), device=self.device)
            kp_all = fastdiff_step_kernels(self.model, c, steps)
        wav = sampling_given_noise_schedule(
            self.model, c, c.shape[1] * self.hop, self.beta_infer, self.alpha_infer,
            self.sigma_infer, self.steps_infer, generator=generator, init_noise=init_noise,
            step_noises=step_noises, kp_all=kp_all,
        )
        return wav[0].cpu().numpy()

    @staticmethod
    def wav2spec(inp_path: str, hparams: dict, keyshift=0, speed=1, device=None):
        """NSF-HiFiGAN's log10-mel of a wav file, as in the JAX package."""
        return NsfHifiGAN.wav2spec(inp_path, hparams, keyshift, speed, device=device)
