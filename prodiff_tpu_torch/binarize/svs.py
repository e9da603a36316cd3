"""The SVS binarizers (port of ``prodiff_tpu/binarize/svs.py``).

``svs``: wav + ``label.json`` -> ph_seq, ph_dur, the log10 mel, mel2ph, the
f0 of the configured pitch extractor, the speaker and language ids and,
where ``binarization_args`` asks, the voicing, breath and tension curves of
the VR model's harmonic/aperiodic split. The item list is shuffled with seed
3407 when asked; an all-unvoiced item raises naming its wav.

``svs_rectified``: the same, then a frozen teacher's condition and its full
diffusion (on the card, the teacher's WaveNet runs K1), with the
offline-distillation triplet written as ``condition``, ``x_T`` and ``x_0``.
``x_T`` and the teacher's noise are drawn from a ``torch.Generator`` seeded
``seed + item index`` (:meth:`SVSRectifiedDiffusionBinarizer.draw_noise`);
the JAX package draws them from ``jax.random`` keys, so the two packages'
shards agree only where the noise is injected.
"""

from __future__ import annotations

import json
import random

import numpy as np
import torch

from prodiff_tpu_torch.binarize import Binarizer, register_binarizer
from prodiff_tpu_torch.binarize.utils import (build_lang_map, build_phone_encoder,
                                              build_spk_map, get_breath, get_mel_spec,
                                              get_tension, get_voicing)
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.ops.seq import dur_to_mel2ph_host
from prodiff_tpu_torch.utils.audio import load_wav


def variance_features(binarizer, hp: dict, waveform, mel_len: int, f0) -> dict:
    """The voicing, breath and tension curves that ``binarizer`` asks for
    (its ``need_*`` flags), from the VR split of ``waveform`` on its device."""
    from prodiff_tpu_torch.separation import extract_harmonic_aperiodic

    out = {}
    if not (binarizer.need_voicing or binarizer.need_breath or binarizer.need_tension):
        return out
    harmonic, aperiodic = extract_harmonic_aperiodic(waveform, hp["vr_ckpt"],
                                                     device=binarizer.device)
    args = (mel_len, binarizer.hop_size, binarizer.win_size, binarizer.smooth_kernel)
    if binarizer.need_voicing:
        out["voicing"] = get_voicing(harmonic, *args, norm=hp["voicing_norm"],
                                     db_min=hp["voicing_db_min"], db_max=hp["voicing_db_max"])
    if binarizer.need_breath:
        out["breath"] = get_breath(aperiodic, *args, norm=hp["breath_norm"],
                                   db_min=hp["breath_db_min"], db_max=hp["breath_db_max"])
    if binarizer.need_tension:
        out["tension"] = get_tension(harmonic, mel_len, f0, binarizer.hop_size,
                                     binarizer.win_size, binarizer.samplerate,
                                     binarizer.smooth_kernel, device=binarizer.device)
    return out


@register_binarizer
class SVSBinarizer(Binarizer):
    def __init__(self, hparams: dict, device=None):
        from prodiff_tpu_torch.pe import get_pe_cls

        super().__init__(hparams, device)
        self.device = resolve_device(device)
        args = hparams["binarization_args"]
        self.ph_map, self.ph_encoder = build_phone_encoder(
            self.data_dir, hparams["dictionary"], hparams["languages"])
        self.need_spk_id = args.get("with_spk_id", True)
        if self.need_spk_id:
            self.spk_map = build_spk_map(self.data_dir, self.datasets)
        self.need_lang_id = args.get("with_lang_id", True)
        if self.need_lang_id:
            self.lang_map = build_lang_map(self.data_dir, hparams["languages"])
        self.samplerate = hparams["audio_sample_rate"]
        self.hop_size = hparams["hop_size"]
        self.fft_size, self.win_size = hparams["fft_size"], hparams["win_size"]
        self.timestep = self.hop_size / self.samplerate
        self.f_min, self.f_max = hparams["fmin"], hparams["fmax"]
        self.num_mel_bins = hparams["audio_num_mel_bins"]
        self.pe = get_pe_cls(hparams["pitch_extractor"])(hparams, device=self.device)
        self.need_voicing = args.get("with_voicing", False)
        self.need_breath = args.get("with_breath", False)
        self.need_tension = args.get("with_tension", False)
        self.smooth_kernel = round(0.12 / self.timestep)
        self.shuffle = args.get("shuffle", False)

    @staticmethod
    def category():
        return "svs"

    def load_meta_data(self) -> list:
        items = []
        for dataset in self.datasets:
            data_dir, lang = dataset["data_dir"], dataset["language"]
            lang_id = self.lang_map[lang] if self.need_lang_id else None
            spk_id = self.spk_map[dataset["speaker"]] if self.need_spk_id else None
            with open(f"{data_dir}/label.json", encoding="utf-8") as f:
                labels = json.load(f)
            for item_name, label in labels.items():
                ph_text = [self.ph_map[f"{x}/{lang}"] for x in label["ph_seq"].split(" ")]
                item = {
                    "item_name": item_name,
                    "wav_fn": f"{data_dir}/wav/{item_name}.wav",
                    "ph_seq": self.ph_encoder.encode(ph_text),
                    "ph_dur": [float(x) for x in label["ph_dur"].split(" ")],
                }
                if self.need_spk_id:
                    item["spk_id"] = spk_id
                if self.need_lang_id:
                    item["lang_seq"] = [lang_id] * len(item["ph_seq"])
                if self.hparams.get("use_gender_id", False):
                    item["gender_id"] = dataset["gender"]
                items.append(item)
        if self.shuffle:
            random.seed(3407)
            random.shuffle(items)
        return items

    def process_item(self, item: dict) -> dict:
        hp = self.hparams
        out = {"ph_seq": np.array(item["ph_seq"], dtype=np.int64),
               "ph_dur": np.array(item["ph_dur"], dtype=np.float32)}
        if self.need_spk_id:
            out["spk_id"] = item["spk_id"]
        if self.need_lang_id:
            out["lang_seq"] = np.array(item["lang_seq"], dtype=np.int64)
        if hp.get("use_gender_id", False):
            out["gender_id"] = item["gender_id"]
        waveform, _ = load_wav(item["wav_fn"], sr=self.samplerate)
        mel = get_mel_spec(waveform, self.samplerate, self.num_mel_bins, self.fft_size,
                           self.win_size, self.hop_size, self.f_min, self.f_max,
                           device=self.device)
        out["mel"] = mel
        out["sec"] = len(waveform) / self.samplerate
        out["length"] = mel.shape[0]
        out["mel2ph"] = dur_to_mel2ph_host(item["ph_dur"], self.timestep, mel.shape[0])
        f0, uv = self.pe.get_pitch(waveform, samplerate=self.samplerate, length=mel.shape[0],
                                   hop_size=self.hop_size, interp_uv=hp["interp_uv"])
        if uv.all():
            raise ValueError(f"all unvoiced: item {item.get('item_name')}, wav {item['wav_fn']}")
        out["f0"] = np.asarray(f0, np.float32)
        out.update(variance_features(self, hp, waveform, mel.shape[0], out["f0"]))
        return out


@register_binarizer
class SVSRectifiedDiffusionBinarizer(SVSBinarizer):
    """Distillation data: the frozen teacher (``teacher_ckpt``: a checkpoint
    file, or the work dir whose newest checkpoint is read) conditions each
    item and samples its mel from noise drawn per item."""

    def __init__(self, hparams: dict, device=None):
        import os

        from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
        from prodiff_tpu_torch.utils.convert import (last_checkpoint_path, load_flax_checkpoint,
                                                     teacher_state_dict)

        super().__init__(hparams, device)
        path = hparams["teacher_ckpt"]
        if os.path.isdir(path):
            path = last_checkpoint_path(path)
            if path is None:
                raise FileNotFoundError(f"no checkpoint in {hparams['teacher_ckpt']}")
        self.teacher = ProDiffTeacher(len(self.ph_encoder), hparams)
        self.teacher.load_state_dict(teacher_state_dict(
            load_flax_checkpoint(path)["state_dict"], hparams))
        self.teacher.to(self.device).eval()
        self._item_idx = 0

    @staticmethod
    def category():
        return "svs_rectified"

    def draw_noise(self, item_idx: int, t_mel: int) -> dict:
        """-> ``{"x_T": [1, 1, T, M], "generator": ...}``: the student's
        noise and the generator the teacher's sampler draws from, seeded
        ``seed + item_idx``. A caller may return ``init_noise`` /
        ``step_noises`` (the sampler's arguments) in place of the generator."""
        gen = torch.Generator(self.device).manual_seed(int(self.hparams.get("seed", 1234))
                                                       + item_idx)
        x_T = torch.randn((1, 1, t_mel, self.num_mel_bins), generator=gen, device=self.device)
        return {"x_T": x_T, "generator": gen}

    @torch.no_grad()
    def process_item(self, item: dict) -> dict:
        hp = self.hparams
        out = super().process_item(item)

        def tensor(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        kwargs = {}
        if hp.get("use_spk_id", True):
            kwargs["spk_embed_id"] = tensor([out["spk_id"]], torch.long)
        if hp.get("use_gender_id", False):
            kwargs["gender_embed_id"] = tensor([out["gender_id"]], torch.long)
        if hp.get("use_lang_id", True):
            kwargs["lang_seq"] = tensor(out["lang_seq"], torch.long)[None]
        for name in ("voicing", "breath"):
            if hp.get(f"use_{name}_embed", False):
                kwargs[name] = tensor(out[name])[None]
        condition = self.teacher.forward_condition(
            tensor(out["ph_seq"], torch.long)[None], tensor(out["mel2ph"], torch.long)[None],
            tensor(out["f0"])[None], **kwargs)  # [1, T, H]
        noise = self.draw_noise(self._item_idx, condition.shape[1])
        self._item_idx += 1
        x_T = noise.pop("x_T")
        x_0 = self.teacher.diffusion.infer(condition, **noise)
        out["condition"] = condition[0].cpu().numpy()  # [T, H]
        out["x_T"] = x_T[0, 0].cpu().numpy()  # [T, M]
        out["x_0"] = x_0[0, 0].cpu().numpy()  # [T, M]
        return out
