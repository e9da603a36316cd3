"""SVS inference: .ds project -> segments -> stitched wav (port of
``prodiff_tpu/infer/handler.py:SVSInferHandler``, without the predictors).

Per segment: phoneme ids through the phone map, given durations -> mel2ph,
given (resampled) pitch, keyshift, speaker/gender mix embeds (weighted sums
of the embedding tables), voicing/breath curves (constant -10/-50 dB when a
segment gives none), the 4-step acoustic model, the vocoder, then offset /
cross-fade stitching into one track. Segments are grouped by padded
``(T_ph, T_mel)`` bucket and each group runs as one batch; padded mel frames
are filled with the log10 silence floor before vocoding and the wav is
trimmed to the true length.

Two ways to build it: from an experiment directory (``exp_name``: the
``config.yaml``, phone/speaker/language maps and the newest JAX-package
checkpoint under ``checkpoints/{exp_name}/svs``, read without JAX), or from
an in-memory ``hparams`` dict, ``state_dict``, ``maps`` and ``vocoder``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu.data.collate import round_up
from prodiff_tpu.utils.audio import cross_fade, save_wav
from prodiff_tpu.utils.pitch_utils import resample_align_curve, shift_pitch
from prodiff_tpu.utils.text_encoder import TokenTextEncoder
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.utils.convert import load_flax_checkpoint, teacher_state_dict
from prodiff_tpu_torch.vocoders import get_vocoder_cls

MEL_PAD_LOG10 = -5.0  # log10 of the STFT clip floor (silence)
MAP_FILES = {"phone_set": "phone_set.json", "spk_map": "spk_map.json", "lang_map": "lang_map.json"}


def last_checkpoint_path(work_dir: str) -> Optional[str]:
    """Newest ``model_ckpt_steps_{N}.ckpt`` in ``work_dir`` by step number."""
    found = []
    for path in glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt")):
        m = re.search(r"model_ckpt_steps_(\d+)\.ckpt$", path)
        if m:
            found.append((int(m.group(1)), path))
    return max(found)[1] if found else None


def phone_encoder(ph_map: Dict[str, str]) -> TokenTextEncoder:
    """Token encoder over the phone set's phonemes (``phone_set.json``)."""
    return TokenTextEncoder(sorted(set(ph_map.values())), replace_oov="SP")


def _unsupported(option: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet: it lands with the {slice_name} slice")


class SVSInferHandler:
    def __init__(
        self,
        exp_name: Optional[str] = None,
        checkpoints_root: str = "checkpoints",
        pred_dur: bool = False,
        pred_pitch: str = "",
        pred_voicing: bool = False,
        pred_breath: bool = False,
        isolate_aspiration: bool = False,
        isolate_base_harmonic: bool = False,
        out_dir: str = "infer_out",
        deterministic: bool = False,
        device=None,
        *,
        hparams: Optional[dict] = None,
        state_dict: Optional[dict] = None,
        maps: Optional[Dict[str, dict]] = None,
        vocoder=None,
    ):
        for option, on in (("pred_dur", pred_dur), ("pred_pitch", pred_pitch),
                           ("pred_voicing", pred_voicing), ("pred_breath", pred_breath)):
            if on:
                raise _unsupported(option, "variance")
        for option, on in (("isolate_aspiration", isolate_aspiration),
                           ("isolate_base_harmonic", isolate_base_harmonic)):
            if on:
                raise _unsupported(option, "data-pipeline (VR separation)")
        # deterministic=True renders reproducibly: zero diffusion init/step
        # noise and a zero-phase, noise-free vocoder sine source
        self.deterministic = deterministic
        self.device = resolve_device(device)
        self.out_dir = out_dir
        if hparams is None:
            if exp_name is None:
                raise ValueError("give exp_name, or hparams + state_dict + maps")
            hparams, state_dict, maps = self._load_experiment(exp_name, checkpoints_root)
        elif state_dict is None or maps is None:
            raise ValueError("an in-memory handler needs hparams, state_dict and maps")
        self.hparams = hparams
        if hparams.get("diff_type", "prodiff") != "prodiff":
            raise _unsupported("diff_type reflow", "variance")
        self.hop_size = hparams["hop_size"]
        self.audio_sample_rate = hparams["audio_sample_rate"]
        self.timestep = self.hop_size / self.audio_sample_rate
        self.mel_bucket = hparams.get("length_bucket_step", 128)
        self.infer_step = int(hparams.get("timesteps", 4))

        self.ph_map = maps["phone_set"]
        self.ph_encoder = phone_encoder(self.ph_map)
        self.spk_map, self.lang_map = maps["spk_map"], maps["lang_map"]
        self.model = ProDiffTeacher(len(self.ph_encoder), hparams)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self._tables = {
            name: getattr(self.model, name).weight.detach().cpu().numpy()
            for name in ("spk_embed", "gender_embed") if hasattr(self.model, name)
        }
        self.vocoder = vocoder or get_vocoder_cls(hparams["vocoder"])(hparams, device=self.device)

    # ---- assets -------------------------------------------------------------

    @staticmethod
    def _load_experiment(exp_name: str, checkpoints_root: str):
        from prodiff_tpu.config import set_hparams  # needs PyYAML, only on this route

        hp = set_hparams(exp_name=exp_name, task="svs", make_work_dir=False,
                         checkpoints_root=checkpoints_root)
        maps = {}
        for key, fname in MAP_FILES.items():
            path = os.path.join(hp["work_dir"], fname)
            if not os.path.exists(path):  # the binarizer writes maps into {data_dir}/svs
                path = os.path.join(hp["data_dir"], "svs", fname)
            with open(path) as f:
                maps[key] = json.load(f)
        ckpt = last_checkpoint_path(hp["work_dir"])
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint found in {hp['work_dir']}")
        payload = load_flax_checkpoint(ckpt)
        return hp, teacher_state_dict(payload["state_dict"], hp), maps

    # ---- mixes ---------------------------------------------------------------

    def get_speaker_mix(self, spk_name: Optional[str]) -> Dict[str, float]:
        if not spk_name:
            mix = {next(iter(self.spk_map)): 1.0}
        elif ":" in spk_name:
            mix = {k: float(v) for k, v in (x.split(":") for x in spk_name.split("|"))}
        else:
            mix = {spk_name: 1.0}
        for name in mix:
            if name not in self.spk_map:
                raise ValueError(f"Speaker name {name} not found in spk_map")
        total = sum(mix.values())
        return {k: v / total for k, v in mix.items()}

    def spk_mix_embed(self, spk_mix_map: Dict[str, float]) -> np.ndarray:
        table = self._tables["spk_embed"]
        mix = sum(w * table[self.spk_map[name]] for name, w in spk_mix_map.items())
        return mix[None, None, :].astype(np.float32)  # [1, 1, H]

    def gender_mix_embed(self, gender_value: float) -> np.ndarray:
        if not 0 <= gender_value <= 1:
            raise ValueError("gender must be in [0, 1]")
        table = self._tables["gender_embed"]
        mix = (1 - gender_value) * table[0] + gender_value * table[1]
        return mix[None, None, :].astype(np.float32)

    # ---- device compute ------------------------------------------------------

    def _tensor(self, a, dtype=torch.float32):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=self.device)

    @torch.no_grad()
    def _acoustic(self, ph, mel2ph, f0, lang, spk_mix, gender_mix, voicing, breath) -> torch.Tensor:
        b, t_mel = mel2ph.shape
        init_noise = step_noises = generator = None
        if self.deterministic:
            shape = (b, 1, t_mel, self.hparams["audio_num_mel_bins"])
            init_noise = torch.zeros(shape, device=self.device)
            step_noises = torch.zeros((self.infer_step, *shape), device=self.device)
        else:
            generator = torch.Generator(self.device).manual_seed(int(self.hparams.get("seed", 1234)))
        return self.model.infer(
            self._tensor(ph, torch.long), self._tensor(mel2ph, torch.long), self._tensor(f0),
            infer_step=self.infer_step, init_noise=init_noise, step_noises=step_noises,
            generator=generator,
            lang_seq=self._tensor(lang, torch.long),
            spk_mix_embed=self._tensor(spk_mix), gender_mix_embed=self._tensor(gender_mix),
            voicing=self._tensor(voicing), breath=self._tensor(breath),
        )

    def _vocode(self, mel: torch.Tensor, f0) -> torch.Tensor:
        return self.vocoder.spec2wav_batch(
            mel, f0, deterministic=True if self.deterministic else None
        )

    def warmup(self, buckets=None, batch_sizes=(1,)) -> List[tuple]:
        """Build the kernels and run the acoustic model and the vocoder once
        per ``(T_ph, T_mel)`` bucket (default: hparam ``precompile_buckets``,
        else ``[64, 1024]``) on zero inputs, so the first request pays no build.
        Returns the ``(batch, t_ph, t_mel)`` shapes run."""
        hp = self.hparams
        done = []
        for t_ph, t_mel in buckets or hp.get("precompile_buckets") or [(64, 1024)]:
            t_ph, t_mel = round_up(int(t_ph), 16), round_up(int(t_mel), self.mel_bucket)
            for b in batch_sizes:
                mix = np.tile(self.spk_mix_embed(self.get_speaker_mix(None)), (b, 1, 1)) \
                    if hp["use_spk_id"] else None
                gender = np.tile(self.gender_mix_embed(0.0), (b, 1, 1)) \
                    if hp.get("use_gender_id", False) else None
                curve = {
                    name: np.full((b, t_mel), db, np.float32)
                    if hp.get(f"use_{name}_embed", False) else None
                    for name, db in (("voicing", -10.0), ("breath", -50.0))
                }
                self._acoustic(
                    np.zeros((b, t_ph)), np.zeros((b, t_mel)), np.zeros((b, t_mel)),
                    np.zeros((b, t_ph)) if hp["use_lang_id"] else None,
                    mix, gender, curve["voicing"], curve["breath"],
                )
                self._vocode(
                    np.full((b, t_mel, hp["audio_num_mel_bins"]), MEL_PAD_LOG10, np.float32),
                    np.zeros((b, t_mel), np.float32),
                )
                done.append((b, t_ph, t_mel))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return done

    # ---- per segment ---------------------------------------------------------

    def get_ph_text(self, ph: str, lang: Optional[str]) -> str:
        if not self.hparams["use_lang_id"]:
            return ph
        return f"{ph}/{lang}" if "/" not in ph else ph

    def _variance_curve(self, segment: dict, key: str, mel_len: int, default_db: float) -> np.ndarray:
        if key in segment:
            curve = np.array([float(x) for x in segment[key].split()], np.float32)
            ts = float(segment.get(f"{key}_timestep", self.timestep))
            return resample_align_curve(curve, ts, self.timestep, mel_len)
        return np.full(mel_len, default_db, np.float32)

    def prepare(self, segment: dict) -> dict:
        """Host-side front end for one segment: phoneme ids, durations ->
        mel2ph, pitch, mixes, variance curves (unpadded)."""
        hp = self.hparams
        lang = segment.get("lang", None)
        ph_text_seq = [self.ph_map[self.get_ph_text(ph, lang)] for ph in segment["ph_seq"].split()]
        ph_tokens = np.asarray(self.ph_encoder.encode(ph_text_seq), np.int64)
        ph_dur = np.array(segment["ph_dur"].split(), np.float32)
        # mel2ph via the cumsum-round trick (reference handler.py:238-240)
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        durations = np.diff(ph_acc, prepend=0)
        mel_len = int(durations.sum())
        mel2ph = np.repeat(np.arange(1, len(ph_tokens) + 1), durations).astype(np.int64)
        f0_seq = resample_align_curve(
            np.array(segment["f0_seq"].split(), np.float32),
            original_timestep=float(segment["f0_timestep"]),
            target_timestep=self.timestep, align_length=mel_len,
        )
        if segment.get("keyshift", 0):
            f0_seq = shift_pitch(f0_seq, segment["keyshift"]).astype(np.float32)
        return {
            "ph_tokens": ph_tokens,
            "t_ph": len(ph_tokens),
            "mel2ph": mel2ph,
            "mel_len": mel_len,
            "f0_seq": f0_seq,
            "lang_id": self.lang_map[lang] if hp["use_lang_id"] else None,
            "spk_mix_embed": self.spk_mix_embed(self.get_speaker_mix(segment.get("spk_name")))
            if hp["use_spk_id"] else None,
            "gender_mix_embed": self.gender_mix_embed(float(segment.get("gender", 0)))
            if hp.get("use_gender_id", False) else None,
            "voicing": self._variance_curve(segment, "voicing", mel_len, -10.0)
            if hp.get("use_voicing_embed", False) else None,
            "breath": self._variance_curve(segment, "breath", mel_len, -50.0)
            if hp.get("use_breath_embed", False) else None,
        }

    def render_batch(self, prepared: List[dict]) -> List[np.ndarray]:
        """Render prepared segments, one acoustic + one vocoder pass per padded
        ``(T_ph, T_mel)`` bucket group; wavs trimmed to true length, in order."""
        hp = self.hparams
        max_b = int(hp.get("infer_batch_size", 8))
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(prepared):
            key = (round_up(p["t_ph"], 16), round_up(p["mel_len"], self.mel_bucket))
            groups.setdefault(key, []).append(i)

        wavs: List[Optional[np.ndarray]] = [None] * len(prepared)
        for (t_ph_pad, t_mel_pad), idxs in groups.items():
            for chunk in [idxs[i: i + max_b] for i in range(0, len(idxs), max_b)]:
                batch = [prepared[i] for i in chunk]
                b = len(batch)
                ph_p = np.zeros((b, t_ph_pad), np.int64)
                mel2ph_p = np.zeros((b, t_mel_pad), np.int64)
                f0_p = np.zeros((b, t_mel_pad), np.float32)
                lang_p = np.zeros((b, t_ph_pad), np.int64) if hp["use_lang_id"] else None
                curves = {name: np.zeros((b, t_mel_pad), np.float32)
                          for name in ("voicing", "breath") if batch[0][name] is not None}
                for r, p in enumerate(batch):
                    ph_p[r, : p["t_ph"]] = p["ph_tokens"]
                    mel2ph_p[r, : p["mel_len"]] = p["mel2ph"][: p["mel_len"]]
                    f0_p[r, : p["mel_len"]] = p["f0_seq"][: p["mel_len"]]
                    if lang_p is not None:
                        lang_p[r, : p["t_ph"]] = p["lang_id"]
                    for name, arr in curves.items():
                        arr[r, : p["mel_len"]] = p[name][: p["mel_len"]]

                def stack_mix(key):
                    if batch[0][key] is None:
                        return None
                    return np.concatenate([p[key] for p in batch], axis=0)

                start = time.time()
                mel_out = self._acoustic(
                    ph_p, mel2ph_p, f0_p, lang_p, stack_mix("spk_mix_embed"),
                    stack_mix("gender_mix_embed"), curves.get("voicing"), curves.get("breath"),
                )
                # vocode on the padded grid (pad with the silence floor), trim after
                mel_voc = torch.full_like(mel_out, MEL_PAD_LOG10)
                for r, p in enumerate(batch):
                    mel_voc[r, : p["mel_len"]] = mel_out[r, : p["mel_len"]]
                wav_b = self._vocode(mel_voc, f0_p).cpu().numpy()
                print(f"Inference Time: {time.time() - start:.3f}s "
                      f"({b} segment(s) @ T_mel {t_mel_pad})")
                for r, i in enumerate(chunk):
                    wavs[i] = wav_b[r, : prepared[i]["mel_len"] * self.hop_size]
        return wavs

    def infer(self, segment: dict) -> np.ndarray:
        return self.render_batch([self.prepare(segment)])[0]

    # ---- project level -------------------------------------------------------

    def handle(self, proj: Optional[List[dict]] = None, proj_fn: Optional[str] = None,
               spk_name=None, lang=None, keyshift=0, gender=0) -> List[str]:
        """Render a .ds project (list of segments) into one wav under
        ``out_dir``; returns the written path(s)."""
        if proj is None:
            with open(proj_fn, encoding="utf-8") as f:
                proj = json.load(f)
        for segment in proj:
            segment.setdefault("lang", lang)
            segment.setdefault("keyshift", int(keyshift))
            segment.setdefault("spk_name", spk_name)
            segment["gender"] = float(gender)
        if self.hparams.get("batch_segments", True):
            outs = self.render_batch([self.prepare(seg) for seg in proj])
        else:
            outs = [self.infer(seg) for seg in proj]
        result = np.zeros(0)
        total_length = 0
        for segment, part in zip(proj, outs):
            offset = round(segment.get("offset", 0) * self.audio_sample_rate) - total_length
            if offset >= 0:
                result = np.concatenate([result, np.zeros(offset), part])
            else:
                result = cross_fade(result, part, total_length + offset)
            total_length += offset + part.shape[0]
        os.makedirs(self.out_dir, exist_ok=True)
        title = os.path.splitext(os.path.basename(proj_fn or "out"))[0]
        out_fn = os.path.join(self.out_dir, f"{title}【{self.hparams.get('exp_name', 'exp')}】.wav")
        save_wav(result, out_fn, self.audio_sample_rate)
        return [out_fn]
