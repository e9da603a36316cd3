"""The auxiliary predictors' inferers (port of ``prodiff_tpu/infer/inferers.py``).

Each loads its model from ``checkpoints/{exp}/{task}`` when the experiment
has a predictor of its own, else from the global ``checkpoints/{task}``
(:func:`~prodiff_tpu_torch.config.predictor_hparams`), reading the newest
JAX-package checkpoint without JAX. Inputs are padded to buckets as in the
JAX package: 16 for phonemes and notes, ``length_bucket_step`` for frames;
notes pad with midi -1 (the note encoder's padding) and rest True, the
frame curves with their last value. The pitch and variance predictors draw
their noise from a ``torch.Generator`` seeded with ``hparams["seed"]`` at
the padded shape, as the JAX inferers do with their PRNG key (the draws
differ between the packages; ``init_noise``/``step_noises`` inject them).

- :class:`DurPredictorInferer` (``dur``): phoneme durations in seconds,
  force-aligned to the note durations (:meth:`force_align_pdur`).
- :class:`PitchPredictorInferer` (``pitch``): the f0 curve in MIDI, the base
  melody plus the predicted delta.
- :class:`VariPredictorInferer` (``vari``): one variance curve (voicing or
  breath, dB). Where the model has a speaker embed (``use_spk_id``, the base
  config's default) it reads speaker 0: the JAX inferer passes no speaker
  id and raises there.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from prodiff_tpu_torch.binarize.pitch_predictor import base_pitch_curve
from prodiff_tpu_torch.data.collate import round_up
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.ops.seq import dur_to_mel2ph_host
from prodiff_tpu_torch.utils.convert import (
    dur_predictor_state_dict,
    last_checkpoint_path,
    load_flax_checkpoint,
    pitch_predictor_state_dict,
    vari_predictor_state_dict,
)
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder

INFERERS: Dict[str, type] = {}


def register_inferer(cls):
    INFERERS[cls.category] = cls
    return cls


def get_inferer_cls(task: str):
    """The inferer registered under ``task`` (``dur``, ``pitch``, ``vari``)."""
    if task not in INFERERS:
        raise ValueError(f"Inferer {task} not found in {sorted(INFERERS)}")
    return INFERERS[task]


def pad1(x, t_pad: int, value=0) -> np.ndarray:
    """Right-pad a 1-D array to ``t_pad`` with ``value``."""
    x = np.asarray(x)
    return np.pad(x, (0, t_pad - x.shape[0]), constant_values=value)


def find_asset(hparams: dict, name: str) -> str:
    """``name`` in the work dir, else in the binarized data dir's task folder."""
    for root in (hparams.get("work_dir", ""),
                 os.path.join(hparams.get("data_dir", ""), hparams.get("task") or "")):
        path = os.path.join(root, name)
        if root and os.path.exists(path):
            return path
    raise FileNotFoundError(f"{name} not found in work_dir or data_dir for this task")


def _phone_set_encoder(hparams: dict) -> TokenTextEncoder:
    with open(find_asset(hparams, "phone_set.json")) as f:
        return TokenTextEncoder(sorted(set(json.load(f).values())), replace_oov="SP")


def _load_model(model: torch.nn.Module, hparams: dict, to_state_dict: Callable,
                device: torch.device) -> torch.nn.Module:
    ckpt = last_checkpoint_path(hparams["work_dir"])
    if ckpt is None:
        raise FileNotFoundError(f"No checkpoint found in {hparams['work_dir']}")
    model.load_state_dict(to_state_dict(load_flax_checkpoint(ckpt)["state_dict"], hparams))
    return model.to(device).eval()


def _generator(hparams: dict, device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(hparams.get("seed", 1234)))


@register_inferer
class DurPredictorInferer:
    category = "dur"

    def __init__(self, hparams: dict, ph_encoder: TokenTextEncoder, device=None):
        from prodiff_tpu_torch.models.duration import DurPredictor

        self.hparams, self.device = hparams, resolve_device(device)
        # the vocabulary the predictor was trained with (its own phone set),
        # else the caller's
        try:
            self.ph_encoder = _phone_set_encoder(hparams)
        except FileNotFoundError:
            self.ph_encoder = ph_encoder
        self.model = _load_model(DurPredictor(len(self.ph_encoder), hparams), hparams,
                                 dur_predictor_state_dict, self.device)

    @classmethod
    def from_workdir(cls, exp_name: str, checkpoints_root: str, ph_encoder, device=None):
        from prodiff_tpu_torch.config import predictor_hparams

        return cls(predictor_hparams(exp_name, "dur", checkpoints_root), ph_encoder, device)

    def encode(self, ph_text_list: List[str]) -> np.ndarray:
        return np.asarray(self.ph_encoder.encode(ph_text_list), np.int64)

    def model_inputs(self, ph_tokens: np.ndarray, ph_num: List[int], note_dur: List[float]):
        """(tokens, onset, word_dur), each [1, T_ph padded to 16]."""
        ph_num = np.asarray(ph_num, np.int64)
        ph2word = np.repeat(np.arange(1, len(ph_num) + 1), ph_num)
        onset = np.diff(ph2word, prepend=0)
        word_dur = np.concatenate([[0.0], np.asarray(note_dur, np.float32)])[ph2word]
        t_pad = round_up(len(ph_tokens), 16)
        return (pad1(ph_tokens, t_pad)[None].astype(np.int64), pad1(onset, t_pad)[None],
                pad1(word_dur, t_pad)[None].astype(np.float32))

    @torch.no_grad()
    def run(self, ph_tokens: np.ndarray, ph_num: List[int], note_dur: List[float]) -> np.ndarray:
        """-> per-phoneme durations in seconds, force-aligned to the note
        durations (``ph_num`` phonemes a word, one note duration a word)."""
        tokens, onset, word_dur = (torch.as_tensor(a, device=self.device)
                                   for a in self.model_inputs(ph_tokens, ph_num, note_dur))
        dur = self.model(tokens, onset, word_dur, infer=True)[0, :len(ph_tokens)].cpu().numpy()
        return self.force_align_pdur(ph_num, dur, np.asarray(note_dur))

    @staticmethod
    def force_align_pdur(ph_num, ph_dur, note_dur) -> np.ndarray:
        """Rescale each word's phoneme durations to sum to its note duration;
        a word predicted all zero (sum < 1e-6) splits its note evenly."""
        ph_num = np.asarray(ph_num, np.int64)
        ph2word0 = np.repeat(np.arange(len(ph_num)), ph_num)
        word_sums = np.zeros(len(ph_num), np.float64)
        np.add.at(word_sums, ph2word0, ph_dur)
        note_dur = np.asarray(note_dur, np.float64)
        degenerate = word_sums < 1e-6
        uniform = (note_dur / np.maximum(ph_num, 1))[ph2word0]
        rate = word_sums / np.maximum(note_dur, 1e-9)
        out = np.where(degenerate[ph2word0], uniform, ph_dur / np.maximum(rate[ph2word0], 1e-9))
        out[~np.isfinite(out)] = 0
        return out.astype(np.float32)


def _note_inputs(hparams: dict, note_midi, note_rest, mel2note, mel_len: int) -> dict:
    """The note grid padded: notes to 16, frames to ``length_bucket_step``."""
    t_note_pad = round_up(len(note_midi), 16)
    t_mel_pad = round_up(mel_len, hparams.get("length_bucket_step", 128))
    return {"note_midi": pad1(note_midi, t_note_pad, -1.0)[None].astype(np.float32),
            "note_rest": pad1(note_rest, t_note_pad, True)[None].astype(bool),
            "mel2note": pad1(mel2note[:mel_len], t_mel_pad)[None].astype(np.int64)}


def _tensors(inputs: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}


@register_inferer
class PitchPredictorInferer:
    category = "pitch"

    def __init__(self, hparams: dict, device=None):
        from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor

        self.hparams, self.device = hparams, resolve_device(device)
        with open(find_asset(hparams, "ph_category_list.json")) as f:
            self.ph_category_encoder = TokenTextEncoder(json.load(f), replace_oov="SP")
        self.ph2category = self._build_ph2category(hparams)
        self.model = _load_model(PitchPredictor(len(self.ph_category_encoder), hparams), hparams,
                                 pitch_predictor_state_dict, self.device)
        self.midi_smooth_kernel = round(0.06 / (hparams["hop_size"] / hparams["audio_sample_rate"]))

    @classmethod
    def from_workdir(cls, exp_name: str, checkpoints_root: str, device=None):
        from prodiff_tpu_torch.config import predictor_hparams

        return cls(predictor_hparams(exp_name, "pitch", checkpoints_root), device)

    @staticmethod
    def _build_ph2category(hparams: dict) -> dict:
        ph2category = {}
        try:
            for lang in hparams.get("languages", {}):
                ph2category[lang] = {"AP": "AP", "SP": "SP"}
                with open(hparams["dictionary"][lang]["phoneme"]) as f:
                    for x in f.readlines():
                        line = x.split("\n")[0].split(" ")
                        ph2category[lang][line[0]] = line[2]
        except (FileNotFoundError, KeyError, IndexError):
            print("| pitch inferer: dictionary unavailable; using SP categories")
        return ph2category

    def encode_ph_categories(self, ph_seq: List[str], lang: str) -> np.ndarray:
        cats = [self.ph2category.get(lang, {}).get(ph.split("/")[0], "SP") for ph in ph_seq]
        return np.asarray(self.ph_category_encoder.encode(cats), np.int64)

    def model_inputs(self, note_midi, note_rest, note_dur_sec, mel_len: int, timestep: float,
                     spk_id: int = 0, pitch_expr: float = 1.0, ph_tokens=None, mel2ph=None):
        """(padded model inputs, the unpadded base melody [mel_len]); without
        phonemes each note is one ``SP``-category token."""
        mel2note = dur_to_mel2ph_host(note_dur_sec, timestep, mel_len)
        base_pitch = base_pitch_curve(note_midi, mel2note, self.midi_smooth_kernel)
        if ph_tokens is None:
            ph_tokens = np.full(len(note_midi), self.ph_category_encoder.id("SP"), np.int64)
            mel2ph = mel2note
        inputs = _note_inputs(self.hparams, note_midi, note_rest, mel2note, mel_len)
        t_mel_pad = inputs["mel2note"].shape[1]
        inputs.update(
            txt_tokens=pad1(ph_tokens, round_up(len(ph_tokens), 16))[None].astype(np.int64),
            mel2ph=pad1(mel2ph[:mel_len], t_mel_pad)[None].astype(np.int64),
            base_pitch=pad1(base_pitch[:mel_len], t_mel_pad,
                            float(base_pitch[mel_len - 1]))[None].astype(np.float32),
            pitch_expr=np.full((1, 1), pitch_expr, np.float32),
            spk_id=np.asarray([spk_id], np.int64))
        return inputs, base_pitch[:mel_len]

    @torch.no_grad()
    def run(self, note_midi, note_rest, note_dur_sec, mel_len: int, timestep: float,
            spk_id: int = 0, pitch_expr: float = 1.0, ph_tokens=None, mel2ph=None,
            init_noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """-> the f0 curve in MIDI (base melody + predicted delta), [mel_len]."""
        inputs, base_pitch = self.model_inputs(note_midi, note_rest, note_dur_sec, mel_len,
                                               timestep, spk_id, pitch_expr, ph_tokens, mel2ph)
        t = _tensors(inputs, self.device)
        delta = self.model.infer(
            t["txt_tokens"], t["mel2ph"], t["note_midi"], t["note_rest"], t["mel2note"],
            t["base_pitch"], infer_step=int(self.hparams.get("sampling_steps", 20)),
            init_noise=init_noise, generator=_generator(self.hparams, self.device),
            pitch_expr=t["pitch_expr"], spk_id=t["spk_id"])
        return base_pitch + delta[0, :mel_len].cpu().numpy()


@register_inferer
class VariPredictorInferer:
    category = "vari"

    def __init__(self, hparams: dict, feature: str, device=None):
        from prodiff_tpu_torch.models.vari_predictor import VariPredictor

        self.hparams, self.feature, self.device = hparams, feature, resolve_device(device)
        self.ph_encoder = _phone_set_encoder(hparams)
        self.model = _load_model(VariPredictor(len(self.ph_encoder), hparams), hparams,
                                 vari_predictor_state_dict, self.device)

    @classmethod
    def from_workdir(cls, exp_name: str, checkpoints_root: str, feature: str, device=None):
        from prodiff_tpu_torch.config import predictor_hparams

        return cls(predictor_hparams(exp_name, feature, checkpoints_root), feature, device)

    def model_inputs(self, note_midi, note_rest, note_dur_sec, mel_len: int, timestep: float,
                     f0_seq) -> dict:
        """The padded model inputs: each note one ``SP`` token, mel2ph =
        mel2note, f0 [Hz] padded with its last value."""
        mel2note = dur_to_mel2ph_host(note_dur_sec, timestep, mel_len)
        inputs = _note_inputs(self.hparams, note_midi, note_rest, mel2note, mel_len)
        t_mel_pad = inputs["mel2note"].shape[1]
        inputs.update(
            txt_tokens=pad1(np.full(len(note_midi), self.ph_encoder.id("SP"), np.int64),
                            inputs["note_midi"].shape[1])[None],
            mel2ph=inputs["mel2note"],
            f0=pad1(f0_seq[:mel_len], t_mel_pad, float(f0_seq[mel_len - 1]))[None].astype(
                np.float32))
        if self.model.with_spk_embed:
            inputs["spk_embed_id"] = np.zeros(1, np.int64)
        return inputs

    @torch.no_grad()
    def run(self, note_midi, note_rest, note_dur_sec, mel_len: int, timestep: float, f0_seq,
            init_noise: Optional[torch.Tensor] = None,
            step_noises: Optional[torch.Tensor] = None) -> np.ndarray:
        """-> this inferer's curve, [mel_len] (the model's default 4 steps,
        as the JAX inferer samples)."""
        t = _tensors(self.model_inputs(note_midi, note_rest, note_dur_sec, mel_len, timestep,
                                       f0_seq), self.device)
        curves = self.model.infer(
            t["txt_tokens"], t["mel2ph"], t["note_midi"], t["note_rest"], t["mel2note"], t["f0"],
            spk_embed_id=t.get("spk_embed_id"), init_noise=init_noise, step_noises=step_noises,
            generator=_generator(self.hparams, self.device))
        return curves[self.feature][0, :mel_len].cpu().numpy()
