"""The pitch-predictor binarizer (port of
``prodiff_tpu/binarize/pitch_predictor.py``): phonemes as articulatory
categories, mel2ph and mel2note from the label's durations, the f0 from
the configured pitch extractor (``pe/``: ``acf``, or ``parselmouth``, which
falls back to ACF without its library, or ``rmvpe``) in MIDI, the notes
with rests nearest-interpolated, and the smoothed base melody
(:func:`base_pitch_curve`, which the pitch inferer uses too)."""

from __future__ import annotations

import json

import numpy as np

from prodiff_tpu_torch.binarize import Binarizer, register_binarizer
from prodiff_tpu_torch.binarize.utils import (build_ph_category_encoder, build_spk_map,
                                              sinusoidal_smooth)
from prodiff_tpu_torch.ops.seq import dur_to_mel2ph_host
from prodiff_tpu_torch.utils.pitch_utils import hz_to_midi


def base_pitch_curve(note_midi, mel2note, smooth_kernel: int) -> np.ndarray:
    """Note midi gathered to frames (``mel2note`` 1-indexed, 0 = -1) then
    half-sine smoothed over ``smooth_kernel`` frames."""
    frame_pitch = np.concatenate([[-1.0], note_midi])[mel2note]
    return sinusoidal_smooth(frame_pitch.astype(np.float32), smooth_kernel)


def interp_note_midi(note_seq):
    """Note names -> (midi, rests nearest-interpolated from the sung notes;
    the rest mask)."""
    from prodiff_tpu_torch.infer.handler import interp_rest_midi, note_to_midi

    return interp_rest_midi(np.array([note_to_midi(n) if n != "rest" else -1.0
                                      for n in note_seq], dtype=np.float64))


@register_binarizer
class PitchPredictorBinarizer(Binarizer):
    def __init__(self, hparams: dict, device=None):
        from prodiff_tpu_torch.pe import get_pe_cls

        super().__init__(hparams, device)
        self.ph2category, self.ph_category_encoder = build_ph_category_encoder(
            self.data_dir, hparams["dictionary"], hparams["languages"])
        self.need_spk_id = hparams["binarization_args"].get("with_spk_id", True)
        if self.need_spk_id:
            self.spk_map = build_spk_map(self.data_dir, self.datasets)
        self.pe = get_pe_cls(hparams["pitch_extractor"])(hparams, device=device)
        self.samplerate = hparams["audio_sample_rate"]
        self.hop_size = hparams["hop_size"]
        self.timestep = self.hop_size / self.samplerate
        self.midi_smooth_kernel = round(0.06 / self.timestep)

    @staticmethod
    def category():
        return "pitch"

    def load_meta_data(self) -> list:
        items = []
        for dataset in self.datasets:
            data_dir, lang = dataset["data_dir"], dataset["language"]
            spk_id = self.spk_map[dataset["speaker"]] if self.need_spk_id else None
            with open(f"{data_dir}/label.json", encoding="utf-8") as f:
                labels = json.load(f)
            for item_name, label in labels.items():
                if "note_seq" not in label or "note_dur" not in label:
                    raise ValueError(f"item {item_name!r} lacks note_seq/note_dur")
                ph_text = [self.ph2category[lang][ph] for ph in label["ph_seq"].split(" ")]
                item = {
                    "item_name": item_name,
                    "wav_fn": f"{data_dir}/wav/{item_name}.wav",
                    "ph_seq": self.ph_category_encoder.encode(ph_text),
                    "ph_dur": [float(x) for x in label["ph_dur"].split(" ")],
                    "note_seq": label["note_seq"].split(" "),
                    "note_dur": [float(x) for x in label["note_dur"].split(" ")],
                }
                if self.need_spk_id:
                    item["spk_id"] = spk_id
                items.append(item)
        return items

    def process_item(self, item: dict) -> dict:
        from prodiff_tpu_torch.utils.audio import load_wav

        out = {"ph_seq": np.asarray(item["ph_seq"], np.int64),
               "ph_dur": np.asarray(item["ph_dur"], np.float32)}
        waveform, _ = load_wav(item["wav_fn"], sr=self.samplerate)
        mel_len = round(len(waveform) / self.hop_size)
        out["mel2ph"] = dur_to_mel2ph_host(item["ph_dur"], self.timestep, mel_len)
        out["sec"] = len(waveform) / self.samplerate
        out["length"] = mel_len
        if self.need_spk_id:
            out["spk_id"] = item["spk_id"]
        f0, uv = self.pe.get_pitch(waveform, samplerate=self.samplerate, length=mel_len,
                                   hop_size=self.hop_size, interp_uv=self.hparams["interp_uv"])
        if uv.all():
            raise ValueError(f"all unvoiced: item {item.get('item_name')}, wav {item['wav_fn']}")
        out["pitch"] = hz_to_midi(np.asarray(f0, np.float32)).astype(np.float32)
        mel2note = dur_to_mel2ph_host(item["note_dur"], self.timestep, mel_len)
        out["mel2note"] = mel2note
        note_midi, note_rest = interp_note_midi(item["note_seq"])
        out["note_midi"] = note_midi
        out["note_rest"] = note_rest
        out["base_pitch"] = base_pitch_curve(note_midi, mel2note, self.midi_smooth_kernel)
        return out
