"""The variance-predictor binarizer (port of
``prodiff_tpu/binarize/vari_predictor.py``): the f0 of the configured pitch
extractor, mel2ph, mel2note, the note midi with rests interpolated and the
rest mask, and the voicing, breath and tension curves of the VR model's
harmonic/aperiodic split (0.12 s smoothing), the split on the binarizer's
device."""

from __future__ import annotations

import json

import numpy as np

from prodiff_tpu_torch.binarize import Binarizer, register_binarizer
from prodiff_tpu_torch.binarize.pitch_predictor import interp_note_midi
from prodiff_tpu_torch.binarize.svs import variance_features
from prodiff_tpu_torch.binarize.utils import build_lang_map, build_phone_encoder, build_spk_map
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.ops.seq import dur_to_mel2ph_host
from prodiff_tpu_torch.utils.audio import load_wav


@register_binarizer
class VariPredictorBinarizer(Binarizer):
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
        self.pe = get_pe_cls(hparams["pitch_extractor"])(hparams, device=self.device)
        self.samplerate = hparams["audio_sample_rate"]
        self.hop_size, self.win_size = hparams["hop_size"], hparams["win_size"]
        self.timestep = self.hop_size / self.samplerate
        self.need_voicing = args.get("with_voicing", False)
        self.need_breath = args.get("with_breath", False)
        self.need_tension = args.get("with_tension", False)
        self.smooth_kernel = round(0.12 / self.timestep)

    @staticmethod
    def category():
        return "vari"

    def load_meta_data(self) -> list:
        items = []
        for dataset in self.datasets:
            data_dir, lang = dataset["data_dir"], dataset["language"]
            spk_id = self.spk_map[dataset["speaker"]] if self.need_spk_id else None
            lang_id = self.lang_map[lang] if self.need_lang_id else None
            with open(f"{data_dir}/label.json", encoding="utf-8") as f:
                labels = json.load(f)
            for item_name, label in labels.items():
                if "note_seq" not in label or "note_dur" not in label:
                    raise ValueError(f"item {item_name!r} lacks note_seq/note_dur; run "
                                     "`preprocess --extract_note` (with midi files) first")
                ph_seq = self.ph_encoder.encode(
                    [self.ph_map[f"{x}/{lang}"] for x in label["ph_seq"].split(" ")])
                item = {
                    "item_name": item_name,
                    "wav_fn": f"{data_dir}/wav/{item_name}.wav",
                    "ph_seq": ph_seq,
                    "ph_dur": [float(x) for x in label["ph_dur"].split(" ")],
                    "note_seq": label["note_seq"].split(" "),
                    "note_dur": [float(x) for x in label["note_dur"].split(" ")],
                }
                if self.need_spk_id:
                    item["spk_id"] = spk_id
                if self.need_lang_id:
                    item["lang_seq"] = [lang_id] * len(ph_seq)
                items.append(item)
        return items

    def process_item(self, item: dict) -> dict:
        hp = self.hparams
        out = {"ph_seq": np.asarray(item["ph_seq"], np.int64),
               "ph_dur": np.asarray(item["ph_dur"], np.float32)}
        waveform, _ = load_wav(item["wav_fn"], sr=self.samplerate)
        mel_len = round(len(waveform) / self.hop_size)
        if self.need_spk_id:
            out["spk_id"] = item["spk_id"]
        if self.need_lang_id:
            out["lang_seq"] = np.asarray(item["lang_seq"], np.int64)
        out["sec"] = len(waveform) / self.samplerate
        out["length"] = mel_len
        f0, uv = self.pe.get_pitch(waveform, samplerate=self.samplerate, length=mel_len,
                                   hop_size=self.hop_size, interp_uv=hp["interp_uv"])
        if uv.all():
            raise ValueError(f"all unvoiced: item {item.get('item_name')}, wav {item['wav_fn']}")
        out["f0"] = np.asarray(f0, np.float32)
        out["mel2ph"] = dur_to_mel2ph_host(item["ph_dur"], self.timestep, mel_len)
        out["mel2note"] = dur_to_mel2ph_host(item["note_dur"], self.timestep, mel_len)
        out["note_midi"], out["note_rest"] = interp_note_midi(item["note_seq"])
        out.update(variance_features(self, hp, waveform, mel_len, out["f0"]))
        return out
