"""Preprocess: TextGrid alignments (+ optional MIDI) -> label.json (the port's
copy of ``prodiff_tpu/preprocess.py``; plain Python, no device code).

Mirrors the reference (``handler/preprocess/handler.py:13-107``): read the
"phone" tier of each TextGrid into {ph_seq, ph_dur}; derive ph_num
(phonemes-per-word, consonants attach to the previous word); attach
note_seq/note_dur from pickled ``.rawmid`` files (MIDI numbers -> note names
with cent offsets, ``rest`` passthrough).

Includes a dependency-free TextGrid parser (long and short ooTextFile forms).
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, List, Tuple

NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def midi_to_note_name(midi: int) -> str:
    midi = int(round(midi))
    return f"{NOTE_NAMES[midi % 12]}{midi // 12 - 1}"


def parse_textgrid(path: str) -> Dict[str, List[Tuple[float, float, str]]]:
    """Parse a Praat TextGrid (long or short text form) into
    {tier_name: [(xmin, xmax, text), ...]} for interval tiers."""
    with open(path, encoding="utf-8-sig", errors="replace") as f:
        content = f.read()
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    if re.search(r'item\s*\[', content):  # long form
        for m in re.finditer(
            r'class = "IntervalTier"\s*\n\s*name = "(?P<name>[^"]*)"(?P<body>.*?)'
            r"(?=(?:\n\s*item \[)|\Z)",
            content,
            re.S,
        ):
            intervals = []
            for im in re.finditer(
                r"intervals \[\d+\]:?\s*\n\s*xmin = ([\d.eE+-]+)\s*\n\s*"
                r'xmax = ([\d.eE+-]+)\s*\n\s*text = "((?:[^"]|"")*)"',
                m.group("body"),
            ):
                intervals.append(
                    (float(im.group(1)), float(im.group(2)), im.group(3).replace('""', '"'))
                )
            tiers[m.group("name")] = intervals
    else:  # short form
        lines = [l.strip() for l in content.splitlines() if l.strip()]
        i = 0
        while i < len(lines):
            if lines[i] == '"IntervalTier"':
                name = lines[i + 1].strip('"')
                n = int(lines[i + 4])
                intervals = []
                j = i + 5
                for _ in range(n):
                    intervals.append(
                        (float(lines[j]), float(lines[j + 1]), lines[j + 2].strip('"'))
                    )
                    j += 3
                tiers[name] = intervals
                i = j
            else:
                i += 1
    return tiers


class PreprocessHandler:
    def __init__(self, data_dir: str, lang: str, dictionary_root: str = "dictionary"):
        self.data_dir = data_dir
        self.lang = lang
        self.dictionary_root = dictionary_root

    def textgrid_to_label(self) -> Dict[str, dict]:
        tg_dir = f"{self.data_dir}/TextGrid"
        label = {}
        for tg_fn in sorted(os.listdir(tg_dir)):
            if not tg_fn.endswith(".TextGrid"):
                continue
            tiers = parse_textgrid(f"{tg_dir}/{tg_fn}")
            if "phone" not in tiers:
                raise ValueError(f"no 'phone' tier in {tg_fn}")
            name = tg_fn.replace(".TextGrid", "")
            ph_seq, ph_dur = [], []
            for xmin, xmax, mark in tiers["phone"]:
                ph_seq.append(mark)
                ph_dur.append(f"{xmax - xmin:.4f}")
            label[name] = {"ph_seq": " ".join(ph_seq), "ph_dur": " ".join(ph_dur)}
        return label

    def add_ph_num_label(self, labels: Dict[str, dict], override=False):
        dictionary_fn = f"{self.dictionary_root}/{self.lang}_phones.txt"
        c_set, v_set = set(), {"AP", "SP"}
        with open(dictionary_fn, encoding="utf-8") as f:
            for x in f.readlines():
                line = x.split("\n")[0].split(" ")
                ph, ph_type = line[0], line[1]
                (c_set if ph_type == "consonant" else v_set).add(ph)
        for label in labels.values():
            if "ph_num" in label and not override:
                continue
            ph_num: List[int] = []
            for i, ph in enumerate(label["ph_seq"].split(" ")):
                if ph in v_set or i == 0:
                    ph_num.append(1)
                else:
                    ph_num[-1] += 1
            label["ph_num"] = " ".join(map(str, ph_num))

    def cal_note_seq(self, note_midi: float, note_rest: bool) -> str:
        if note_rest:
            return "rest"
        midi_num = round(note_midi, 0)
        cent = int(round(note_midi - midi_num, 2) * 100)
        cent_str = f"+{cent}" if cent > 0 else (str(cent) if cent < 0 else "")
        return f"{midi_to_note_name(midi_num)}{cent_str}"

    def add_note_midi_label(self, labels: Dict[str, dict], override=False):
        rawmidi_dir = f"{self.data_dir}/midi"
        for item_name, label in labels.items():
            if "note_seq" in label and not override:
                continue
            with open(f"{rawmidi_dir}/{item_name}.rawmid", "rb") as f:
                raw_midi = pickle.loads(f.read())
            note_seq = [
                self.cal_note_seq(midi, rest)
                for midi, rest in zip(raw_midi["note_midi"], raw_midi["note_rest"])
            ]
            note_dur = [f"{x:.4f}" for x in raw_midi["note_dur"]]
            label["note_seq"] = " ".join(note_seq)
            label["note_dur"] = " ".join(note_dur)

    def handle(self, extract_note=False, override_ph_num=False,
               override_note_midi=False, override_ori_label=False):
        tgt_label_fn = (
            f"{self.data_dir}/label.json"
            if override_ori_label
            else f"{self.data_dir}/label_new.json"
        )
        print("1. build label.json")
        if os.path.exists(f"{self.data_dir}/label.json"):
            print("label.json already exists, skip textgrid_to_label")
            with open(f"{self.data_dir}/label.json", encoding="utf-8") as f:
                labels = json.load(f)
        else:
            labels = self.textgrid_to_label()
        if not extract_note:
            with open(tgt_label_fn, "w", encoding="utf-8") as f:
                json.dump(labels, f, indent=4, ensure_ascii=False)
            print("preprocess is done, label.json is saved")
            return
        print("2. add ph_num to label.json")
        if all("ph_num" in l for l in labels.values()) and not override_ph_num:
            print("ph_num already exists, skip")
        else:
            if self.lang not in ["zh", "jp"]:
                print("auto process only supports zh and jp, exit")
                return
            self.add_ph_num_label(labels, override_ph_num)
        print("3. add note_midi to label.json")
        if all("note_seq" in l for l in labels.values()) and not override_note_midi:
            print("note_seq already exists, skip")
        else:
            self.add_note_midi_label(labels, override_note_midi)
        with open(tgt_label_fn, "w", encoding="utf-8") as f:
            json.dump(labels, f, indent=4, ensure_ascii=False)
        print("preprocess is done, label.json is saved")
