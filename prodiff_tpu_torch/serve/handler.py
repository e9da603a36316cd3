"""Web serving on a stdlib HTTP server (port of ``prodiff_tpu/serve/handler.py``).

- ``GET  /api/basic_info`` -> languages / speakers / hop / sample rate /
  pitch styles (the pitch predictor's ``spk_map.json``)
- ``POST /api/pred_dur``   -> words + word durations -> per-phoneme timings
  (words to phonemes through ``hparams["dictionary"]``)
- ``POST /api/pred_pitch`` -> notes + phonemes -> pitch curve (MIDI)
- ``POST /api/infer``      -> phonemes, durations, pitch -> wav samples; with
  both ``voicing_list`` and ``breath_list`` (dB gains on the frame grid),
  the VR model's harmonic part scaled by ``10**(voicing * 0.05)`` and its
  aperiodic part by ``10**(breath * 0.05)``, summed

The duration and pitch predictors load with the server where the
experiment has them (its own, or the global ``checkpoints/{task}``); a
route whose predictor did not load answers 400, as the JAX server's assert
does. Requests run one at a time: the device work is serialised by a lock,
while the HTTP threads parse and encode concurrently. A malformed request
(``BadRequest``) answers 400; any other failure, a kernel's own contract
check included, answers 500. The VR gain is skipped, with a log line and
the raw wav, only where ``vr_ckpt`` names no file, as the JAX server does
without a VR model; where the gain fails the JAX server answers the raw
wav, the port 500.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from itertools import chain
from typing import List, Optional

import numpy as np

from prodiff_tpu_torch.infer.handler import SVSInferHandler, interp_rest_midi
from prodiff_tpu_torch.infer.inferers import DurPredictorInferer, PitchPredictorInferer
from prodiff_tpu_torch.utils.pitch_utils import midi_to_hz, resample_align_curve


class BadRequest(Exception):
    """A request the client has to fix (HTTP 400)."""


def _numbers(req: dict, key: str) -> np.ndarray:
    try:
        arr = np.asarray(req[key], np.float64)
    except (TypeError, ValueError):
        raise BadRequest(f"{key} must be a list of numbers") from None
    if arr.ndim != 1 or arr.size == 0 or not np.isfinite(arr).all():
        raise BadRequest(f"{key} must be a non-empty list of finite numbers")
    return arr


class WebHandler:
    def __init__(self, exp_name: Optional[str] = None, port: int = 7694, host: str = "localhost",
                 checkpoints_root: str = "checkpoints", device=None,
                 core: Optional[SVSInferHandler] = None):
        self.host, self.port = host, port
        self.core = core or SVSInferHandler(exp_name, checkpoints_root=checkpoints_root, device=device)
        self.hparams = self.core.hparams
        self.timestep = self.core.timestep
        self._render_lock = threading.Lock()
        self.dur_predictor = self.pitch_predictor = None
        self.pitch_pred_spk_map = {}
        if exp_name is not None:
            self._load_predictors(exp_name, checkpoints_root)
        self._build_word_dictionary()
        # warm start (opt out with `precompile: false`): build the kernels and
        # run one bucket before accepting requests
        if self.hparams.get("precompile", True):
            print(f"| web: warmed up {self.core.warmup()}")

    def _load_predictors(self, exp_name: str, checkpoints_root: str) -> None:
        """The optional predictors: one the experiment does not have (no
        config, phone set or checkpoint) is left out."""
        core = self.core
        try:
            self.dur_predictor = DurPredictorInferer.from_workdir(
                exp_name, checkpoints_root, core.ph_encoder, core.device)
        except FileNotFoundError as e:
            print(f"| web: dur predictor unavailable ({e})")
        try:
            self.pitch_predictor = PitchPredictorInferer.from_workdir(
                exp_name, checkpoints_root, core.device)
        except FileNotFoundError as e:
            print(f"| web: pitch predictor unavailable ({e})")
            return
        spk_map = os.path.join(self.pitch_predictor.hparams["work_dir"], "spk_map.json")
        if os.path.exists(spk_map):
            with open(spk_map) as f:
                self.pitch_pred_spk_map = json.load(f)

    def _build_word_dictionary(self) -> None:
        """Per language: word -> phonemes (``AP``/``SP`` and ``.{phoneme}``
        included) and the consonants, from ``hparams["dictionary"]``."""
        hp = self.hparams
        self.word_dictionary, self.consonant_set = {}, {}
        for lang in hp.get("languages", {}):
            self.word_dictionary[lang] = {"AP": ["AP"], "SP": ["SP"]}
            self.consonant_set[lang] = set()
            try:
                with open(hp["dictionary"][lang]["word"]) as f:
                    for x in f.readlines():
                        line = x.split("\n")[0].split("\t")
                        self.word_dictionary[lang][line[0]] = line[1].split(" ")
                with open(hp["dictionary"][lang]["phoneme"]) as f:
                    for x in f.readlines():
                        line = x.split("\n")[0].split(" ")
                        if line[1] == "consonant":
                            self.consonant_set[lang].add(line[0])
                        self.word_dictionary[lang][f".{line[0]}"] = [line[0]]
            except (FileNotFoundError, KeyError):
                print(f"| web: dictionary for {lang!r} unavailable")

    def get_ph_num_list(self, lang: str, word_ph_text_list: List[List[str]]) -> List[int]:
        """Phonemes a word; a word's leading consonant belongs to the word
        before it."""
        ph_num = [0] * len(word_ph_text_list)
        for i, ph_list in enumerate(word_ph_text_list):
            for ph_idx, ph in enumerate(ph_list):
                if ph_idx == 0 and ph in self.consonant_set.get(lang, set()) and i > 0:
                    ph_num[i - 1] += 1
                else:
                    ph_num[i] += 1
        return ph_num

    def api_basic_info(self, _req=None) -> dict:
        return {
            "languages": list(self.core.lang_map.keys()),
            "speakers": list(self.core.spk_map.keys()),
            "hop_size": self.hparams["hop_size"],
            "samplerate": self.hparams["audio_sample_rate"],
            "pitch_styles": list(self.pitch_pred_spk_map.keys()),
        }

    @staticmethod
    def _require(req: dict, keys) -> None:
        if not isinstance(req, dict):
            raise BadRequest("the request body must be a JSON object")
        for key in keys:
            if key not in req:
                raise BadRequest(f"{key} is required")

    def api_pred_dur(self, req: dict) -> dict:
        """Words (a padding ``SP`` of ``padding_note_time`` s first) -> each
        word's phonemes with start and end times."""
        self._require(req, ("language", "word_list", "word_dur_list", "start_time"))
        if self.dur_predictor is None:
            raise BadRequest("dur predictor not loaded")
        if not isinstance(req["word_list"], list) or \
                len(_numbers(req, "word_dur_list")) != len(req["word_list"]):
            raise BadRequest("word_dur_list must give one duration per word of word_list")
        core, lang, words = self.core, req["language"], self.word_dictionary.get(req["language"], {})
        word_list = ["SP"] + req["word_list"]
        word_ph_text_list = [words.get(w, ["SP"]) for w in word_list]
        ph_text_list = list(chain.from_iterable(
            [core.ph_map.get(core.get_ph_text(ph, lang), "SP") for ph in ph_list]
            for ph_list in word_ph_text_list))
        padding_note_time = req.get("padding_note_time", 0.5)
        with self._render_lock:
            ph_dur = self.dur_predictor.run(
                self.dur_predictor.encode(ph_text_list),
                self.get_ph_num_list(lang, word_ph_text_list),
                [padding_note_time] + req["word_dur_list"])
        start_time = req["start_time"] - padding_note_time
        ph_dur_list = [float(x) for x in ph_dur]
        note_ph_list, idx, ph_start = [], 0, start_time
        for i, word in enumerate(word_list[1:]):
            word_ph_num = len(words.get(word, ["SP"])) + (1 if i == 0 else 0)  # + the padding SP
            note_ph_list.append([])
            for j in range(idx, idx + word_ph_num):
                note_ph_list[-1].append({"ph": ph_text_list[j], "start_time": ph_start,
                                         "end_time": ph_start + ph_dur_list[j]})
                ph_start += ph_dur_list[j]
            idx += word_ph_num
        return {"start_time": start_time, "note_ph_list": note_ph_list}

    def api_pred_pitch(self, req: dict) -> dict:
        """Phonemes with durations and notes (midi, -1 a rest) -> the pitch
        curve in MIDI, one value a frame; ``style`` picks the pitch
        predictor's speaker."""
        self._require(req, ("language", "ph_text_list", "ph_dur_list", "note_midi_list",
                            "note_dur_list"))
        if self.pitch_predictor is None:
            raise BadRequest("pitch predictor not loaded")
        ph_dur, note_dur = _numbers(req, "ph_dur_list"), _numbers(req, "note_dur_list")
        if not isinstance(req["ph_text_list"], list) or len(ph_dur) != len(req["ph_text_list"]):
            raise BadRequest("ph_dur_list must give one duration per phoneme of ph_text_list")
        note_midi, note_rest = interp_rest_midi(_numbers(req, "note_midi_list"))
        if len(note_dur) != len(note_midi):
            raise BadRequest("note_dur_list must give one duration per note of note_midi_list")
        ph_tokens = self.pitch_predictor.encode_ph_categories(req["ph_text_list"],
                                                              req["language"])
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        durations = np.diff(ph_acc, prepend=0)
        mel_len = int(durations.sum())
        if mel_len < 1:
            raise BadRequest("ph_dur_list covers no mel frame")
        mel2ph = np.repeat(np.arange(1, len(ph_tokens) + 1), durations)
        with self._render_lock:
            pitch = self.pitch_predictor.run(
                note_midi, note_rest, note_dur, mel_len, self.timestep,
                spk_id=self.pitch_pred_spk_map.get(req.get("style", ""), 0),
                pitch_expr=float(req.get("pitch_expr", 1.0)), ph_tokens=ph_tokens,
                mel2ph=mel2ph)
        return {"pitch": [float(x) for x in pitch]}

    def _validate_infer(self, req: dict):
        """-> (phonemes, durations [s], f0 [Hz] over mel_len frames); raises
        ``BadRequest`` for anything the client sent wrong."""
        if not isinstance(req, dict):
            raise BadRequest("the request body must be a JSON object")
        for key in ("speaker", "language", "ph_text_list", "ph_dur_list", "pitch_list"):
            if key not in req:
                raise BadRequest(f"{key} is required")
        core, lang = self.core, req["language"]
        if core.hparams["use_lang_id"] and lang not in core.lang_map:
            raise BadRequest(f"unknown language {lang!r}")
        try:
            core.get_speaker_mix(req["speaker"])
        except (AttributeError, TypeError, ValueError) as e:
            raise BadRequest(f"speaker: {e}") from None
        phones = req["ph_text_list"]
        if not isinstance(phones, list) or not phones:
            raise BadRequest("ph_text_list must be a non-empty list of phonemes")
        for ph in phones:
            if not isinstance(ph, str) or core.get_ph_text(ph, lang) not in core.ph_map:
                raise BadRequest(f"unknown phoneme {ph!r}")
        ph_dur = _numbers(req, "ph_dur_list")
        if len(ph_dur) != len(phones) or (ph_dur < 0).any():
            raise BadRequest("ph_dur_list must give one non-negative duration per phoneme")
        ph_acc = np.round(np.cumsum(ph_dur) / self.timestep + 0.5).astype(np.int64)
        mel_len = int(np.diff(ph_acc, prepend=0).sum())
        if mel_len < 1:
            raise BadRequest("ph_dur_list covers no mel frame")
        f0 = midi_to_hz(_numbers(req, "pitch_list")).astype(np.float32)
        if len(f0) < mel_len:
            f0 = np.concatenate([f0, np.full(mel_len - len(f0), f0[-1], np.float32)])
        return phones, ph_dur, f0[:mel_len]

    def api_infer(self, req: dict) -> dict:
        phones, ph_dur, f0 = self._validate_infer(req)
        segment = {
            "ph_seq": " ".join(phones),
            "ph_dur": " ".join(str(float(x)) for x in ph_dur),
            "f0_seq": " ".join(str(float(x)) for x in f0),
            "f0_timestep": str(self.timestep),
            "lang": req["language"],
            "spk_name": req["speaker"],
        }
        with self._render_lock:
            wav = self.core.infer(segment)
            if "voicing_list" in req and "breath_list" in req:  # one key alone is ignored
                wav = self._vr_gain(req, wav)
        return {"wav": [float(x) for x in wav]}

    def _vr_gain(self, req: dict, wav: np.ndarray) -> np.ndarray:
        """``sp * 10**(voicing / 20) + ap * 10**(breath / 20)``, each curve
        resampled from the frame grid to the samples."""
        vr_ckpt = self.hparams.get("vr_ckpt")
        if not vr_ckpt or not os.path.isfile(vr_ckpt):
            print(f"| web: VR gain path unavailable (vr_ckpt {vr_ckpt!r} names no file); "
                  "returning raw wav")
            return wav
        from prodiff_tpu_torch.separation import extract_harmonic_aperiodic

        voicing, breath = _numbers(req, "voicing_list"), _numbers(req, "breath_list")
        sp, ap = extract_harmonic_aperiodic(wav, vr_ckpt, device=self.core.device)
        step = 1 / self.hparams["audio_sample_rate"]
        sp = sp * 10 ** (resample_align_curve(voicing, self.timestep, step, len(wav)) * 0.05)
        ap = ap * 10 ** (resample_align_curve(breath, self.timestep, step, len(wav)) * 0.05)
        return sp + ap

    def make_server(self) -> ThreadingHTTPServer:
        routes_get = {"/api/basic_info": self.api_basic_info}
        routes_post = {
            "/api/infer": self.api_infer,
            "/api/pred_dur": self.api_pred_dur,
            "/api/pred_pitch": self.api_pred_pitch,
        }

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, fn, read_body: bool):
                if fn is None:
                    return self._send(404, {"error": f"unknown route {self.path}"})
                try:
                    if read_body:
                        length = int(self.headers.get("Content-Length", 0))
                        try:
                            body = json.loads(self.rfile.read(length) or b"{}")
                        except ValueError as e:
                            raise BadRequest(f"the request body is not JSON: {e}") from None
                        result = fn(body)
                    else:
                        result = fn()
                except BadRequest as e:
                    return self._send(400, {"error": str(e)})
                except NotImplementedError as e:
                    return self._send(501, {"error": str(e)})
                except Exception as e:  # the server keeps running; the client gets the error
                    traceback.print_exc()
                    return self._send(500, {"error": str(e)})
                self._send(200, result)

            def do_GET(self):
                self._dispatch(routes_get.get(self.path), read_body=False)

            def do_POST(self):
                self._dispatch(routes_post.get(self.path), read_body=True)

            def log_message(self, fmt, *args):
                print(f"| web: {fmt % args}")

        return ThreadingHTTPServer((self.host, self.port), Handler)

    def handle(self):
        server = self.make_server()
        print(f"| web server on http://{self.host}:{server.server_address[1]}")
        try:
            server.serve_forever()
        finally:
            server.server_close()
