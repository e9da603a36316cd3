"""Web serving on a stdlib HTTP server (port of ``prodiff_tpu/serve/handler.py``).

- ``GET  /api/basic_info`` -> languages / speakers / hop / sample rate / pitch styles
- ``POST /api/infer``      -> phonemes, durations, pitch -> wav samples
- ``POST /api/pred_dur``, ``/api/pred_pitch`` -> a JSON error (501): the
  predictors land with the variance slice.

Requests render one at a time: the device work is serialised by a lock,
while the HTTP threads parse and encode concurrently. A malformed request
(``BadRequest``) answers 400; any other failure, a kernel's own contract
check included, answers 500.
"""

from __future__ import annotations

import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from prodiff_tpu_torch.infer.handler import SVSInferHandler
from prodiff_tpu_torch.utils.pitch_utils import midi_to_hz


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
        # warm start (opt out with `precompile: false`): build the kernels and
        # run one bucket before accepting requests
        if self.hparams.get("precompile", True):
            print(f"| web: warmed up {self.core.warmup()}")

    def api_basic_info(self, _req=None) -> dict:
        return {
            "languages": list(self.core.lang_map.keys()),
            "speakers": list(self.core.spk_map.keys()),
            "hop_size": self.hparams["hop_size"],
            "samplerate": self.hparams["audio_sample_rate"],
            "pitch_styles": [],
        }

    def api_pred_dur(self, _req: dict) -> dict:
        raise NotImplementedError("/api/pred_dur: the duration predictor lands with the variance slice")

    def api_pred_pitch(self, _req: dict) -> dict:
        raise NotImplementedError("/api/pred_pitch: the pitch predictor lands with the variance slice")

    def _validate_infer(self, req: dict):
        """-> (phonemes, durations [s], f0 [Hz] over mel_len frames); raises
        ``BadRequest`` for anything the client sent wrong."""
        if not isinstance(req, dict):
            raise BadRequest("the request body must be a JSON object")
        for key in ("speaker", "language", "ph_text_list", "ph_dur_list", "pitch_list"):
            if key not in req:
                raise BadRequest(f"{key} is required")
        if "voicing_list" in req or "breath_list" in req:
            raise NotImplementedError(
                "voicing_list/breath_list: the VR gain path lands with the data-pipeline slice"
            )
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
        return {"wav": [float(x) for x in wav]}

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
