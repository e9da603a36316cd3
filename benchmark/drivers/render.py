"""The ``render`` driver: whole songs rendered back to back through the
handler's front end (``SVSInferHandler.prepare``) and its bucket batching
(``render_batch``), as ``handle`` runs them, without stitching or the wav
file; the teacher and the NSF-HiFiGAN vocoder of the configuration, with
seeded weights. Its check renders a seeded sample of the window's batches
again with the plain reference."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Iterator, List
from unittest import mock

import numpy as np
import torch

import generate
import weights
from driver import Driver, gap
from reference import svs as ref
from tracing import span


class Render(Driver):
    def setup(self) -> None:
        from prodiff_tpu_torch.infer.handler import SVSInferHandler, phone_encoder
        from prodiff_tpu_torch.models.nsf_hifigan import Generator
        from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
        from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

        self.lap("imports")
        hp, h, dev = self.hp, self.config["vocoder"], self.device
        lang = self.mix["language"]
        self.maps = {"phone_set": generate.phone_set(lang), "spk_map": self.config["speakers"],
                     "lang_map": hp["languages"]}
        t_shapes = {k: v.shape for k, v in ProDiffTeacher(
            len(phone_encoder(self.maps["phone_set"])), hp).state_dict().items()}
        v_shapes = {k: v.shape for k, v in Generator.from_config(h).state_dict().items()}
        out = "diffusion.denoise_fn.output_projection.weight"
        self.teacher_w = weights.seeded(t_shapes, self.seed, dev, fixed={out: 0.02})
        strides = {f"ups.{i}.weight": u for i, u in enumerate(h["upsample_rates"])}
        self.voc_w = weights.seeded(v_shapes, self.seed + 1, dev, gain=0.5, stride=strides)
        self.lap("weights")
        vocoder = NsfHifiGAN(hp, state_dict=self.voc_w, config=h, device=dev)
        self.handler = SVSInferHandler(hparams=hp, state_dict=self.teacher_w, maps=self.maps,
                                       vocoder=vocoder, device=dev)
        self.lap("program")
        self.songs = [generate.song(self.mix, self.seed, k)
                      for k in range(self.mix["songs_in_setup"])]
        self.lap("songs")
        self._wrap()
        self._warm_up()
        self.batches.clear()
        self.lap("warm-up")

    def _warm_up(self) -> None:
        """Render one batch of every padded shape the songs give, grouped as
        ``render_batch`` groups them ((phonemes, frames) buckets, up to
        ``infer_batch_size`` a batch): the kernels are built and the
        allocator and the libraries have met every shape before the window."""
        hd = self.handler
        max_b = int(self.hp["infer_batch_size"])
        seen = set()
        for song in self.songs:
            groups: Dict[tuple, list] = {}
            for phrase in song:
                p = hd.prepare(dict(phrase))
                key = (-(-p["t_ph"] // 16) * 16, -(-p["mel_len"] // hd.mel_bucket) * hd.mel_bucket)
                groups.setdefault(key, []).append(p)
            for key, prepared in groups.items():
                for i in range(0, len(prepared), max_b):
                    chunk = prepared[i:i + max_b]
                    if (len(chunk),) + key not in seen:
                        seen.add((len(chunk),) + key)
                        hd.render_batch(chunk)
        print(f"warm-up: {len(seen)} padded shapes", file=sys.stderr, flush=True)

    def _wrap(self) -> None:
        """Record each batch the handler renders (its padded shape, the mel it
        hands the vocoder, when the vocoder's wav was done) from around the
        calls into the teacher and the vocoder."""
        hd = self.handler
        acoustic, vocode, prepare = hd._acoustic, hd._vocode, hd.prepare
        self.batches: List[dict] = []
        self.recorder = None

        def acoustic_rec(ph, mel2ph, *args):
            self.batches.append({"t_ph": ph.shape[1], "t_mel": mel2ph.shape[1],
                                 "lengths": [int(n) for n in (np.asarray(mel2ph) > 0).sum(1)],
                                 "tokens": [int(n) for n in (np.asarray(ph) > 0).sum(1)]})
            with span("acoustic", self.recorder):
                return acoustic(ph, mel2ph, *args)

        def vocode_rec(mel, f0):
            with span("vocode", self.recorder):
                wav = vocode(mel, f0)
                torch.cuda.synchronize(self.device) if mel.is_cuda else None
            self.batches[-1].update(mel=mel, done=time.perf_counter())
            if self.on_done is not None:
                self.on_done(self.batches[-1])
            return wav

        def prepare_rec(segment):
            with span("prepare", self.recorder):
                return prepare(segment)

        hd._acoustic, hd._vocode, hd.prepare = acoustic_rec, vocode_rec, prepare_rec
        self.on_done = None

    def render(self, song: List[dict]) -> List[np.ndarray]:
        prepared = [self.handler.prepare(dict(s)) for s in song]
        return self.handler.render_batch(prepared)

    def window(self, seconds: float, recorder=None) -> None:
        """Songs back to back; the window closes when the first batch done at
        or after ``seconds`` is done."""
        songs: List[tuple] = []
        state = {"closed": None}
        if recorder is not None:
            recorder.start()
        t0 = time.perf_counter()
        t_end = t0 + seconds

        def on_done(batch):
            if state["closed"] is None and batch["done"] >= t_end:
                state["closed"] = batch["done"]
                if recorder is not None:
                    recorder.close_window()

        self.on_done, self.recorder = on_done, recorder
        k = 0
        while state["closed"] is None:
            song = self.songs[k % len(self.songs)]
            start = len(self.batches)
            wavs = self.render(song)
            songs.append((k, song, start, len(self.batches), wavs))
            k += 1
        if recorder is not None:
            recorder.stop()
        self.on_done = self.recorder = None
        done = [b for b in self.batches if b["done"] <= state["closed"]]
        hop, sr = self.hp["hop_size"], self.hp["audio_sample_rate"]
        self.record = {
            "seconds": state["closed"] - t0,
            "batches": [{k: b[k] for k in ("t_ph", "t_mel", "lengths", "tokens")} for b in done],
            "audio_s": sum(sum(b["lengths"]) for b in done) * hop / sr,
            "phrases": sum(len(b["lengths"]) for b in done),
            "steps": int(self.hp["sampling_steps"] if self.hp["diff_type"] == "reflow"
                         else self.hp["timesteps"]),
        }
        self._songs_done = [s for s in songs if s[2] < len(done)]
        self._n_done = len(done)
        # the rate of each 5 s of the window, to tell a stall from a slow run
        slices = [0.0] * (int(self.record["seconds"] // 5) + 1)
        for b in done:
            slices[int((b["done"] - t0) // 5)] += sum(b["lengths"]) * hop / sr / 5
        print("window slices (audio s/s, 5 s each): " + " ".join(f"{s:.1f}" for s in slices),
              file=sys.stderr, flush=True)

    def end_to_end(self) -> Dict[str, float]:
        return {"render_audio_s_per_s": self.record["audio_s"] / self.record["seconds"]}

    def attempted(self) -> int:
        return self.record["phrases"]

    def release(self) -> None:
        del self.handler
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def sample(self) -> List[tuple]:
        """(song index, batch index in the song, the batch) of a seeded
        sample of the window's batches, the one holding the longest phrase
        first."""
        cands = []
        for k, song, start, stop, _ in self._songs_done:
            for j in range(start, min(stop, self._n_done)):
                cands.append((k, j - start, j))
        longest = max(cands, key=lambda c: max(self.batches[c[2]]["lengths"]))
        rest = [c for c in cands if c != longest]
        rng = np.random.default_rng([self.seed % 2 ** 63, 7])
        pick = rng.choice(len(rest), min(len(rest), self.mix["check_batches"] - 1), replace=False)
        return [longest] + [rest[i] for i in sorted(pick)]

    def references(self, tf32: bool = False):
        """Per sampled batch: (the program's batch record, its phrases' wavs,
        the phrases' indices, real frames, and the reference's mel and wav,
        or None where the reference batches the song otherwise)."""
        hp, h, dev = self.hp, self.config["vocoder"], self.device
        ids = ref.phone_ids(self.maps["phone_set"])
        table = self.teacher_w["spk_embed.weight"].cpu().numpy()
        curves = {"voicing": -10.0, "breath": -50.0}
        songs = {s[0]: s for s in self._songs_done}
        for k, j, i in self.sample():
            _, song, _, _, wavs = songs[k]
            prepared = [ref.prepare(s, hp, ids, table, self.config["speakers"]) for s in song]
            idxs, t_ph, t_mel = ref.batches(prepared, hp["length_bucket_step"],
                                            hp["infer_batch_size"])[j]
            items = [prepared[n] for n in idxs]
            lengths = [p["mel_len"] for p in items]
            got = self.batches[i]
            if (got["t_ph"], got["t_mel"], got["lengths"]) != (t_ph, t_mel, lengths):
                yield got, wavs, idxs, lengths, None
                continue
            inp = {key: torch.as_tensor(v, device=dev)
                   for key, v in ref.pad_batch(items, t_ph, t_mel, curves).items()}
            with ref.precision(tf32):
                mel, wav = ref.render(self.teacher_w, self.voc_w, hp, h, inp, lengths,
                                      self.program_seed)
            yield got, wavs, idxs, lengths, (mel, wav)

    def check(self) -> Dict[str, dict]:
        hop = self.hp["hop_size"]
        readings = {"batching": 0.0, "mel_gap": 0.0, "wav_gap": 0.0}
        for got, wavs, idxs, lengths, out in self.references():
            if out is None:
                readings["batching"] = 1.0
                continue
            mel, wav = out
            for r, (n, m) in enumerate(zip(idxs, lengths)):
                readings["mel_gap"] = max(readings["mel_gap"], gap(got["mel"][r, :m], mel[r, :m]))
                w_got = torch.as_tensor(wavs[n], device=self.device)
                readings["wav_gap"] = max(readings["wav_gap"], gap(w_got, wav[r, :m * hop]))
        return self.checks(readings)

    def control(self) -> Dict[str, float]:
        """The reference in TF32 held against the reference as stated, on the
        same sampled batches."""
        hop = self.hp["hop_size"]
        readings = {"mel_gap": 0.0, "wav_gap": 0.0}
        for (_, _, _, lengths, want), (_, _, _, _, low) in zip(self.references(),
                                                                self.references(tf32=True)):
            if want is None:
                continue
            for r, m in enumerate(lengths):
                readings["mel_gap"] = max(readings["mel_gap"], gap(low[0][r, :m], want[0][r, :m]))
                readings["wav_gap"] = max(readings["wav_gap"],
                                          gap(low[1][r, :m * hop], want[1][r, :m * hop]))
        return readings


@contextlib.contextmanager
def half_rows_left_out() -> Iterator[None]:
    """A render leaves out the second half of each batch's rows."""
    from prodiff_tpu_torch.infer.handler import SVSInferHandler

    acoustic = SVSInferHandler._acoustic

    def half(self, ph, *args):
        mel = acoustic(self, ph, *args)
        mel[mel.shape[0] // 2:] = 0
        return mel

    with mock.patch.object(SVSInferHandler, "_acoustic", half):
        yield


@contextlib.contextmanager
def wav_altered() -> Iterator[None]:
    """The vocoder's answer altered where it is produced: the first 64
    samples of each row raised by 0.01."""
    from prodiff_tpu_torch.vocoders.nsf_hifigan import NsfHifiGAN

    spec2wav = NsfHifiGAN.spec2wav_batch

    def altered(self, *args, **kw):
        wav = spec2wav(self, *args, **kw)
        wav[:, :64] += 0.01
        return wav

    with mock.patch.object(NsfHifiGAN, "spec2wav_batch", altered):
        yield


DRIVER = Render
FAULTS = (half_rows_left_out, wav_altered)
