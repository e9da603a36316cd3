"""The ``train`` driver: ``Trainer.train_step`` on the batches the port's
dataset and ``DevicePrefetcher`` deliver from a seeded binarized corpus,
epoch after epoch, as ``fit`` runs it, without validation or checkpoints.
Its check redoes the first steps with the plain reference."""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Dict, Iterator, List
from unittest import mock

import numpy as np
import torch

import generate
import weights
from driver import UNMATCHED, Driver, norm_gap
from reference import svs as ref
from tracing import span


class Train(Driver):
    CHECKED_STEPS = 3

    def setup(self) -> None:
        from prodiff_tpu_torch.tasks.svs import SVSTask
        from prodiff_tpu_torch.training.trainer import Trainer
        from prodiff_tpu_torch.utils.indexed_datasets import IndexedDatasetBuilder

        self.lap("imports")
        hp, mix, dev = self.hp, self.mix, self.device
        self.tmp = tempfile.mkdtemp(prefix="bench_corpus_", dir=os.environ.get("TMPDIR"))
        data_dir = os.path.join(self.tmp, "data")
        self.hp = hp = dict(hp, task="svs", data_dir=data_dir,
                            work_dir=os.path.join(self.tmp, "work"))
        phones = generate.phone_set(mix["language"])
        n_vocab = ref.RESERVED_TOKENS + len(set(phones.values()))
        self.items = generate.corpus_items(mix, self.seed, hp["audio_num_mel_bins"], n_vocab,
                                           hp["num_spk"], dev)
        generate.write_corpus(os.path.join(data_dir, "svs"), self.items,
                              {"phone_set": phones, "spk_map": self.config["speakers"],
                               "lang_map": hp["languages"]}, IndexedDatasetBuilder)
        self.lap("corpus")
        self.trainer = Trainer(hp, device=dev)
        self.task = SVSTask(hp)
        self.trainer.build(self.task)
        shapes = {k: v.shape for k, v in self.trainer.model.state_dict().items()}
        out = "diffusion.denoise_fn.output_projection.weight"
        self.w0 = weights.seeded(shapes, self.seed, dev, fixed={out: 0.02})
        self.trainer.model.load_state_dict(self.w0)
        self.lap("program")
        self.real: List[list] = []  # [(frames, tokens)] of each delivered batch's real rows
        self.stream = self._batches()
        self.first, self.losses = [], []
        opt = self.trainer.optimizer
        for step in range(self.CHECKED_STEPS):
            batch = next(self.stream)
            if step == 0:
                self.lap("first batch")
            self.first.append({k: v.cpu() for k, v in batch.items() if torch.is_tensor(v)})
            self.losses.append(self.trainer.train_step(batch)["total_loss"])
            self.trainer.global_step += 1
            if step == 0:
                self.grads = {n: m / (1 - opt.b1) for n, m in opt.mu.items()}
        self.after = {n: p.detach().clone() for n, p in self.trainer.model.named_parameters()}
        self.losses = [float(x) for x in self.losses]
        self.lap("first steps")
        # the rest of the first epoch and the next one's first batch: every
        # padded shape of the corpus, and a new epoch's prefetcher, once
        steps = self.CHECKED_STEPS
        while True:
            batch = next(self.stream)
            self.trainer.train_step(batch)
            self.trainer.global_step += 1
            steps += 1
            if self.epochs:
                break
        del self.real[:steps]
        self.lap("first epoch")

    def _batches(self):
        """Epoch after epoch of ``(nsamples, batch)`` as ``fit`` iterates them;
        each host batch's real frames are noted before the prefetcher takes it."""
        tr = self.trainer

        def counted(batches):
            for b in batches:
                frames = np.count_nonzero(b["mel2ph"], axis=1)
                tokens = np.count_nonzero(b["ph_seq"], axis=1)
                self.real.append([(int(f), int(t)) for f, t in zip(frames, tokens) if f])
                yield b

        self.epochs = 0  # epochs delivered whole
        while True:
            prefetcher = tr._prefetcher(counted(tr._batches(self.task.train_iterator)),
                                        depth=self.hp.get("prefetch_to_device", 2))
            try:
                for _, batch in prefetcher:
                    yield batch
            finally:
                prefetcher.close()
            self.epochs += 1

    def window(self, seconds: float, recorder=None) -> None:
        """Steps until ``seconds`` have passed on the host, then until the card
        has finished them."""
        tr = self.trainer
        if recorder is not None:
            recorder.start()
        t0 = time.perf_counter()
        steps, shapes = 0, []
        while time.perf_counter() - t0 < seconds:
            with span("data_wait", recorder):
                batch = next(self.stream)
            with span("train_step", recorder):
                tr.train_step(batch)
            tr.global_step += 1
            steps += 1
            shapes.append(tuple(batch["mel"].shape[:2]))
        torch.cuda.synchronize(self.device) if self.device.type == "cuda" else None
        t1 = time.perf_counter()
        if recorder is not None:
            recorder.stop()
        self.record = {"seconds": t1 - t0, "steps": steps, "shapes": shapes,
                       "rows": self.real[:steps]}

    def end_to_end(self) -> Dict[str, float]:
        frames = sum(f for rows in self.record["rows"] for f, _ in rows)
        return {"train_frames_per_s": frames / self.record["seconds"]}

    def attempted(self) -> int:
        return self.record["steps"]

    def release(self) -> None:
        self.stream.close()
        del self.trainer, self.task, self.stream
        shutil.rmtree(self.tmp, ignore_errors=True)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _reference_batches(self) -> tuple:
        """The reference's own padded batches, built from the corpus items
        that the program's first batches hold, and the largest difference
        between those and what the program delivered."""
        by_mel = {it["mel"][:4].tobytes(): it for it in self.items}
        built, worst = [], 0.0
        for got in self.first:
            b_pad, t_pad = got["mel"].shape[:2]
            rows = [by_mel.get(got["mel"][r, :4].numpy().tobytes())
                    for r in range(b_pad) if got["mel2ph"][r, 0] > 0]
            if any(r is None for r in rows) or len(rows) != len({id(r) for r in rows}):
                return None, UNMATCHED
            want = {}
            for key in ("ph_seq", "lang_seq"):
                width = got[key].shape[1]
                want[key] = np.zeros((b_pad, width), np.int64)
                for r, it in enumerate(rows):
                    want[key][r, :len(it[key])] = it[key]
            for key in ("mel2ph", "f0", "voicing", "breath", "mel"):
                shape = (b_pad, t_pad) + np.shape(rows[0][key])[1:]
                want[key] = np.zeros(shape, rows[0][key].dtype)
                for r, it in enumerate(rows):
                    want[key][r, :len(it[key])] = it[key]
            want["spk_id"] = np.zeros(b_pad, np.int64)
            want["spk_id"][:len(rows)] = [it["spk_id"] for it in rows]
            for key, v in want.items():
                d = got[key].double().numpy() - v.astype(np.float64)
                worst = max(worst, float(np.abs(d).max()) if d.size else 0.0)
            built.append({k: torch.as_tensor(v, device=self.device) for k, v in want.items()})
        return built, worst

    def readings(self, out: dict, grads: dict, after: dict, losses: List[float]) -> Dict[str, float]:
        """Losses, the first step's gradient norms and the norms of the
        weights' change over the checked steps, against the reference's
        ``out``. Leaves whose reference gradient is under a thousandth of the
        median leaf's move by round-off alone under Adam and are left out
        of the change."""
        names = list(out["first_grads"])
        g_norm = {n: float(out["first_grads"][n].norm()) for n in names}
        med = float(np.median(list(g_norm.values())))
        moved = [n for n in names if g_norm[n] >= 1e-3 * med]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, out["losses"])),
            "grad_gap": norm_gap(grads, out["first_grads"], names),
            "update_gap": norm_gap({n: after[n] - self.w0[n] for n in moved},
                                   {n: out["weights"][n] - self.w0[n] for n in moved}, moved),
        }

    def _reference(self, built, tf32: bool = False) -> dict:
        inp = [dict(b, tokens=b["ph_seq"], lang=b["lang_seq"]) for b in built]
        with ref.precision(tf32):
            return ref.train_steps(self.w0, self.hp, inp, self.program_seed)

    def check(self) -> Dict[str, dict]:
        built, worst = self._reference_batches()
        if built is None:
            return self.checks({"batch_gap": worst, "loss_gap": UNMATCHED,
                                "grad_gap": UNMATCHED, "update_gap": UNMATCHED})
        out = self._reference(built)
        self._built, self._out = built, out
        return self.checks(dict(self.readings(out, self.grads, self.after, self.losses),
                                batch_gap=worst))

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place (after ``check``)."""
        low = self._reference(self._built, tf32=True)
        return self.readings(self._out, low["first_grads"], low["weights"], low["losses"])


@contextlib.contextmanager
def state_unchanged() -> Iterator[None]:
    """A training step that leaves the weights and the optimizer as they were."""
    from prodiff_tpu_torch.training.optim import Optimizer

    with mock.patch.object(Optimizer, "step", lambda self: False):
        yield


@contextlib.contextmanager
def half_batch_mean() -> Iterator[None]:
    """A training step's losses over the first half of the batch's rows alone."""
    from prodiff_tpu_torch.tasks.svs import SVSTask

    losses = SVSTask.compute_losses

    def half(self, model, batch, *args, **kw):
        n = batch["mel"].shape[0] // 2
        return losses(self, model, {k: v[:n] if torch.is_tensor(v) and v.dim() else v
                                    for k, v in batch.items()}, *args, **kw)

    with mock.patch.object(SVSTask, "compute_losses", half):
        yield


DRIVER = Train
FAULTS = (state_unchanged, half_batch_mean)
