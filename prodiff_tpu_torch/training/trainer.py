"""The trainer (port of ``prodiff_tpu/training/trainer.py``) on one card.

``Trainer(hparams, device=None)`` runs on the CUDA card unless the caller
names the CPU (``device.resolve_device``). Per step: the task's losses,
their sum's backward, the global norm of the raw gradients, the optimizer
(``training/optim.py``, optax's semantics). Around it, as in the JAX
trainer:

- ``val_step`` under ``torch.no_grad()`` in eval mode (dropout off; the
  denoiser's stack runs K1), ``evaluate`` weighting each batch's losses by
  its ``nsamples`` and drawing the task's validation plots of the first
  batch under ``work_dir/plots``, and a sanity validation before the first
  step;
- ``fit``: epochs over the train iterator; scalars every ``tb_log_interval``
  steps (``MetricsWriter``: JSONL, and TensorBoard and its figures if it
  imports); every ``val_check_interval`` steps a validation, a checkpoint
  and, when the monitored loss improved, ``model_ckpt_best.pt``; a restart
  resumes from the newest checkpoint, the port's or the JAX trainer's (the
  optimizer state is optax's tree in both); SIGTERM/SIGUSR1 save a
  checkpoint at the next step boundary and stop; ``print_nan_grads`` raises
  on a non-finite gradient norm at a logged step;
- ``async_save``: the host snapshot of the weights and the optimizer state
  is taken at once, the file is written on a (non-daemon) thread, joined
  before the next save, before the best copy and when ``fit`` ends;
- ``profile_steps: N``: ``torch.profiler`` (host, and the card's kernels)
  over N steps from this session's step 10, written as a Chrome trace
  under ``work_dir/profile``, as ``jax.profiler`` traces the JAX trainer's;
- ``DevicePrefetcher`` copies the next batch to the card on a side stream
  while the current step runs.

The diffusion step ``t`` and noise come from a ``torch.Generator`` seeded
from (seed, step), and dropout draws from the device's generator seeded so
for the step, so a resumed run draws what an unbroken one would.
Not ported here: multi-host loading and data-parallel training (later
slices).
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from prodiff_tpu_torch.data.dataset import drain
from prodiff_tpu_torch.device import resolve_device
from prodiff_tpu_torch.training.optim import Optimizer, global_norm
from prodiff_tpu_torch.utils import ckpt_utils

log = logging.getLogger("prodiff_tpu_torch.trainer")
PROFILE_AT = 10  # the session's step the profile starts at, as the JAX trainer's


class MetricsWriter:
    """``metrics.jsonl`` in the work dir, plus TensorBoard when it imports
    (scalars under ``tr/`` and ``val/`` as in the reference)."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir=work_dir)
        except Exception:
            self.tb = None
        self.jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")

    def add_figure(self, tag: str, fig, step: int) -> None:
        """A matplotlib figure into TensorBoard; nothing without it."""
        if self.tb is not None:
            self.tb.add_figure(tag, fig, step)

    def add_scalars(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        rec = {"step": step}
        for k, v in metrics.items():
            rec[f"{prefix}{k}"] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(f"{prefix}{k}", float(v), step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        self.jsonl.close()


def host_tensors(batch: Dict[str, np.ndarray], pin: bool) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors (integers as int64, masks stay bool),
    pinned if asked."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.pin_memory() if pin else t
    return out


class DevicePrefetcher:
    """Yields ``(nsamples, batch on the device)``. A thread collates and pins
    host batches ahead (at most ``depth`` waiting); the next batch's copies
    go out ``non_blocking`` on a side stream before the current batch is
    handed over, so they overlap its step. Before a batch is handed over
    the current stream waits for the side stream, and its tensors are
    recorded on the current stream for the allocator. On the CPU the
    batches pass through without a thread."""

    def __init__(self, batch_iter, device: torch.device, depth: int = 2):
        self.batch_iter = batch_iter
        self.device = device
        self.depth = max(int(depth), 1)
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    def _produce(self) -> None:
        try:
            for batch in self.batch_iter:
                if self._stop.is_set():
                    return
                nsamples = batch.pop("nsamples", None)
                self._queue.put((nsamples, host_tensors(batch, pin=True)))
        except BaseException as e:  # surface loader errors in the train loop
            self._queue.put(e)
        finally:
            self._queue.put(None)

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.batch_iter:
                nsamples = batch.pop("nsamples", None)
                yield nsamples, host_tensors(batch, pin=False)
            return
        self._queue = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        side = torch.cuda.Stream(self.device)
        pending = None
        try:
            while True:
                item = self._queue.get()
                if isinstance(item, BaseException):
                    raise item
                ready = None
                if pending is not None:
                    ready = self._hand_over(side, *pending)
                if item is not None:
                    nsamples, host = item
                    with torch.cuda.stream(side):
                        pending = (nsamples, {k: v.to(self.device, non_blocking=True)
                                              for k, v in host.items()})
                else:
                    pending = None
                if ready is not None:
                    yield ready
                if item is None:
                    break
        finally:
            self.close()

    @staticmethod
    def _hand_over(side, nsamples, batch):
        current = torch.cuda.current_stream(side.device)
        current.wait_stream(side)
        for t in batch.values():
            t.record_stream(current)
        return nsamples, batch

    def close(self) -> None:
        """Stop the producer: drain its queue until the thread has exited
        (a producer blocked on a full queue could otherwise never see the
        stop flag)."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            drain(self._queue)
            self._thread.join(timeout=0.05)
        self._thread = None


class Trainer:
    def __init__(self, hparams: dict, device=None):
        self.hparams = hparams
        self.device = resolve_device(device)
        self.work_dir = hparams["work_dir"]
        self.seed = hparams.get("seed", 1234)
        self.max_updates = hparams.get("max_updates", 200000)
        self.val_check_interval = hparams.get("val_check_interval", 2000)
        self.tb_log_interval = hparams.get("tb_log_interval", 10)
        self.num_ckpt_keep = hparams.get("num_ckpt_keep", 3)
        self.monitor_mode = hparams.get("valid_monitor_mode", "min")
        self.check_nans = hparams.get("print_nan_grads", False)
        self.num_sanity_val_steps = hparams.get("num_sanity_val_steps", -1)
        self.profile_steps = hparams.get("profile_steps", 0)
        self.async_save = hparams.get("async_save", False)
        self._save_thread: Optional[threading.Thread] = None
        self._save_error: Optional[BaseException] = None
        self._profiler = None
        self._profile_from = 0
        self.global_step = 0
        self.current_epoch = 0
        self.best_val = math.inf if self.monitor_mode == "min" else -math.inf

    # ---- state ------------------------------------------------------------

    def build(self, task) -> None:
        """Model and optimizer on the device. A torch module has its shapes
        without an example batch (the JAX trainer initialises from the
        first batch)."""
        self.task = task
        task.device = self.device
        torch.manual_seed(self.seed)
        self.model = task.build_model().to(self.device)
        self.optimizer = Optimizer(self.model.named_parameters(), self.hparams,
                                   carrier=task.carrier())
        self.generator = torch.Generator(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("| model params: %.2fM on %s", n_params / 1e6, self.device)

    def _seeded(self, stream: int) -> torch.Generator:
        return self.generator.manual_seed(self.seed * 2 ** 32 + stream)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the losses, ``total_loss`` and the
        raw gradients' global norm, as device tensors."""
        self.model.train()
        cuda = [self.device.index or 0] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(self.seed * 2 ** 32 + 2 ** 30 + self.global_step)  # dropout
            losses = self.task.compute_losses(self.model, batch, self._seeded(self.global_step))
        total = sum(losses.values())
        for p in self.optimizer.params.values():
            p.grad = None
        total.backward()
        grad_norm = global_norm(p.grad for p in self.optimizer.params.values()
                                if p.grad is not None)
        self.optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    @torch.no_grad()
    def val_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.eval()
        # one fixed stream for every validation batch, so evaluations compare
        losses = self.task.compute_losses(self.model, batch, self._seeded(2 ** 31))
        losses["total_loss"] = sum(losses.values())
        return losses

    # ---- checkpointing ------------------------------------------------------

    def save_checkpoint(self, block: bool = True) -> str:
        """Snapshot the weights and the optimizer state to the host, then
        write ``model_ckpt_steps_{step}.ckpt``: at once, or with
        ``async_save`` and ``block=False`` on a thread (the next save, the
        best copy and the end of ``fit`` join it)."""
        payload = {
            "global_step": int(self.global_step),
            "epoch": int(self.current_epoch),
            "checkpoint_callback_best": float(self.best_val),
            "state_dict": self.task.params_tree(self.model),
            "optimizer_state": self.optimizer.state_dict(),
        }
        self.join_pending_save()
        step = self.global_step

        def write() -> str:
            path = ckpt_utils.save_checkpoint(self.work_dir, step, payload, self.num_ckpt_keep)
            log.info("| saved checkpoint %s", path)
            return path

        if self.async_save and not block:
            def write_in_thread() -> None:
                try:
                    write()
                except BaseException as e:  # raised again by join_pending_save
                    self._save_error = e

            self._save_thread = threading.Thread(target=write_in_thread, daemon=False)
            self._save_thread.start()
            return os.path.join(self.work_dir, f"model_ckpt_steps_{step}.ckpt")
        return write()

    def join_pending_save(self) -> None:
        """Wait for a checkpoint being written on a thread; raise its error."""
        if self._save_thread is not None:
            self._save_thread.join()
        self._save_thread = None
        error, self._save_error = self._save_error, None
        if error is not None:
            raise error

    def restore_checkpoint(self) -> bool:
        """Resume from the newest checkpoint in the work dir, written by
        either package (or by the port before its optimizer state took
        optax's layout). An empty optimizer state (``convert_ckpt``'s) is
        refused, as the JAX trainer's ``from_state_dict`` refuses it."""
        payload = ckpt_utils.load_last_checkpoint(self.work_dir)
        if payload is None:
            return False
        opt_state = payload["optimizer_state"]
        if not opt_state:
            raise ValueError("the newest checkpoint has no optimizer state (convert_ckpt "
                             "writes none): the JAX trainer cannot resume it either")
        self.global_step = int(payload["global_step"])
        self.current_epoch = int(payload.get("epoch", 0))
        self.best_val = float(payload.get("checkpoint_callback_best", self.best_val))
        self.task.load_params_tree(self.model, payload["state_dict"])
        self.optimizer.load_state_dict(opt_state)
        log.info("| restored checkpoint at step %d", self.global_step)
        return True

    def _profile(self, steps_this_session: int) -> None:
        """Start the profiler before this session's step 10, stop it
        ``profile_steps`` steps later."""
        if not self.profile_steps:
            return
        if steps_this_session == PROFILE_AT and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
            self._profile_from = self.global_step
        elif steps_this_session == PROFILE_AT + self.profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        out = os.path.join(self.work_dir, "profile")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace_steps_{self._profile_from}-{self.global_step}.json")
        prof.export_chrome_trace(path)
        log.info("| profile of steps %d-%d: %s", self._profile_from + 1, self.global_step, path)

    # ---- loops --------------------------------------------------------------

    def fit(self, task, max_steps: Optional[int] = None) -> None:
        """Restore, then epochs until ``max_steps`` (``max_updates``) with
        periodic validation and checkpoints."""
        max_steps = max_steps or self.max_updates
        self.build(task)
        restored = self.restore_checkpoint()
        writer = MetricsWriter(self.work_dir)
        if not restored and self.num_sanity_val_steps != 0:
            n = None if self.num_sanity_val_steps < 0 else self.num_sanity_val_steps
            sanity = self.evaluate(task, max_batches=n)
            log.info("| sanity val: %s", {k: round(v, 4) for k, v in sanity.items()})

        preempted = threading.Event()
        prev_handlers = {}

        def on_signal(signum, frame):
            log.warning("| signal %d received; checkpointing before exit", signum)
            preempted.set()

        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                prev_handlers[sig] = signal.signal(sig, on_signal)
            except (ValueError, OSError):
                pass  # not the main thread

        t_start = time.time()
        # the profile counts the steps of this session (a resumed run's
        # global_step may be past 10 already)
        steps_this_session = 0
        try:
            while self.global_step < max_steps and not preempted.is_set():
                self.current_epoch += 1
                prefetcher = DevicePrefetcher(task.train_iterator(), self.device,
                                              depth=self.hparams.get("prefetch_to_device", 2))
                try:
                    for _, batch in prefetcher:
                        if self.global_step >= max_steps or preempted.is_set():
                            break
                        self._profile(steps_this_session)
                        metrics = self.train_step(batch)
                        self.global_step += 1
                        steps_this_session += 1
                        if self.global_step % self.tb_log_interval == 0:
                            self._log_train(metrics, writer)
                        if self.global_step % self.val_check_interval == 0:
                            val = self.evaluate(task, writer=writer)
                            writer.add_scalars(val, self.global_step, prefix="val/")
                            improved = self._update_best(val.get("total_loss"))
                            self.save_checkpoint(block=False)
                            if improved:
                                self.join_pending_save()
                                ckpt_utils.save_best_copy(self.work_dir, self.global_step)
                finally:
                    prefetcher.close()
        except KeyboardInterrupt:
            log.info("| interrupted; saving checkpoint")
            self.save_checkpoint()
            raise
        finally:
            try:
                self._stop_profile()
                self.join_pending_save()
            finally:
                writer.close()
                for sig, handler in prev_handlers.items():
                    signal.signal(sig, handler)
        if preempted.is_set() or self.global_step % self.val_check_interval != 0:
            self.save_checkpoint()
        log.info("| training done: %d steps in %.1fs", self.global_step, time.time() - t_start)

    def _log_train(self, metrics: Dict[str, torch.Tensor], writer: MetricsWriter) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        values["lr"] = self.optimizer.schedule(self.global_step)
        if self.check_nans and not math.isfinite(values["grad_norm"]):
            raise FloatingPointError(f"non-finite grad norm at step {self.global_step}")
        writer.add_scalars(values, self.global_step, prefix="tr/")

    def evaluate(self, task, max_batches: Optional[int] = None,
                 writer: Optional[MetricsWriter] = None) -> Dict[str, float]:
        """The validation losses, weighted by each batch's ``nsamples``; the
        task's plots of the first batch under ``work_dir/plots``."""
        sums: Dict[str, float] = {}
        weights: Dict[str, float] = {}
        for i, (nsamples, batch) in enumerate(DevicePrefetcher(task.val_iterator(), self.device)):
            if max_batches is not None and i >= max_batches:
                break
            nsamples = nsamples or 1
            for k, v in self.val_step(batch).items():
                sums[k] = sums.get(k, 0.0) + float(v) * nsamples
                weights[k] = weights.get(k, 0.0) + nsamples
            if i == 0:
                task.validation_plots(self.model, batch, self.global_step,
                                      os.path.join(self.work_dir, "plots"), writer=writer)
        return {k: sums[k] / max(weights[k], 1) for k in sums}

    def _update_best(self, val_loss: Optional[float]) -> bool:
        """Track the monitored loss; True when the checkpoint about to be
        written should also be copied to ``model_ckpt_best.pt``."""
        if val_loss is None:
            return False
        improved = val_loss < self.best_val if self.monitor_mode == "min" else val_loss > self.best_val
        if improved and self.hparams.get("save_best", True):
            self.best_val = val_loss
            return True
        return False
