"""The trainer (port of ``prodiff_tpu/training/trainer.py``), on one card
or on every rank of a process group.

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
from (seed, step), and the dropout masks from a generator of their own,
seeded from (seed, 2 ** 30 + step) and handed to every ``Dropout`` for the
step (``models.common.dropout_generator``, the JAX step's
``fold_in(rng, 2)``), so a resumed run draws what an unbroken one would.

Several processes (torchrun's environment, ``parallel/mesh.py:init_distributed``;
the JAX trainer's mesh and ``multi_host``) lay out as a (data, model) mesh
of ``model_parallel`` columns. The step is the one-process step on the
global batch:

- each rank loads its rows of the global batch (``per_process_loading``,
  the default: ``BatchIterator(local_block=...)``), padded to the global
  batch's shapes; otherwise, and where the dataset lacks the
  ``{prefix}_item_lengths.npz`` sidecar without ``multi_host`` (the JAX
  trainer's one process loads the global batch there), the global batch,
  cut by ``shard_batch``. ``multi_host`` without the sidecar raises, as the
  JAX multi-process path does;
- its ``t`` and noise, and its dropout masks, are its rows of the global
  batch's draws (``mesh.batch_rows``); the FFN's hidden, split over the
  model axis, draws its mask at the full filter width and each rank keeps
  its channels' columns, and the regions the model axis replicates draw
  alike on its ranks (one stream, one shape), so every mask is the
  one-process step's;
- the gradients' mean over the data axis is one all-reduce of one flat
  bucket before the clip reads their norm; the logged losses are the data
  axis's means;
- at ``model_parallel > 1`` the teacher's encoder and WaveNet are
  tensor-parallel over the model axis (``parallel/megatron.py``), built as
  slices of the one-process model made from the seed;
- the parameters and the optimizer state are broadcast over the data axis
  at build and after a restore; rank 0 writes the checkpoints (the
  one-process layout, tensor-parallel slices gathered) and the logs, and
  reads the checkpoint a restore sends to every rank; the
  validation losses are the data axis's means weighted by ``nsamples``; the
  validation plots render data rank 0's rows on every rank of its model
  axis (a tensor-parallel render needs them all), and rank 0 draws them.
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
from prodiff_tpu_torch.device import check_tp_dilation
from prodiff_tpu_torch.models.common import dropout_generator
from prodiff_tpu_torch.parallel.mesh import (
    agree,
    all_reduce_gradients,
    batch_rows,
    create_mesh,
    data_mean,
    from_rank0,
    init_distributed,
    process_data_blocks,
    replicate,
    shard_batch,
)
from prodiff_tpu_torch.parallel.megatron import (
    ShardLayout,
    gather_state_dict,
    shard_for_rank,
    sharded_names,
)
from prodiff_tpu_torch.training.optim import Optimizer
from prodiff_tpu_torch.utils import ckpt_utils

log = logging.getLogger("prodiff_tpu_torch.trainer")
PROFILE_AT = 10  # the session's step the profile starts at, as the JAX trainer's
# the dropout masks' stream of step s is seeded from (seed, DROPOUT_STREAM + s):
# apart from the diffusion draws' (seed, s) and the validation's (seed, 2 ** 31)
DROPOUT_STREAM = 2 ** 30


class MetricsWriter:
    """``metrics.jsonl`` in the work dir, plus TensorBoard when it imports
    (scalars under ``tr/`` and ``val/`` as in the reference). The TensorBoard
    writer is made at the first scalar or figure: its import pulls in
    TensorFlow where that is installed (seconds), which a run that logs
    nothing does without."""

    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.work_dir = work_dir
        self._tb = None
        self._tb_tried = False
        self.jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")

    @property
    def tb(self):
        """The TensorBoard ``SummaryWriter``, made at first use; None where
        it does not import."""
        if not self._tb_tried:
            self._tb_tried = True
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.work_dir)
            except Exception:
                self._tb = None
        return self._tb

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
        if self._tb is not None:
            self._tb.close()
        self.jsonl.close()


def host_tensors(batch: Dict[str, np.ndarray], pin: bool) -> Dict[str, torch.Tensor]:
    """numpy batch -> torch tensors (integers as int64, masks stay bool),
    pinned if asked; ``_local_rows`` stays a tuple."""
    out = {}
    for k, v in batch.items():
        if k == "_local_rows":
            out[k] = v
            continue
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
    batches pass through without a thread. With a ``mesh`` each batch is
    this rank's rows (``shard_batch``), ``_local_rows`` beside them."""

    def __init__(self, batch_iter, device: torch.device, depth: int = 2, mesh=None):
        self.batch_iter = batch_iter
        self.device = device
        self.depth = max(int(depth), 1)
        self.mesh = mesh
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    def _host(self, batch, pin: bool):
        nsamples = batch.pop("nsamples", None)
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        return nsamples, host_tensors(batch, pin=pin)

    def _produce(self) -> None:
        try:
            for batch in self.batch_iter:
                if self._stop.is_set():
                    return
                self._queue.put(self._host(batch, pin=True))
        except BaseException as e:  # surface loader errors in the train loop
            self._queue.put(e)
        finally:
            self._queue.put(None)

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.batch_iter:
                yield self._host(batch, pin=False)
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
                                              if isinstance(v, torch.Tensor) else v
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
            if isinstance(t, torch.Tensor):
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
        check_tp_dilation(hparams)
        self.hparams = hparams
        self.device = init_distributed(hparams, device=device)
        self.mesh = create_mesh(model_parallel=hparams.get("model_parallel", 1),
                                device=self.device)
        self.n_devices = self.mesh.size
        self.is_main = self.mesh.rank == 0
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
        self._loading_logged: set = set()
        self.global_step = 0
        self.current_epoch = 0
        self.best_val = math.inf if self.monitor_mode == "min" else -math.inf

    # ---- state ------------------------------------------------------------

    def build(self, task) -> None:
        """Model and optimizer on the device. A torch module has its shapes
        without an example batch (the JAX trainer initialises from the
        first batch). A tensor-parallel rank takes its slices of the
        one-process model made from the seed."""
        self.task = task
        task.device = self.device
        task.tp = None
        torch.manual_seed(self.seed)
        self.model = task.build_model()
        tp = self.mesh.tp
        self.tp_kinds: Dict[str, str] = {}
        layout = None
        if tp is not None:
            whole = self.model.state_dict()
            task.tp = tp
            self.model = task.build_model()
            self.tp_kinds = sharded_names(self.model)
            self.model.load_state_dict(shard_for_rank(whole, self.tp_kinds, tp.rank, tp.size))
            layout = ShardLayout(self.tp_kinds, tp) if self.tp_kinds else None
        self.model.to(self.device)
        self.optimizer = Optimizer(self.model.named_parameters(), self.hparams,
                                   carrier=task.carrier(), layout=layout)
        self.generator = torch.Generator(self.device)
        self.dropout_generator = torch.Generator(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        log.info("| model params: %.2fM on %s (rank %d of %d, model axis %d)", n_params / 1e6,
                 self.device, self.mesh.rank, self.mesh.size, self.mesh.model_parallel)

    def replicate(self) -> None:
        """Every replica of the data axis takes the first one's parameters
        and optimizer moments."""
        opt = self.optimizer
        moments = [*opt.mu.values(), *opt.nu.values(), *(opt.acc or {}).values()]
        replicate([*self.model.parameters(), *moments], self.mesh)

    def _seeded(self, stream: int, generator: Optional[torch.Generator] = None) -> torch.Generator:
        return (generator or self.generator).manual_seed(self.seed * 2 ** 32 + stream)

    def _data_mean(self, losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(zip(losses, data_mean(list(losses.values()), self.mesh)))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the losses, ``total_loss`` and the
        raw gradients' global norm, as device tensors (of the global batch
        on a data axis). A batch with ``_local_rows`` is this rank's rows."""
        self.model.train()
        batch = dict(batch)
        rows = batch.pop("_local_rows", None)
        dropout = self._seeded(DROPOUT_STREAM + self.global_step, self.dropout_generator)
        with batch_rows(rows), dropout_generator(dropout):
            losses = self.task.compute_losses(self.model, batch, self._seeded(self.global_step))
        total = sum(losses.values())
        for p in self.optimizer.params.values():
            p.grad = None
        total.backward()
        all_reduce_gradients(list(self.optimizer.params.values()), self.mesh)
        grad_norm = self.optimizer.global_norm(
            {n: p.grad for n, p in self.optimizer.params.items() if p.grad is not None})
        self.optimizer.step()
        metrics = self._data_mean({**{k: v.detach() for k, v in losses.items()},
                                   "total_loss": total.detach()})
        metrics["grad_norm"] = grad_norm
        return metrics

    @torch.no_grad()
    def val_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.model.eval()
        batch = dict(batch)
        rows = batch.pop("_local_rows", None)
        # one fixed stream for every validation batch, so evaluations compare
        with batch_rows(rows):
            losses = self.task.compute_losses(self.model, batch, self._seeded(2 ** 31))
        losses["total_loss"] = sum(losses.values())
        return self._data_mean(losses)

    # ---- checkpointing ------------------------------------------------------

    def params_tree(self) -> dict:
        """The model's weights as the JAX param tree of the one-process
        model (tensor-parallel slices gathered: every rank of the model
        axis calls it)."""
        sd = self.model.state_dict()
        if self.tp_kinds:
            sd = gather_state_dict(sd, self.tp_kinds, self.mesh.tp)
        return self.task.flax_tree(sd)

    def save_checkpoint(self, block: bool = True) -> Optional[str]:
        """Snapshot the weights and the optimizer state to the host, then
        write ``model_ckpt_steps_{step}.ckpt``: at once, or with
        ``async_save`` and ``block=False`` on a thread (the next save, the
        best copy and the end of ``fit`` join it). Rank 0 writes; the other
        ranks of its model axis gather with it, the rest return None."""
        if self.mesh.data_rank != 0:
            return None
        payload = {
            "global_step": int(self.global_step),
            "epoch": int(self.current_epoch),
            "checkpoint_callback_best": float(self.best_val),
            "state_dict": self.params_tree(),
            "optimizer_state": self.optimizer.state_dict(),
        }
        if not self.is_main:
            return None
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
        refused, as the JAX trainer's ``from_state_dict`` refuses it. Rank 0
        reads its work dir, where it wrote the checkpoints, and every rank
        takes what it read: the ranks resume at one step without a shared
        disk."""
        payload = from_rank0(
            ckpt_utils.load_last_checkpoint(self.work_dir) if self.is_main else None, self.mesh)
        if payload is None:
            return False
        opt_state = payload["optimizer_state"]
        if not opt_state:
            raise ValueError("the newest checkpoint has no optimizer state (convert_ckpt "
                             "writes none): the JAX trainer cannot resume it either")
        self.global_step = int(payload["global_step"])
        self.current_epoch = int(payload.get("epoch", 0))
        self.best_val = float(payload.get("checkpoint_callback_best", self.best_val))
        sd = self.task.state_dict_of(payload["state_dict"])
        if self.tp_kinds:
            sd = shard_for_rank(sd, self.tp_kinds, self.mesh.tp.rank, self.mesh.tp.size)
        self.model.load_state_dict(sd)
        self.optimizer.load_state_dict(opt_state)
        log.info("| restored checkpoint at step %d", self.global_step)
        return True

    def _profile(self, steps_this_session: int) -> None:
        """Start the profiler before this session's step 10, stop it
        ``profile_steps`` steps later (rank 0's)."""
        if not self.profile_steps or not self.is_main:
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
        self.replicate()
        writer = MetricsWriter(self.work_dir) if self.is_main else None
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
            while self.global_step < max_steps and not agree(preempted.is_set(), self.mesh):
                self.current_epoch += 1
                prefetcher = self._prefetcher(self._batches(task.train_iterator),
                                              depth=self.hparams.get("prefetch_to_device", 2))
                try:
                    for _, batch in prefetcher:
                        if self.global_step >= max_steps or agree(preempted.is_set(), self.mesh):
                            break
                        self._profile(steps_this_session)
                        metrics = self.train_step(batch)
                        self.global_step += 1
                        steps_this_session += 1
                        if self.global_step % self.tb_log_interval == 0:
                            self._log_train(metrics, writer)
                        if self.global_step % self.val_check_interval == 0:
                            val = self.evaluate(task, writer=writer)
                            improved = self._update_best(val.get("total_loss"))
                            self.save_checkpoint(block=False)
                            if self.is_main:
                                writer.add_scalars(val, self.global_step, prefix="val/")
                            if improved and self.is_main:
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
                if writer is not None:
                    writer.close()
                for sig, handler in prev_handlers.items():
                    signal.signal(sig, handler)
        if agree(preempted.is_set(), self.mesh) or self.global_step % self.val_check_interval != 0:
            self.save_checkpoint()
        log.info("| training done: %d steps in %.1fs", self.global_step, time.time() - t_start)

    def _log_train(self, metrics: Dict[str, torch.Tensor], writer: MetricsWriter) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        values["lr"] = self.optimizer.schedule(self.global_step)
        if self.check_nans and not math.isfinite(values["grad_norm"]):
            raise FloatingPointError(f"non-finite grad norm at step {self.global_step}")
        if writer is not None:
            writer.add_scalars(values, self.global_step, prefix="tr/")

    def _prefetcher(self, batch_iter, depth: int = 2) -> DevicePrefetcher:
        return DevicePrefetcher(batch_iter, self.device, depth=depth,
                                mesh=self.mesh if self.mesh.size > 1 else None)

    def _local_block(self):
        """This process's data blocks where it loads only its rows
        (``per_process_loading``, default true, on a world of several);
        None loads the global batch."""
        if self.mesh.size == 1 or not self.hparams.get("per_process_loading", True):
            return None
        return process_data_blocks(self.mesh)

    def _batches(self, make):
        """``make(n_devices, local_block=...)`` (a task's train or val
        iterator) loading this rank's rows where :meth:`_local_block` asks,
        unless the dataset lacks the item-lengths sidecar on one host: then
        the global batch, which the prefetcher cuts by ``shard_batch``.
        Logs once a dataset which way its batches are loaded."""
        block = self._local_block()
        batches = make(self.n_devices)
        if block is None:
            return batches
        ds = batches.dataset
        if ds.item_lengths is None and not self.hparams.get("multi_host", False):
            how = (f"the global batch on every rank, cut by shard_batch (no "
                   f"{ds.prefix}_item_lengths.npz sidecar)")
        else:
            batches = make(self.n_devices, local_block=block)  # raises without the sidecar
            how = f"this rank's rows (per-process loading, data blocks {block})"
        if ds.prefix not in self._loading_logged:
            self._loading_logged.add(ds.prefix)
            log.info("| %s batches: %s", ds.prefix, how)
        return batches

    def evaluate(self, task, max_batches: Optional[int] = None,
                 writer: Optional[MetricsWriter] = None) -> Dict[str, float]:
        """The validation losses, weighted by each batch's ``nsamples``; the
        task's plots of the first batch (data rank 0's rows), rendered by
        every rank of data rank 0's model axis, whose tensor-parallel model
        needs them all, and drawn under ``work_dir/plots`` by rank 0."""
        sums: Dict[str, float] = {}
        weights: Dict[str, float] = {}
        for i, (nsamples, batch) in enumerate(self._prefetcher(self._batches(task.val_iterator))):
            if max_batches is not None and i >= max_batches:
                break
            nsamples = nsamples or 1
            for k, v in self.val_step(batch).items():
                sums[k] = sums.get(k, 0.0) + float(v) * nsamples
                weights[k] = weights.get(k, 0.0) + nsamples
            if i == 0 and self.mesh.data_rank == 0:
                batch.pop("_local_rows", None)
                task.validation_plots(
                    self.model, batch, self.global_step,
                    os.path.join(self.work_dir, "plots") if self.is_main else None, writer=writer)
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


def train(hparams: dict, task_name: str, max_steps: Optional[int] = None, device=None) -> None:
    """``train TASK``: fit ``task_name`` on this process's rank (a world of
    one without a launcher's environment), then leave the process group."""
    from prodiff_tpu_torch.parallel.mesh import shutdown_distributed
    from prodiff_tpu_torch.tasks import get_task_cls

    try:
        Trainer(hparams, device=device).fit(get_task_cls(task_name)(hparams), max_steps=max_steps)
    finally:
        shutdown_distributed()
