"""Worker of the port's multi-process tests (``tests/test_torch_parallel.py``).

    python tests/torch_parallel_worker.py CASE N OUTDIR [ARG ...]

starts N ranks through ``parallel.mesh.launch_local`` (torchrun's
environment, ``gloo`` on the CPU) and runs ``CASE`` on each; the ranks write
what the test compares under OUTDIR. It imports torch and the port only.

Cases:
- ``dp_step DATA_DIR``: one data-parallel ``Trainer.train_step`` on the first
  global batch, loaded per process and, from a second trainer, as the
  global batch cut by ``shard_batch`` (the denoiser's output projection
  seeded: ``seed_output_projection``): the reduced gradients, the params
  after the update, the metrics and the rank's rows;
- ``tp_module NAME NPZ``: a two-rank tensor-parallel ``WaveNet`` or
  ``FastspeechEncoder`` (``NAME``) on the one-process weights and inputs of
  ``NPZ``: the output, and the gradients of ``sum(out * probe)`` gathered
  into the one-process layout;
- ``fit DATA_DIR``: ``Trainer.fit`` of 2 steps at ``model_parallel`` N, a
  constant learning rate of 1e-3, validated at step 2: each step's metrics
  and the mels the validation plots rendered;
- ``resume DATA_DIR WORK_DIR``: data-parallel ``Trainer.fit`` to step 3,
  rank 0 in WORK_DIR (which holds a checkpoint) and the others in empty
  work dirs of their own: the step each rank reached and its params;
- ``dp_fit DATA_DIR``: data-parallel ``Trainer.fit`` of one step (the
  output projection seeded) on a dataset without the item-lengths sidecar:
  the step's metrics, gradients and params; then the same with
  ``multi_host: true``, whose error it records;
- ``dropout_fit DATA_DIR``: ``Trainer.fit`` of one step with dropout 0.1 at
  a constant learning rate of 1e-3 (the output projection seeded), data
  parallel and then at ``model_parallel`` N: for each, the step's metrics,
  rows, gradients and params (tensor-parallel slices gathered) and every
  dropout mask the step drew, with whether its module splits its columns
  over the model axis;
- ``rendezvous``: before joining the group, whether the store's port
  (``MASTER_PORT``) already accepts a connection and whether the rank joins
  as a client of the launcher's store; then an all-reduce of the ranks;
- ``linger SECONDS``: 20 all-reduces, then rank 0 stays SECONDS longer
  than the others before it returns (how often a rank's exit aborts while
  its peer runs on: run it in a loop, against an earlier checkout too);
- ``sp_module NPZ [NPZ ...]``: a sequence-parallel ``WaveNet`` over the N
  ranks (``Mesh.sp``) on each NPZ's one-process weights, config and inputs
  (``in.kernels`` set: the card's stack route, its plain twins on the CPU):
  this rank's block length, the gathered output, the gradients of ``sum(out *
  probe)`` of the parameters (summed over the ranks) and of the gathered
  inputs.
"""

import os
import socket
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


OUT_PROJ = "diffusion.denoise_fn.output_projection.weight"


def seed_output_projection(model: torch.nn.Module) -> None:
    """The denoiser's zero-initialised output projection drawn from a seeded
    normal (std 0.02), so the first step's gradients reach every layer."""
    p = dict(model.named_parameters())[OUT_PROJ]
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def _hp(data_dir: str, outdir: str, **kw) -> dict:
    from prodiff_tpu_torch.utils.synthetic import small_hparams

    return small_hparams(data_dir, **{"dropout": 0.0, "work_dir": os.path.join(outdir, "work"),
                                      **kw})


def seeded_task(task):
    """``task`` building its model with the output projection seeded."""
    build = task.build_model

    def build_seeded():
        model = build()
        seed_output_projection(model)
        return model

    task.build_model = build_seeded
    return task


def record_masks():
    """``(masks, patch)``: within ``patch`` every keep mask a ``Dropout``
    draws is appended to ``masks`` as ``(splits its columns over the model
    axis, mask)``."""
    from unittest import mock

    from prodiff_tpu_torch.models.common import Dropout

    masks = []
    keep = Dropout.keep

    def recorded(self, shape, device):
        mask = keep(self, shape, device)
        masks.append((self.tp is not None, mask.clone()))
        return mask

    return masks, mock.patch.object(Dropout, "keep", recorded)


def dp_step(outdir: str, data_dir: str) -> None:
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    out = {}
    for per_process in (True, False):
        hp = _hp(data_dir, outdir, per_process_loading=per_process)
        trainer = Trainer(hp, device="cpu")
        task = get_task_cls("svs")(hp)
        trainer.build(task)
        seed_output_projection(trainer.model)
        trainer.replicate()
        batches = trainer._prefetcher(task.train_iterator(trainer.n_devices,
                                                          local_block=trainer._local_block()))
        _, batch = next(iter(batches))
        rows = batch["_local_rows"]
        metrics = trainer.train_step(batch)
        out[per_process] = {
            "rows": rows, "mel": batch["mel"],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
        }
    torch.save(out, os.path.join(outdir, f"rank{trainer.mesh.rank}.pt"))


def tp_module(outdir: str, name: str, npz: str) -> None:
    from prodiff_tpu_torch.models.encoder import FastspeechEncoder
    from prodiff_tpu_torch.models.wavenet import WaveNet
    from prodiff_tpu_torch.parallel.megatron import gather_state_dict, shard_for_rank, sharded_names
    from prodiff_tpu_torch.parallel.mesh import create_mesh, init_distributed

    data = dict(np.load(npz))
    mesh = create_mesh(model_parallel=2, device=init_distributed({}, device="cpu"))
    tp = mesh.tp
    if name == "wavenet":
        model = WaveNet(16, 32, 4, 128, 1, tp=tp)
        inputs = [torch.from_numpy(data.pop(k)) for k in ("in.x", "in.t", "in.cond")]
    else:
        model = FastspeechEncoder(32, 64, 2, num_heads=2, dropout=0.0, tp=tp)
        inputs = [torch.from_numpy(data.pop("in.tokens"))]
    probe = torch.from_numpy(data.pop("in.probe"))
    kinds = sharded_names(model)
    full = {k: torch.from_numpy(v) for k, v in data.items()}
    model.load_state_dict(shard_for_rank(full, kinds, tp.rank, tp.size))
    out = model(*inputs)
    (out * probe).sum().backward()
    grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()}, kinds, tp)
    back = gather_state_dict(model.state_dict(), kinds, tp)
    torch.save({"out": out.detach(), "grads": grads, "kinds": kinds,
                "round_trip": all(torch.equal(back[k], full[k]) for k in full)},
               os.path.join(outdir, f"rank{mesh.rank}.pt"))


def _recorded(trainer) -> list:
    """Each train step's metrics, appended as ``trainer`` takes it."""
    metrics = []
    step = trainer.train_step

    def recorded(batch):
        out = step(batch)
        metrics.append({k: float(v) for k, v in out.items()})
        return out

    trainer.train_step = recorded
    return metrics


def fit(outdir: str, data_dir: str) -> None:
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    # a constant learning rate: step 1 moves the zero-initialised output
    # projection, so step 2's gradients reach every layer; the validation
    # at step 2 renders the plots on both ranks of the model axis
    hp = _hp(data_dir, outdir, model_parallel=int(os.environ["WORLD_SIZE"]),
             val_check_interval=2, scheduler="constant", lr=1e-3)
    trainer = Trainer(hp, device="cpu")
    metrics = _recorded(trainer)
    task = get_task_cls("svs")(hp)
    mels = []
    infer = task.infer_mels

    def rendered(*args, **kwargs):
        mels.append(infer(*args, **kwargs).detach().clone())
        return mels[-1]

    task.infer_mels = rendered
    trainer.fit(task, max_steps=2)
    shapes = {n: tuple(p.shape) for n, p in trainer.model.named_parameters()}
    torch.save({"shapes": shapes, "kinds": trainer.tp_kinds, "metrics": metrics, "mels": mels},
               os.path.join(outdir, f"rank{trainer.mesh.rank}.pt"))


def resume(outdir: str, data_dir: str, work_dir: str) -> None:
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    rank = int(os.environ["RANK"])
    own = work_dir if rank == 0 else os.path.join(outdir, f"work_rank{rank}")
    hp = dict(_hp(data_dir, outdir, val_check_interval=1000), work_dir=own)
    trainer = Trainer(hp, device="cpu")
    trainer.fit(get_task_cls("svs")(hp), max_steps=3)
    files = sorted(os.listdir(own)) if os.path.isdir(own) else []
    torch.save({"global_step": trainer.global_step, "files": files,
                "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}},
               os.path.join(outdir, f"rank{rank}.pt"))


def dp_fit(outdir: str, data_dir: str) -> None:
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    hp = _hp(data_dir, outdir, val_check_interval=1000)
    trainer = Trainer(hp, device="cpu")
    metrics = _recorded(trainer)
    step = trainer.train_step
    rows, grads = [], {}

    def kept(batch):
        rows.append(batch["_local_rows"])
        out = step(batch)
        grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
        return out

    trainer.train_step = kept
    trainer.fit(seeded_task(get_task_cls("svs")(hp)), max_steps=1)
    out = {"metrics": metrics, "rows": rows, "grads": grads,
           "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()}}
    multi = dict(hp, multi_host=True, work_dir=os.path.join(outdir, "work_multi_host"))
    try:
        Trainer(multi, device="cpu").fit(get_task_cls("svs")(multi), max_steps=1)
        out["multi_host_error"] = None
    except ValueError as e:
        out["multi_host_error"] = str(e)
    torch.save(out, os.path.join(outdir, f"rank{trainer.mesh.rank}.pt"))


def dropout_fit(outdir: str, data_dir: str) -> None:
    from prodiff_tpu_torch.parallel.megatron import gather_state_dict
    from prodiff_tpu_torch.tasks import get_task_cls
    from prodiff_tpu_torch.training.trainer import Trainer

    masks, patch = record_masks()
    patch.start()
    out = {}
    for mp in (1, int(os.environ["WORLD_SIZE"])):
        hp = _hp(data_dir, outdir, dropout=0.1, model_parallel=mp, val_check_interval=1000,
                 scheduler="constant", lr=1e-3, work_dir=os.path.join(outdir, f"work_mp{mp}"))
        trainer = Trainer(hp, device="cpu")
        metrics = _recorded(trainer)
        step = trainer.train_step
        rows, grads = [], {}

        def kept(batch, trainer=trainer, step=step, rows=rows, grads=grads):
            rows.append(batch["_local_rows"])
            result = step(batch)
            grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters()})
            return result

        trainer.train_step = kept
        masks.clear()
        trainer.fit(seeded_task(get_task_cls("svs")(hp)), max_steps=1)
        params = trainer.model.state_dict()
        if trainer.tp_kinds:
            grads = gather_state_dict(grads, trainer.tp_kinds, trainer.mesh.tp)
            params = gather_state_dict(params, trainer.tp_kinds, trainer.mesh.tp)
        out[mp] = {"metrics": metrics, "rows": rows, "grads": grads, "masks": list(masks),
                   "params": {n: p.detach().clone() for n, p in params.items()},
                   "model_rank": trainer.mesh.model_rank}
    torch.save(out, os.path.join(outdir, f"rank{trainer.mesh.rank}.pt"))


def rendezvous(outdir: str) -> None:
    import torch.distributed as dist

    from prodiff_tpu_torch.parallel.mesh import AGENT_STORE_ENV, init_distributed

    try:
        socket.create_connection(("localhost", int(os.environ["MASTER_PORT"])), timeout=5).close()
        listening = True
    except OSError:
        listening = False
    agent = os.environ.get(AGENT_STORE_ENV)
    init_distributed({}, device="cpu")
    total = torch.ones(1)
    dist.all_reduce(total)
    torch.save({"listening": listening, "agent_store": agent, "world": float(total)},
               os.path.join(outdir, f"rank{dist.get_rank()}.pt"))


def linger(outdir: str, seconds: str) -> None:
    import time

    import torch.distributed as dist

    from prodiff_tpu_torch.parallel.mesh import init_distributed

    init_distributed({}, device="cpu")
    t = torch.ones(1000)
    for _ in range(20):
        dist.all_reduce(t)
    if dist.get_rank() == 0:
        time.sleep(float(seconds))
    torch.save({"sum": float(t[0])}, os.path.join(outdir, f"rank{dist.get_rank()}.pt"))


def sp_module(outdir: str, *npzs: str) -> None:
    from unittest import mock

    from prodiff_tpu_torch.models import wavenet
    from prodiff_tpu_torch.parallel.halo import gather_frames, split_frames
    from prodiff_tpu_torch.parallel.mesh import create_mesh, init_distributed, sum_model_gradients

    mesh = create_mesh(model_parallel=int(os.environ["WORLD_SIZE"]),
                       device=init_distributed({}, device="cpu"))
    sp = mesh.sp
    results = []
    for npz in npzs:
        data = dict(np.load(npz))
        in_dims, hidden, layers, channels, cycle = (int(v) for v in data.pop("cfg"))
        kernels = bool(data.pop("in.kernels", False))
        x, t, cond, probe = (torch.from_numpy(data.pop(f"in.{k}"))
                             for k in ("x", "t", "cond", "probe"))
        model = wavenet.WaveNet(in_dims, hidden, layers, channels, cycle, sp=sp)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in data.items()})
        xs = split_frames(x, sp).clone().requires_grad_()
        cs = split_frames(cond, sp).clone().requires_grad_()
        with mock.patch.object(wavenet, "on_kernels", lambda a, c: kernels):
            out = model(xs, t, cs)
            (out * split_frames(probe, sp)).sum().backward()
        sum_model_gradients(list(model.parameters()), mesh)
        results.append({
            "out": gather_frames(out.detach(), sp), "block": out.shape[1],
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "x_grad": gather_frames(xs.grad, sp), "cond_grad": gather_frames(cs.grad, sp)})
    torch.save(results, os.path.join(outdir, f"rank{mesh.rank}.pt"))


def run(case: str, outdir: str, args: tuple) -> None:
    torch.set_num_threads(2)
    {"dp_step": dp_step, "tp_module": tp_module, "fit": fit, "resume": resume,
     "dp_fit": dp_fit, "dropout_fit": dropout_fit, "rendezvous": rendezvous, "linger": linger,
     "sp_module": sp_module}[case](outdir, *args)


if __name__ == "__main__":
    from prodiff_tpu_torch.parallel.mesh import launch_local

    case, n, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    launch_local(n, run, (case, outdir, tuple(sys.argv[4:])))
