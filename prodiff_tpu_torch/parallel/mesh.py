"""The process layout of multi-GPU training (port of
``prodiff_tpu/parallel/mesh.py``).

The JAX trainer runs one SPMD program over a ``jax.sharding.Mesh``: the batch
sharded on a ``data`` axis, the parameters replicated, and with
``model_parallel > 1`` a minor ``model`` axis that carries the teacher's
tensor parallelism. Here every device is one process of a
``torch.distributed`` group (one rank a card), laid out the same way: rank
``r`` sits at (data ``r // mp``, model ``r % mp``), so the model axis is the
minor one and a model group holds adjacent ranks.

- :func:`init_distributed` joins the process group from a launcher's
  environment (torchrun's), the counterpart of ``jax.distributed.initialize()``;
- :func:`create_mesh` lays the group out, one group a column (the data axis)
  and one a row (the model axis);
- :func:`process_data_blocks` names the data blocks whose rows a process
  loads (``BatchIterator(local_block=...)``), :func:`shard_batch` gives a
  rank its rows of a host-global batch, or keeps a per-process batch's own;
- :func:`replicate` broadcasts the parameters and the optimizer state from
  the first rank of the data axis, :func:`all_reduce_gradients` takes the
  data axis's mean of the gradients in one flat bucket;
- :func:`batch_rows` / :func:`draw_rows`: a rank's random draws (diffusion
  steps, noise) are its rows of the global batch's draws, so the ranks'
  step is the one-process step on the global batch;
- :func:`agree` and :func:`from_rank0` go over a ``gloo`` group on host
  tensors (``Mesh.host_group``), so a per-step signal check costs no device
  synchronisation under NCCL;
- :func:`sum_model_gradients` sums the gradients over the model axis, where
  each rank of a sequence-parallel denoiser (``Mesh.sp``,
  ``parallel/halo.py``) holds its frames' share;
- :func:`rendezvous` holds the process group's store for spawned ranks, and
  :func:`launch_local` starts one worker process a local card under it.

Without a process group every function acts on a world of one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from prodiff_tpu_torch.device import Device, resolve_device

LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# torchrun's agent sets it where the agent, not rank 0, serves the store
AGENT_STORE_ENV = "TORCHELASTIC_USE_AGENT_STORE"
JOIN_TIMEOUT = datetime.timedelta(minutes=10)


def launcher_env() -> Optional[Dict[str, str]]:
    """torchrun's variables, or None where none is set; a partial set raises
    (no quiet one-process run)."""
    present = {k: os.environ[k] for k in LAUNCHER_ENV if k in os.environ}
    if not present:
        return None
    missing = [k for k in LAUNCHER_ENV if k not in present]
    if missing:
        raise RuntimeError(f"the launcher environment is half set: {sorted(present)} without "
                           f"{missing} (torchrun sets all of {list(LAUNCHER_ENV)})")
    return present


def init_distributed(hp: Dict[str, Any], backend: Optional[str] = None,
                     device: Optional[Device] = None) -> torch.device:
    """Join the process group and return this rank's device.

    A group the caller initialised is kept. Otherwise torchrun's environment
    starts one (``env://``), on ``backend`` or, unless named, ``nccl`` for a
    CUDA device and ``gloo`` for the CPU; the device is ``cuda:LOCAL_RANK``
    unless the caller names one. Without that environment the run is one
    process, and ``multi_host: true`` raises."""
    env = launcher_env()
    local_rank = int(env["LOCAL_RANK"]) if env else None
    if dist.is_initialized():
        return resolve_device(device, local_rank)
    if env is None:
        if hp.get("multi_host", False):
            raise RuntimeError(
                "multi_host: true needs a launcher's environment (torchrun sets "
                f"{', '.join(LAUNCHER_ENV)}); none of it is set")
        return resolve_device(device)
    dev = resolve_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", world_size=int(env["WORLD_SIZE"]),
                            rank=int(env["RANK"]), timeout=JOIN_TIMEOUT)
    return dev


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_grid(n: int, model_parallel: int = 1) -> np.ndarray:
    """The ranks laid out [data, model], the model axis minor (the JAX
    mesh's device grid)."""
    if model_parallel <= 1:
        return np.arange(n).reshape(n, 1)
    assert n % model_parallel == 0, (
        f"{n} devices not divisible by model_parallel={model_parallel}"
    )
    return np.arange(n).reshape(n // model_parallel, model_parallel)


@dataclass
class Mesh:
    """This rank's place in the (data, model) grid and its two groups (None
    where the axis holds this rank alone); ``host_group``: the whole world
    over ``gloo`` (None in a world of one)."""

    grid: np.ndarray
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None

    @property
    def size(self) -> int:
        return self.grid.size

    @property
    def n_data(self) -> int:
        return self.grid.shape[0]

    @property
    def model_parallel(self) -> int:
        return self.grid.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel

    @property
    def tp(self):
        """The model axis as a ``megatron.TensorParallel``, or None at
        ``model_parallel: 1``."""
        if self.model_parallel == 1:
            return None
        from prodiff_tpu_torch.parallel.megatron import TensorParallel

        return TensorParallel(self.model_group, self.model_rank, self.model_parallel)

    @property
    def sp(self):
        """The model axis as a ``halo.SequenceParallel`` (the frame axis
        split over it), or None at ``model_parallel: 1``."""
        if self.model_parallel == 1:
            return None
        from prodiff_tpu_torch.parallel.halo import SequenceParallel

        return SequenceParallel(self.model_group, self.model_rank, self.model_parallel)


def create_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                device: Optional[Device] = None) -> Mesh:
    """The process group as a (data, model) grid. ``n_devices`` (default: the
    world) must be the world's size; the world must divide by
    ``model_parallel`` (the JAX mesh's assertion)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    grid = mesh_grid(n, model_parallel)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} processes: the port's "
                         "mesh spans the whole process group, one rank a device")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device) if device is not None else torch.device("cpu")
    mesh = Mesh(grid, rank, dev)
    if world == 1:
        return mesh
    # every rank makes every group, in the same order
    on_gloo = dist.get_backend() == dist.Backend.GLOO
    mesh.host_group = dist.group.WORLD if on_gloo else dist.new_group(backend="gloo")
    if grid.shape[1] == 1:
        mesh.data_group = dist.group.WORLD
    else:
        for j in range(grid.shape[1]):
            g = dist.new_group(grid[:, j].tolist())
            if rank in grid[:, j]:
                mesh.data_group = g if grid.shape[0] > 1 else None
        for i in range(grid.shape[0]):
            g = dist.new_group(grid[i].tolist())
            if rank in grid[i]:
                mesh.model_group = g
    return mesh


def process_data_blocks(mesh: Mesh) -> Tuple[int, int, int]:
    """``(lo, hi, n_blocks)``: the data-axis blocks whose batch rows this
    process loads; a global batch of B rows maps block ``i`` to rows
    ``[i*B//n, (i+1)*B//n)``. A process is one rank here, so one block."""
    return mesh.data_rank, mesh.data_rank + 1, mesh.n_data


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a numpy batch, with ``_local_rows=(row0,
    global_B)``. A per-process batch (``BatchIterator(local_block=...)``)
    already holds only its rows and its ``_local_rows``; a host-global one is
    cut to rows ``[i*B//n, (i+1)*B//n)`` of data rank ``i``."""
    if "_local_rows" in batch:
        return batch
    arrays = [v for v in batch.values() if isinstance(v, np.ndarray) and v.ndim >= 1]
    b = arrays[0].shape[0]
    n, i = mesh.n_data, mesh.data_rank
    if b % n:
        raise ValueError(f"a batch of {b} rows does not split over {n} data ranks")
    row0, row1 = i * b // n, (i + 1) * b // n
    out = {k: v[row0:row1] if isinstance(v, np.ndarray) and v.ndim >= 1 else v
           for k, v in batch.items()}
    out["_local_rows"] = (row0, b)
    return out


def _on_host(group) -> bool:
    """gloo's collectives run on host tensors here (its CUDA support is
    partial); NCCL's on the card."""
    return dist.get_backend(group) == dist.Backend.GLOO


def collective(fn: Callable[..., Any], t: torch.Tensor, group, **kw) -> torch.Tensor:
    """``fn(t, group=group, **kw)`` in place, on a host copy for gloo."""
    if t.is_cuda and _on_host(group):
        host = t.cpu()
        fn(host, group=group, **kw)
        t.copy_(host)
    else:
        fn(t, group=group, **kw)
    return t


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast ``tensors`` (parameters, optimizer moments) from the first
    rank of this rank's data column: every replica starts equal."""
    if mesh.n_data == 1:
        return
    src = int(mesh.grid[0, mesh.model_rank])
    with torch.no_grad():
        for t in tensors:
            collective(dist.broadcast, t, mesh.data_group, src=src)


def _sum_bucket(params: Sequence[torch.nn.Parameter], group, divisor: int = 1) -> None:
    """Each gradient becomes its sum over ``group`` over ``divisor``: one
    all-reduce of all of them flattened into one bucket."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    collective(dist.all_reduce, flat, group)
    if divisor != 1:
        flat /= divisor
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def all_reduce_gradients(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Each gradient becomes its mean over the data axis."""
    if mesh.n_data > 1:
        _sum_bucket(params, mesh.data_group, mesh.n_data)


def sum_model_gradients(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Each gradient becomes its sum over the model axis: a sequence-parallel
    rank's gradients are its frames' share of the loss's, and their sum is
    the unsharded gradient."""
    if mesh.model_parallel > 1:
        _sum_bucket(params, mesh.model_group)


def data_mean(values: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Scalars averaged over the data axis (the ranks' mean losses, each of
    an equal-shaped batch, average to the global batch's)."""
    if mesh.n_data == 1:
        return list(values)
    stacked = torch.stack([v.detach().float() for v in values])
    collective(dist.all_reduce, stacked, mesh.data_group)
    return list(stacked / mesh.n_data)


def agree(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when it is true on any (a signal caught by one)."""
    if mesh.size == 1:
        return flag
    t = torch.tensor([float(flag)])
    dist.all_reduce(t, group=mesh.host_group, op=dist.ReduceOp.MAX)
    return bool(t.item())


def from_rank0(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's ``obj`` on every rank (pickled over the host group): what
    rank 0 reads from its own disk, such as the checkpoint it wrote."""
    if mesh.size == 1:
        return obj
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


_ROWS = threading.local()


@contextlib.contextmanager
def batch_rows(rows: Optional[Tuple[int, int]]):
    """Within: :func:`draw_rows` draws at the global batch's ``rows[1]`` rows
    and keeps this rank's, from ``rows[0]``; None keeps the draws as asked."""
    before = getattr(_ROWS, "rows", None)
    _ROWS.rows = rows
    try:
        yield
    finally:
        _ROWS.rows = before


def draw_rows(fn: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``fn(shape)`` for a batch-leading ``shape``; inside :func:`batch_rows`
    this rank's rows of ``fn`` at the global batch's shape, so the ranks
    together draw what one process draws for the whole batch."""
    rows = getattr(_ROWS, "rows", None)
    if rows is None:
        return fn(tuple(shape))
    row0, b = rows
    return fn((b, *shape[1:]))[row0:row0 + shape[0]]


@contextlib.contextmanager
def rendezvous() -> Iterator[int]:
    """Within: a ``TCPStore`` server on a port the system picked when it was
    bound, held by this process; yields that port. Ranks started within join
    it as clients (``AGENT_STORE_ENV``, as under torchrun's agent), so no port
    is chosen, released and bound again later by rank 0, when another
    process may hold it."""
    store = dist.TCPStore("localhost", 0, is_master=True, wait_for_workers=False,
                          timeout=JOIN_TIMEOUT)
    try:
        yield store.port
    finally:
        del store


def _worker(i: int, n: int, port: int, precision: str, fn: Callable, args: tuple) -> None:
    """Rank ``i``: ``fn(*args)``, then leave the process group it joined.
    A rank that exits still in a gloo group whose peer is still running can
    abort in the group's teardown ("terminate called without an active
    exception")."""
    os.environ.update(WORLD_SIZE=str(n), RANK=str(i), LOCAL_RANK=str(i),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port), **{AGENT_STORE_ENV: "True"})
    from prodiff_tpu_torch import device

    device.set_precision(precision)
    try:
        fn(*args)
    finally:
        shutdown_distributed()


def launch_local(n: int, fn: Callable, args: tuple = ()) -> None:
    """Run ``fn(*args)`` in ``n`` spawned processes with torchrun's
    environment (rank ``i`` on local card ``i``) and the caller's precision
    mode, joined to the store this process holds (:func:`rendezvous`), each
    leaving its process group when ``fn`` returns; a failing worker raises
    here."""
    import torch.multiprocessing as mp

    from prodiff_tpu_torch import device

    with rendezvous() as port:
        mp.start_processes(_worker, args=(n, port, device.precision(), fn, args),
                           nprocs=n, join=True, start_method="spawn")
