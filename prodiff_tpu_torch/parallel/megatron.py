"""Tensor parallelism on the model axis (Megatron's split), the counterpart
of the JAX package's GSPMD sharding constraints on its ``model`` mesh axis
(``prodiff_tpu/models/common.py:109-213``, ``parallel/tp_wavenet.py``).

A column-parallel product holds a slice of its output channels, a
row-parallel one the matching slice of its input channels. Two autograd
operators join them: :meth:`TensorParallel.copy` (identity forward, the
gradient's all-reduce backward) before a column split, and
:meth:`TensorParallel.reduce` (all-reduce forward, identity backward) after
the row product. A bias after a row product is added once, after the reduce.

A module built with a ``TensorParallel`` holds only its rank's slices, under
the one-process module's names, and lists them in ``tp_kinds`` (local name
-> kind):

- ``gate``: rows of a WaveNet layer's ``[gate; filter]`` output, shard ``i``
  holding ``[g_i; f_i]`` (``tp_wavenet._tp_perm``);
- ``qkv``: rows of the attention's ``in_proj_weight``, the shard's heads of
  each of q, k and v;
- ``out``: a contiguous block of output channels (dim 0);
- ``in``: a contiguous block of input channels (dim 1).

:func:`shard_for_rank` cuts a one-process state dict into a rank's, and
:func:`gather_state_dict` puts the ranks' back together, so checkpoints keep
the one-process layout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from prodiff_tpu_torch.parallel.mesh import collective
from prodiff_tpu_torch.parallel.tp_wavenet import _tp_perm


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective(dist.all_reduce, g.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective(dist.all_reduce, x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """One model-axis group: this rank's index in it and its size."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def split(self, n: int, what: str = "channels") -> int:
        """This rank's share of ``n``."""
        if n % self.size:
            raise ValueError(f"{n} {what} not divisible by model_parallel={self.size}")
        return n // self.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Before a column-parallel product: x, its gradient summed over the axis."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """After a row-parallel product: the sum of the ranks' partial products."""
        return _Reduce.apply(x, self.group)

    def index(self, kind: str, n: int) -> torch.Tensor:
        """This rank's indices along a ``kind`` split of full extent ``n``:
        the ones :func:`shard_for_rank` cuts its slices with."""
        return _index(kind, n, self.rank, self.size)


def _dim(kind: str) -> int:
    return 1 if kind == "in" else 0


def _index(kind: str, n: int, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s indices along the split dim of a full extent ``n``."""
    s = n // size
    if kind == "gate":
        idx = _tp_perm(n // 2, size)[rank * s:(rank + 1) * s]
    elif kind == "qkv":
        e, w = n // 3, n // 3 // size
        idx = np.concatenate([np.arange(j * e + rank * w, j * e + (rank + 1) * w)
                              for j in range(3)])
    elif kind in ("out", "in"):
        idx = np.arange(rank * s, (rank + 1) * s)
    else:
        raise KeyError(f"tensor-parallel kind {kind!r}")
    return torch.as_tensor(idx)


def sharded_names(model: torch.nn.Module) -> Dict[str, str]:
    """name -> kind of every parameter that ``model``'s tensor-parallel
    modules hold a slice of."""
    out = {}
    for prefix, mod in model.named_modules():
        for local, kind in (getattr(mod, "tp_kinds", None) or {}).items():
            out[f"{prefix}.{local}" if prefix else local] = kind
    return out


def full_shape(kind: str, shape: Tuple[int, ...], size: int) -> Tuple[int, ...]:
    shape = list(shape)
    shape[_dim(kind)] *= size
    return tuple(shape)


def shard_for_rank(state_dict: Dict[str, torch.Tensor], kinds: Dict[str, str], rank: int,
                   size: int) -> Dict[str, torch.Tensor]:
    """A one-process state dict (name -> tensor) cut to rank ``rank``'s
    slices of the ``kinds`` names; the rest as it is."""
    out = {}
    for name, t in state_dict.items():
        kind = kinds.get(name)
        if kind is None:
            out[name] = t
            continue
        idx = _index(kind, t.shape[_dim(kind)], rank, size).to(t.device)
        out[name] = t.index_select(_dim(kind), idx).contiguous()
    return out


def gather_state_dict(state_dict: Dict[str, torch.Tensor], kinds: Dict[str, str],
                      tp: TensorParallel) -> Dict[str, torch.Tensor]:
    """The ranks' slices (name -> tensor) put back into the one-process
    tensors, on every rank of the model group; the inverse of
    :func:`shard_for_rank`. Every rank of the group must call it."""
    out = {}
    for name, t in state_dict.items():
        kind = kinds.get(name)
        if kind is None:
            out[name] = t
            continue
        on_host = t.is_cuda and dist.get_backend(tp.group) == dist.Backend.GLOO
        part = (t.detach().cpu() if on_host else t.detach()).contiguous()
        parts = [torch.empty_like(part) for _ in range(tp.size)]
        dist.all_gather(parts, part, group=tp.group)
        dim = _dim(kind)
        full = part.new_empty(full_shape(kind, tuple(part.shape), tp.size))
        for r, p in enumerate(parts):
            full.index_copy_(dim, _index(kind, full.shape[dim], r, tp.size).to(full.device), p)
        out[name] = full.to(t.device)
    return out


class ShardLayout:
    """The optimizer's view of a tensor-parallel model: the one-process
    shapes, the moments gathered and cut as the parameters are, and the
    gradients' global norm with each slice counted once."""

    def __init__(self, kinds: Dict[str, str], tp: TensorParallel):
        self.kinds, self.tp = kinds, tp

    def full_shape(self, name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        kind = self.kinds.get(name)
        return tuple(shape) if kind is None else full_shape(kind, tuple(shape), self.tp.size)

    def gather(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gather_state_dict(tensors, self.kinds, self.tp)

    def shard(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return shard_for_rank(tensors, self.kinds, self.tp.rank, self.tp.size)

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of the one-process gradients: the
        replicated ones once, the slices summed over the model axis."""
        def sq(names: Iterable[str]) -> torch.Tensor:
            zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
            return sum((torch.sum(grads[n].float() ** 2) for n in names), zero)

        sliced = sq(n for n in grads if n in self.kinds)
        collective(dist.all_reduce, sliced, self.tp.group)
        return torch.sqrt(sq(n for n in grads if n not in self.kinds) + sliced)
