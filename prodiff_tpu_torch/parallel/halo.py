"""Sequence parallelism of the WaveNet denoiser: the frame axis split over the
ranks of a process group, each rank computing its block of frames from a
window that carries a halo of its neighbours' frames.

No file of the JAX package is its counterpart. There ``WaveNet(sp_axis=...)``
constrains ``spec`` and ``cond`` to be sharded on the frame axis over a mesh
axis (``with_sharding_constraint``), and GSPMD inserts the k = 3 convs' halo
exchanges. Here the same is built by hand:

- rank ``r`` of ``n`` holds block ``r`` of the T frames, as
  ``torch.tensor_split`` cuts them (the first ``T % n`` blocks one frame
  longer): :func:`split_frames`, :func:`block_bounds`;
- it runs the whole denoiser on its window ``[lo - h, hi + h)`` clipped to
  ``[0, T)``, ``h`` = :func:`halo_width` (the sum of the layers' dilations),
  and keeps the rows of its block (:func:`on_window`). The window's frames
  that other ranks own come by point-to-point exchange over the group
  (:class:`HaloExchange`, ``dist.batch_isend_irecv``) from every rank the
  window spans, so a block shorter than ``h`` works;
- the convs pad the window's ends with zeros. At the sequence's true ends
  that is the unsharded forward's own "SAME" padding. At an inner end the
  error it brings in moves one dilation a layer, so after all layers it
  stays inside the ``h`` frames that are cut off. This is K1b's tiled scheme
  (``prodiff_tpu/ops/pallas/wavenet.py:261``) across ranks;
- the exchange's backward sends each halo row's gradient to the rank that
  owns the frame, which adds it to its own. A rank's parameter gradients
  are then its block's share of the loss's, and ``mesh.sum_model_gradients``
  sums them over the group into the unsharded gradient.

gloo exchanges host tensors (CUDA tensors are staged through the host, as
``mesh.collective`` does); NCCL exchanges the card's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from prodiff_tpu_torch.parallel.mesh import _on_host


@dataclass(frozen=True)
class SequenceParallel:
    """The process group the frame axis is split over, this rank's place in
    it and its size."""

    group: object
    rank: int
    size: int

    def peer(self, s: int) -> int:
        """Rank ``s`` of the group as a global rank."""
        return dist.get_global_rank(self.group, s)


def halo_width(n_layers: int, dilation_cycle_length: int = 1) -> int:
    """The frames a side that one output frame depends on: the sum of the
    layers' dilations (``n_layers`` at cycle 1)."""
    return sum(2 ** (i % dilation_cycle_length) for i in range(n_layers))


def block_bounds(lengths: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Each rank's ``[lo, hi)`` from the blocks' lengths, in rank order."""
    out, lo = [], 0
    for n in lengths:
        out.append((lo, lo + int(n)))
        lo += int(n)
    return tuple(out)


@dataclass(frozen=True)
class Window:
    """Rank ``rank``'s block ``bounds[rank]`` and its window: the block and
    ``h`` frames a side, clipped to the sequence."""

    bounds: Tuple[Tuple[int, int], ...]
    rank: int
    h: int

    def of(self, s: int) -> Tuple[int, int]:
        lo, hi = self.bounds[s]
        return max(0, lo - self.h), min(self.bounds[-1][1], hi + self.h)

    @property
    def block(self) -> Tuple[int, int]:
        return self.bounds[self.rank]

    @property
    def span(self) -> Tuple[int, int]:
        return self.of(self.rank)

    @property
    def cut(self) -> slice:
        """The block's rows within the window."""
        (lo, hi), start = self.block, self.span[0]
        return slice(lo - start, hi - start)

    def needs(self, s: int) -> Tuple[int, int]:
        """The frames of rank ``s``'s block in this rank's window (empty:
        ``lo >= hi``)."""
        (a, b), (lo, hi) = self.span, self.bounds[s]
        return max(a, lo), min(b, hi)

    def gives(self, s: int) -> Tuple[int, int]:
        """The frames of this rank's block in rank ``s``'s window."""
        (a, b), (lo, hi) = self.of(s), self.block
        return max(a, lo), min(b, hi)


def _all_gather(t: torch.Tensor, sp: SequenceParallel) -> List[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), on ``t``'s device."""
    host = _on_host(sp.group) and t.is_cuda
    src = t.cpu() if host else t.contiguous()
    out = [torch.empty_like(src) for _ in range(sp.size)]
    dist.all_gather(out, src, group=sp.group)
    return [o.to(t.device) for o in out] if host else out


def window_of(n_frames: int, sp: SequenceParallel, h: int, device: torch.device) -> Window:
    """This rank's window, from every rank's block length (one all-gather)."""
    lengths = _all_gather(torch.tensor([n_frames], dtype=torch.int64, device=device), sp)
    return Window(block_bounds([int(n) for n in lengths]), sp.rank, h)


def _exchange(sp: SequenceParallel, sends: list, recvs: list) -> None:
    """Point to point over the group: each ``(s, tensor)`` of ``sends`` to
    rank ``s``, each ``(s, buffer)`` of ``recvs`` filled from rank ``s``, in
    one batch (two messages between a pair in one direction pair up in list
    order)."""
    if not sends and not recvs:
        return
    host = _on_host(sp.group)

    def wire(t):
        return t.cpu() if host and t.is_cuda else t.contiguous()

    landing = [torch.empty(b.shape, dtype=b.dtype) if host and b.is_cuda else b for _, b in recvs]
    ops = [dist.P2POp(dist.isend, wire(t), sp.peer(s), sp.group) for s, t in sends]
    ops += [dist.P2POp(dist.irecv, buf, sp.peer(s), sp.group)
            for (s, _), buf in zip(recvs, landing)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for (_, b), buf in zip(recvs, landing):
        if buf is not b:
            b.copy_(buf)


def _frames(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_empty((x.shape[0], n, *x.shape[2:]))


def gather_window(win: Window, sp: SequenceParallel,
                  blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each block [B, T_r, ...] -> its window [B, W, ...]: the block's own
    rows and the others' frames the window spans, received from them."""
    start, stop = win.span
    outs = [_frames(x, stop - start) for x in blocks]
    for x, out in zip(blocks, outs):
        out[:, win.cut] = x
    sends, recvs, places = [], [], []
    lo = win.block[0]
    for s in range(sp.size):
        if s == win.rank:
            continue
        (a, b), (c, d) = win.gives(s), win.needs(s)
        for x, out in zip(blocks, outs):
            if b > a:
                sends.append((s, x[:, a - lo:b - lo]))
            if d > c:
                buf = _frames(x, d - c)
                recvs.append((s, buf))
                places.append((out, c - start, buf))
    _exchange(sp, sends, recvs)
    for out, at, buf in places:
        out[:, at:at + buf.shape[1]] = buf
    return outs


def return_halo(win: Window, sp: SequenceParallel,
                grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The transpose of :func:`gather_window`: each window's gradient [B, W,
    ...] -> its block's [B, T_r, ...], the block's own rows plus what the
    other ranks' windows sent back for this rank's frames."""
    start = win.span[0]
    lo = win.block[0]
    outs = [g[:, win.cut].clone() for g in grads]
    sends, recvs, places = [], [], []
    for s in range(sp.size):
        if s == win.rank:
            continue
        (a, b), (c, d) = win.gives(s), win.needs(s)
        for g, out in zip(grads, outs):
            if d > c:
                sends.append((s, g[:, c - start:d - start]))
            if b > a:
                buf = _frames(g, b - a)
                recvs.append((s, buf))
                places.append((out, a - lo, buf))
    _exchange(sp, sends, recvs)
    for out, at, buf in places:
        out[:, at:at + buf.shape[1]] += buf
    return outs


class HaloExchange(torch.autograd.Function):
    """``(window, sp, *blocks) -> windows``: :func:`gather_window`, whose
    backward is :func:`return_halo`."""

    @staticmethod
    def forward(ctx, win, sp, *blocks):
        ctx.win, ctx.sp = win, sp
        return tuple(gather_window(win, sp, blocks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *return_halo(ctx.win, ctx.sp, grads))


def on_window(fn: Callable[..., torch.Tensor], sp: SequenceParallel, h: int,
              *blocks: torch.Tensor) -> torch.Tensor:
    """``fn(*windows)`` on this rank's window of each block [B, T_r, ...]
    (frame axis 1, one block length for all), cut back to the block's rows:
    this rank's block of ``fn`` on the whole sequence, where each output
    frame of ``fn`` depends on at most ``h`` frames a side."""
    win = window_of(blocks[0].shape[1], sp, h, blocks[0].device)
    windows = HaloExchange.apply(win, sp, *blocks)
    return fn(*windows)[:, win.cut]


def split_frames(x: torch.Tensor, sp: SequenceParallel) -> torch.Tensor:
    """This rank's block of ``x``'s frames (axis 1), ``torch.tensor_split``'s."""
    return torch.tensor_split(x, sp.size, dim=1)[sp.rank]


def gather_frames(x: torch.Tensor, sp: SequenceParallel) -> torch.Tensor:
    """Every rank's block of frames (axis 1), joined in rank order, on every
    rank: the inverse of :func:`split_frames`."""
    lengths = [int(n) for n in _all_gather(torch.tensor([x.shape[1]], device=x.device), sp)]
    padded = _frames(x, max(lengths)).zero_()
    padded[:, :x.shape[1]] = x
    parts = _all_gather(padded, sp)
    return torch.cat([p[:, :n] for p, n in zip(parts, lengths)], dim=1)
