"""The optimizer stack, with optax's semantics (port of
``prodiff_tpu/training/optim.py``).

``optax.chain(clip(clip_grad_value), clip_by_global_norm(clip_grad_norm),
adamw(rsqrt schedule, b1, b2, eps=1e-8, weight_decay))``, wrapped in
``optax.MultiSteps`` when ``accumulate_grad_batches > 1``, written out on
named tensors. Where optax and ``torch.optim`` differ, this follows optax:

- the global-norm clip scales by ``max_norm / norm`` when ``norm >=
  max_norm``, with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- ``weight_decay`` comes from the hparams, 0 by default (``torch.optim.AdamW``
  defaults to 0.01), and is added to the Adam direction before the learning
  rate scales it;
- the schedule is read at the count of updates made so far, before this one
  (optax's ``scale_by_schedule``), so the first update uses the rsqrt
  schedule's 1e-7 floor;
- accumulation keeps the running mean of k micro-gradients and updates on
  the k-th; the updates in between are zero and leave the Adam state and
  the schedule's count alone.

The state (``state_dict``) is the tree of optax's state that the JAX
trainer checkpoints (``utils/convert.py:optimizer_flax_state``), its moments
carried by the task's weight carrier; ``load_state_dict`` also reads the
port's older layout (``count``, ``mini_step``, ``mu``, ``nu``, ``acc``).

On a tensor-parallel model a ``layout`` (``parallel.megatron.ShardLayout``)
makes the clip's global norm count each slice once, and the state the
one-process tree: the moments gathered on save and cut on load.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from prodiff_tpu_torch.utils.convert import (
    Carrier,
    check_permutation,
    flat_carrier,
    optimizer_flax_state,
    optimizer_state_from_flax,
)


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int) -> Callable[[int], float]:
    """lr * min(t/warmup, 1) * max(warmup, t)^-0.5 * H^-0.5, floored at 1e-7."""

    def schedule(step: int) -> float:
        warmup = min(step / warmup_updates, 1.0)
        rsqrt_decay = max(float(warmup_updates), float(step)) ** -0.5
        return max(lr * warmup * rsqrt_decay * hidden_size ** -0.5, 1e-7)

    return schedule


def build_lr_schedule(hparams: dict) -> Callable[[int], float]:
    if hparams.get("scheduler", "rsqrt") == "rsqrt":
        return rsqrt_schedule(hparams["lr"], hparams["warmup_updates"], hparams["hidden_size"])
    return lambda step: float(hparams["lr"])


class Optimizer:
    """AdamW + clipping + accumulation over ``named_params`` (name ->
    parameter); :meth:`step` reads each parameter's ``.grad``. ``carrier``
    maps a name -> tensor map to the JAX param tree and back (the task's;
    by default the names are the tree's keys). ``layout``: a tensor-parallel
    model's (its parameters are slices), or None."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], hparams: dict,
                 carrier: Optional[Carrier] = None, layout=None):
        self.params = {n: p for n, p in named_params if p.requires_grad}
        self.hparams = hparams
        self.carrier = carrier or flat_carrier()
        self.layout = layout
        self._carrier_checked = False
        self.schedule = build_lr_schedule(hparams)
        self.clip_value = hparams.get("clip_grad_value", 0) or 0
        self.clip_norm = hparams.get("clip_grad_norm", 0) or 0
        self.b1 = hparams.get("optimizer_adam_beta1", 0.9)
        self.b2 = hparams.get("optimizer_adam_beta2", 0.98)
        self.eps = 1e-8
        self.weight_decay = hparams.get("weight_decay", 0) or 0.0
        self.accum = max(int(hparams.get("accumulate_grad_batches", 1) or 1), 1)
        self.count = 0  # inner updates made (the schedule's step)
        self.mini_step = 0  # micro-batches accumulated towards the next update
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                    if self.accum > 1 else None)

    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self) -> bool:
        """Apply (or accumulate) the current ``.grad``s; True when the
        parameters changed."""
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.params.items()}
        if self.acc is not None:
            for n, g in grads.items():
                self.acc[n] += (g - self.acc[n]) / (self.mini_step + 1)
            if self.mini_step < self.accum - 1:
                self.mini_step += 1
                return False
            grads, self.mini_step = self.acc, 0
        self._update(grads)
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()
        return True

    def _update(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.clip_value:
            grads = {n: g.clamp(-self.clip_value, self.clip_value) for n, g in grads.items()}
        if self.clip_norm:
            norm = self.global_norm(grads)
            keep = norm < self.clip_norm  # a device flag: no host sync
            grads = {n: torch.where(keep, g, (g / norm) * self.clip_norm)
                     for n, g in grads.items()}
        k = self.count + 1
        bc1 = 1.0 - float(np.float32(self.b1) ** np.float32(k))
        bc2 = 1.0 - float(np.float32(self.b2) ** np.float32(k))
        neg_lr = -self.schedule(self.count)
        for n, p in self.params.items():
            g, mu, nu = grads[n], self.mu[n], self.nu[n]
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.add_(neg_lr * upd)
        self.count = k

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm the clip reads: of the one-process gradients."""
        if self.layout is not None:
            return self.layout.global_norm(grads)
        return global_norm(grads.values())

    def _check_carrier(self) -> None:
        """Once: the carrier moves the moments' elements without combining them."""
        if not self._carrier_checked:
            full = self.layout.full_shape if self.layout is not None else lambda n, s: tuple(s)
            check_permutation(self.carrier, {n: full(n, p.shape) for n, p in self.params.items()})
            self._carrier_checked = True

    def state_dict(self) -> dict:
        """Optax's state tree for ``build_optimizer(hparams)``, host arrays
        (with a layout: gathered, on every rank of the model axis)."""
        self._check_carrier()
        whole = self.layout.gather if self.layout is not None else lambda d: d
        state = {"count": self.count, "mini_step": self.mini_step, "mu": whole(self.mu),
                 "nu": whole(self.nu), "acc": None if self.acc is None else whole(self.acc)}
        return optimizer_flax_state(state, self.carrier, self.hparams)

    def load_state_dict(self, state: dict) -> None:
        """Optax's state tree, or the port's older layout (``count``,
        ``mini_step``, ``mu``, ``nu``, ``acc``: name -> array)."""
        if "mu" not in state:
            self._check_carrier()
            state = optimizer_state_from_flax(state, self.carrier, self.hparams)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for key in ("mu", "nu", "acc"):
            dst = getattr(self, key)
            if dst is None:
                continue
            src = {n: torch.as_tensor(np.array(state[key][n])) for n in dst}
            if self.layout is not None:
                src = self.layout.shard(src)
            for n, t in dst.items():
                t.copy_(src[n])


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
