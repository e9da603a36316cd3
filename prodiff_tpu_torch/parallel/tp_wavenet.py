"""Tensor-parallel WaveNet residual stack (port of
``prodiff_tpu/parallel/tp_wavenet.py``): Megatron's split of the denoiser's
residual channels over the model axis, one all-reduce a layer.

Per layer:

- the dilated conv (k=3, d=1) and the conditioner projection are
  column-parallel: a rank holds the rows of its slice of the 2C outputs,
  permuted to ``[g_i; f_i]`` (:func:`_tp_perm`), so the gating is local and
  the gates come out in the original channel order, sharded;
- the output projection is row-parallel: a rank holds its ``s = C / mp``
  input rows, and the partial products are all-reduced before the bias, the
  residual and the skip sum.

The products are ``torch.matmul`` on the stacked slices
(``WaveNet.stacked_weights``), float32, as the JAX route's einsums with
``preferred_element_type=float32`` on float32 stacks. The JAX package's TP
route takes precedence over its Pallas kernel and runs none, so there is no
kernel here either.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from prodiff_tpu_torch.ops.wavenet_stack import RSQRT2, StackedWaveNet


def _tp_perm(c: int, mp: int) -> np.ndarray:
    """2C-column permutation: [gate(C); filt(C)] -> per-shard [g_i; f_i]."""
    s = c // mp
    idx = []
    for i in range(mp):
        idx.extend(range(i * s, (i + 1) * s))
        idx.extend(range(c + i * s, c + (i + 1) * s))
    return np.asarray(idx, np.int64)


def wavenet_apply_tp(w: StackedWaveNet, x: torch.Tensor, cond: torch.Tensor,
                     step: torch.Tensor, tp) -> torch.Tensor:
    """The residual stack on one rank: ``w`` this rank's stacked slices
    (``dilated_w`` [L, 3, C, 2s], ``cond_w`` [L, H, 2s], ``out_w`` [L, s, 2C]),
    x [B, T, C] after the input projection, cond [B, T, H], step [B, C] after
    the step MLP -> the skip sum over sqrt(L), [B, T, C] on every rank of
    ``tp`` (a ``megatron.TensorParallel``)."""
    n_layers, _, c, s2 = w.dilated_w.shape
    s = s2 // 2
    cond = tp.copy(cond)  # every layer's column products read it
    skip_sum = torch.zeros_like(x)
    for l in range(n_layers):
        y = tp.copy(x + (step @ w.diff_w[l] + w.diff_b[l])[:, None, :])
        y_prev = F.pad(y, (0, 0, 1, 0))[:, :-1]
        y_next = F.pad(y, (0, 0, 0, 1))[:, 1:]
        z = (y @ w.dilated_w[l, 1] + y_prev @ w.dilated_w[l, 0] + y_next @ w.dilated_w[l, 2]
             + w.dilated_b[l] + cond @ w.cond_w[l] + w.cond_b[l])
        gate = torch.sigmoid(z[..., :s]) * torch.tanh(z[..., s:])
        o = tp.reduce(gate @ w.out_w[l]) + w.out_b[l]
        x = (x + o[..., :c]) * RSQRT2
        skip_sum = skip_sum + o[..., c:]
    return skip_sum * (1.0 / math.sqrt(n_layers))
