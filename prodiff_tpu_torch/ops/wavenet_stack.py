"""The WaveNet residual stack: CUDA kernel wrapper and its plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/wavenet.py`` (``fused_residual_stack`` and
``fused_residual_stack_tiled``, one entry here): all L gated residual layers
of the diffusion denoiser on ``[B, T, C]``, returning ``skip / sqrt(L)``. The
kernel is ``csrc/wavenet_stack.cu``; :func:`residual_stack_plain` computes
the same function with ``torch.matmul``. :func:`residual_stack` takes the
plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.ops import cuda_build

RSQRT2 = 2.0 ** -0.5


class StackedWaveNet(NamedTuple):
    """Per-layer weights stacked on axis 0, ``[in, out]`` layout (the JAX
    package's ``StackedWaveNet``). C = residual channels, H = cond channels."""

    dilated_w: torch.Tensor  # [L, 3, C, 2C]
    dilated_b: torch.Tensor  # [L, 2C]
    diff_w: torch.Tensor  # [L, C, C]
    diff_b: torch.Tensor  # [L, C]
    cond_w: torch.Tensor  # [L, H, 2C]
    cond_b: torch.Tensor  # [L, 2C]
    out_w: torch.Tensor  # [L, C, 2C]
    out_b: torch.Tensor  # [L, 2C]


def residual_stack_plain(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                         w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C].

    Frames outside ``[0, T)`` are the k=3 conv's zero padding."""
    n_layers, _, c, _ = w.dilated_w.shape
    x = x0
    skip = torch.zeros_like(x0)
    for i in range(n_layers):
        step_proj = step @ w.diff_w[i] + w.diff_b[i]  # [B, C]
        y = x + step_proj[:, None, :]
        y_prev = F.pad(y, (0, 0, 1, 0))[:, :-1]
        y_next = F.pad(y, (0, 0, 0, 1))[:, 1:]
        z = y @ w.dilated_w[i, 1] + y_prev @ w.dilated_w[i, 0] + y_next @ w.dilated_w[i, 2]
        z = z + w.dilated_b[i] + (cond @ w.cond_w[i] + w.cond_b[i])
        gate = torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])
        o = gate @ w.out_w[i] + w.out_b[i]
        x = (x + o[..., :c]) * RSQRT2
        skip = skip + o[..., c:]
    return skip * (1.0 / math.sqrt(n_layers))


_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("wavenet_stack")
    lib.wavenet_residual_stack.argtypes = _ARGTYPES
    lib.wavenet_residual_stack.restype = ctypes.c_int
    return lib


def residual_stack(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                   w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C].

    CPU tensors run :func:`residual_stack_plain`; CUDA tensors launch the
    kernel (1 + 2L launches, counted in ``residual_stack.launches``)."""
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, cond, step, w)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack: unsupported device {x0.device}")
    b, t, c = x0.shape
    n_layers, h, c2 = w.cond_w.shape
    dtype = device.compute_dtype()
    for a in (x0, cond, step, *w):
        if a.device != x0.device or a.dtype != dtype:
            raise ValueError(
                f"residual_stack: every operand must be {dtype} on {x0.device}, "
                f"got {a.dtype} on {a.device}"
            )
    expect = {
        "cond": (cond.shape, (b, t, h)), "step": (step.shape, (b, c)),
        "dilated_w": (w.dilated_w.shape, (n_layers, 3, c, c2)),
        "dilated_b": (w.dilated_b.shape, (n_layers, c2)),
        "diff_w": (w.diff_w.shape, (n_layers, c, c)),
        "diff_b": (w.diff_b.shape, (n_layers, c)),
        "cond_b": (w.cond_b.shape, (n_layers, c2)),
        "out_w": (w.out_w.shape, (n_layers, c, c2)),
        "out_b": (w.out_b.shape, (n_layers, c2)),
    }
    for name, (got, want) in expect.items():
        if tuple(got) != want:
            raise ValueError(f"residual_stack: {name} has shape {tuple(got)}, expected {want}")
    if c2 != 2 * c or c % 32 or h % 32:
        raise ValueError(f"residual_stack: needs C % 32 == 0, H % 32 == 0 (C={c}, H={h})")
    cond, step = cond.contiguous(), step.contiguous()
    w = StackedWaveNet(*(a.contiguous() for a in w))
    x = x0.contiguous().clone()
    skip = torch.empty_like(x)
    gate = torch.empty_like(x)
    step_proj = torch.empty((n_layers, b, c), device=x.device, dtype=dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wavenet_residual_stack(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, stream,
        )
    cuda_build.check(err, "wavenet_residual_stack")
    residual_stack.launches.add(1 + 2 * n_layers)
    return skip


residual_stack.launches = cuda_build.LaunchCounter()
