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


def wavenet_layer_plain(x: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                        w: StackedWaveNet, i: int):
    """Layer ``i`` of the stack: x [B,T,C] -> (next x, skip part of o, the
    pre-gate z [B,T,2C]). Frames outside ``[0, T)`` are the k=3 conv's zero
    padding."""
    c = x.shape[-1]
    step_proj = step @ w.diff_w[i] + w.diff_b[i]  # [B, C]
    y = x + step_proj[:, None, :]
    y_prev = F.pad(y, (0, 0, 1, 0))[:, :-1]
    y_next = F.pad(y, (0, 0, 0, 1))[:, 1:]
    z = y @ w.dilated_w[i, 1] + y_prev @ w.dilated_w[i, 0] + y_next @ w.dilated_w[i, 2]
    z = z + w.dilated_b[i] + (cond @ w.cond_w[i] + w.cond_b[i])
    gate = torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])
    o = gate @ w.out_w[i] + w.out_b[i]
    return (x + o[..., :c]) * RSQRT2, o[..., c:], z


def residual_stack_plain(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                         w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C]."""
    n_layers = w.dilated_w.shape[0]
    x = x0
    skip = torch.zeros_like(x0)
    for i in range(n_layers):
        x, s, _ = wavenet_layer_plain(x, cond, step, w, i)
        skip = skip + s
    return skip * (1.0 / math.sqrt(n_layers))


def check_operands(what: str, x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                   w: StackedWaveNet):
    """The kernels' contract on CUDA operands; returns (B, T, C, H, L)."""
    if x0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x0.device}")
    b, t, c = x0.shape
    n_layers, h, c2 = w.cond_w.shape
    dtype = device.compute_dtype()
    for a in (x0, cond, step, *w):
        if a.device != x0.device or a.dtype != dtype:
            raise ValueError(
                f"{what}: every operand must be {dtype} on {x0.device}, "
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
            raise ValueError(f"{what}: {name} has shape {tuple(got)}, expected {want}")
    if c2 != 2 * c or c % 32 or h % 32:
        raise ValueError(f"{what}: needs C % 32 == 0, H % 32 == 0 (C={c}, H={h})")
    return b, t, c, h, n_layers


# the conditioner terms zc [group, B, T, 2C] of one launch stay under this
# many bytes; a larger stack runs its layers in groups (csrc/wavenet_stack.cu)
ZC_BUDGET = 1 << 30
# the chain kernel's tile rows, each with the relative time a frame row takes
# in such a tile: its FM x 8 fragments (FM = rows / 4) read 32 bytes of
# weights from shared memory per 8 * FM FMAs, so the smaller tiles run
# nearer the shared-memory limit (a ranking, not a measurement)
CHAIN_ROWS = {32: 1.0, 24: 1.1, 16: 1.2}
CHAIN_PAIRS = 32  # column pairs (j, C+j) a chain tile


def layer_group(b: int, t: int, c: int, n_layers: int) -> int:
    """Layers a cond + chain launch pair covers: as many as keep zc under
    ``ZC_BUDGET`` bytes (at least one)."""
    budget, per_layer = ZC_BUDGET, 4 * b * t * 2 * c
    return max(1, min(n_layers, budget // per_layer))


def stack_launches(b: int, t: int, c: int, n_layers: int) -> int:
    """Kernel launches of one stack: the step projection, then a cond GEMM
    and a chain launch per layer group."""
    return 1 + 2 * -(-n_layers // layer_group(b, t, c, n_layers))


def chain_rows(b: int, t: int, c: int, slots: dict) -> int:
    """The chain's tile rows: the choice of ``CHAIN_ROWS`` whose tiles take
    the least time, counted as rounds of the grid times the rows of a tile
    times their relative cost; ``slots[rows]`` is how many blocks of that
    kernel can be co-resident."""
    def cost(rows):
        tiles = b * -(-t // rows) * (c // CHAIN_PAIRS)
        return -(-tiles // max(1, slots[rows])) * rows * CHAIN_ROWS[rows]

    return min(CHAIN_ROWS, key=cost)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_slots: dict = {}


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("wavenet_stack")
    lib.wavenet_residual_stack.argtypes = _ARGTYPES
    lib.wavenet_residual_stack.restype = ctypes.c_int
    lib.wavenet_chain_slots.argtypes = [ctypes.c_int]
    lib.wavenet_chain_slots.restype = ctypes.c_int
    return lib


def _chain_slots(lib, dev: torch.device) -> dict:
    """Co-resident chain blocks on ``dev`` for each tile-row choice (once a
    device)."""
    key = dev.index
    if key not in _slots:
        got = {rows: lib.wavenet_chain_slots(rows) for rows in CHAIN_ROWS}
        if min(got.values()) < 1:
            raise RuntimeError(f"wavenet_chain_slots: occupancy query failed ({got})")
        _slots[key] = got
    return _slots[key]


def residual_stack(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                   w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C].

    CPU tensors run :func:`residual_stack_plain`; CUDA tensors launch the
    kernels (:func:`stack_launches`: 3 while zc fits ``ZC_BUDGET``, counted
    in ``residual_stack.launches``). The kernel has no backward: with grad
    mode on, an operand that requires grad raises. A stack that trains goes
    through ``ops/wavenet_train.py:differentiable_stack``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x0, cond, step, *w)):
        raise RuntimeError(
            "residual_stack has no backward and an operand requires grad: call it under "
            "torch.no_grad(), or train through ops/wavenet_train.py:differentiable_stack"
        )
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, cond, step, w)
    b, t, c, h, n_layers = check_operands("residual_stack", x0, cond, step, w)
    cond, step = cond.contiguous(), step.contiguous()
    w = StackedWaveNet(*(a.contiguous() for a in w))
    x = x0.contiguous().clone()
    skip = torch.empty_like(x)
    gate = torch.empty_like(x)
    step_proj = torch.empty((n_layers, b, c), device=x.device, dtype=x.dtype)
    group = layer_group(b, t, c, n_layers)
    zc = torch.empty((group, b, t, 2 * c), device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        rows = chain_rows(b, t, c, _chain_slots(lib, x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wavenet_residual_stack(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            zc.data_ptr(), cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, group, rows, stream,
        )
    cuda_build.check(err, "wavenet_residual_stack")
    residual_stack.launches.add(stack_launches(b, t, c, n_layers))
    return skip


residual_stack.launches = cuda_build.LaunchCounter()
