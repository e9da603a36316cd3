"""The WaveNet residual stack: CUDA kernel wrapper and its plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/wavenet.py`` (``fused_residual_stack`` and
``fused_residual_stack_tiled``, one entry here): all L gated residual layers
of the diffusion denoiser on ``[B, T, C]``, returning ``skip / sqrt(L)``. The
kernel is ``csrc/wavenet_stack.cu``; :func:`residual_stack_plain` computes
the same function with ``torch.matmul``. :func:`residual_stack` takes the
plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises.

The dtype of the stacked weight matrices selects the variant, as ``cdt =
dw.dtype`` does in the Pallas layer (``prodiff_tpu/ops/pallas/wavenet.py:
_wavenet_layer_step``): float32 weights run the float32 kernel, bfloat16
weights (``stack_wavenet_params(stream_dtype=bfloat16)``) the bf16 one,
``csrc/wavenet_stack_bf16.cu``, whose products take bf16 operands on the
tensor cores with float32 accumulation while ``x``, the skip sum and the
step projection stay float32. The plain twin emulates that exactly: each
operand of a product is rounded to bf16 and back, and the product runs in
float32. Biases stay float32 in both.
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
BF16 = torch.bfloat16


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


MATRICES = ("dilated_w", "diff_w", "cond_w", "out_w")


def cast_stack(w: StackedWaveNet, dtype: torch.dtype) -> StackedWaveNet:
    """The stack with its four weight matrices in ``dtype`` and its biases
    as they are (``stack_wavenet_params(stream_dtype=dtype)``); ``w`` itself
    where nothing changes."""
    if all(getattr(w, n).dtype == dtype for n in MATRICES):
        return w
    return w._replace(**{n: getattr(w, n).to(dtype) for n in MATRICES})


def operand_dtype(w: StackedWaveNet) -> torch.dtype:
    """The products' operand dtype: that of the stacked weight matrices."""
    return w.dilated_w.dtype


def rounder(dtype: torch.dtype):
    """``a -> a`` rounded to ``dtype`` and widened back to float32 (the
    operand of a bf16 x bf16 -> f32 product), or the identity for float32
    and float64 stacks."""
    if dtype != BF16:
        return lambda a: a
    return lambda a: a.to(BF16).float()


def wavenet_layer_plain(x: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                        w: StackedWaveNet, i: int):
    """Layer ``i`` of the stack: x [B,T,C] -> (next x, skip part of o, the
    pre-gate z [B,T,2C]). Frames outside ``[0, T)`` are the k=3 conv's zero
    padding. With bf16 weights every product's operands are bf16 (``y``,
    ``cond``, the gate and the step rounded to it), accumulated in float32."""
    c = x.shape[-1]
    r = rounder(operand_dtype(w))
    dw, diff_w, cond_w, out_w = (getattr(w, n)[i].to(x.dtype) for n in MATRICES)
    step_proj = r(step) @ diff_w + w.diff_b[i]  # [B, C]
    y = r(x + step_proj[:, None, :])
    y_prev = F.pad(y, (0, 0, 1, 0))[:, :-1]
    y_next = F.pad(y, (0, 0, 0, 1))[:, 1:]
    z = y @ dw[1] + y_prev @ dw[0] + y_next @ dw[2]
    z = z + w.dilated_b[i] + (r(cond) @ cond_w + w.cond_b[i])
    gate = torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])
    o = r(gate) @ out_w + w.out_b[i]
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
    """The kernels' contract on CUDA operands; returns (B, T, C, H, L). The
    four weight matrices are float32 or all bf16; everything else float32."""
    if x0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x0.device}")
    b, t, c = x0.shape
    n_layers, h, c2 = w.cond_w.shape
    dtype = device.compute_dtype()
    wdt = operand_dtype(w)
    if wdt not in (dtype, BF16):
        raise ValueError(f"{what}: weight matrices must be {dtype} or {BF16}, got {wdt}")
    for name, a in zip(("x0", "cond", "step") + StackedWaveNet._fields, (x0, cond, step, *w)):
        want = wdt if name in MATRICES else dtype
        if a.device != x0.device or a.dtype != want:
            raise ValueError(
                f"{what}: {name} must be {want} on {x0.device}, got {a.dtype} on {a.device}"
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
# the bf16 chain's tile rows: whole m16n8k16 row tiles, so 24 is out; a
# warp's B fragments serve 2 row tiles at 32 rows, 1 at 16 (a ranking)
CHAIN_ROWS_BF16 = {32: 1.0, 16: 1.2}
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


def chain_rows(b: int, t: int, c: int, slots: dict, table: dict = CHAIN_ROWS) -> int:
    """The chain's tile rows: the choice of ``table`` (``CHAIN_ROWS``, or
    ``CHAIN_ROWS_BF16`` for the bf16 chain) whose tiles take the least time,
    counted as rounds of the grid times the rows of a tile times their
    relative cost; ``slots[rows]`` is how many blocks of that kernel can be
    co-resident."""
    def cost(rows):
        tiles = b * -(-t // rows) * (c // CHAIN_PAIRS)
        return -(-tiles // max(1, slots[rows])) * rows * table[rows]

    return min(table, key=cost)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_slots: dict = {}
# (source, entry point, slots query, tile-row table) by the weights' dtype
_VARIANTS = {
    torch.float32: ("wavenet_stack", "wavenet_residual_stack", "wavenet_chain_slots", CHAIN_ROWS),
    BF16: ("wavenet_stack_bf16", "wavenet_residual_stack_bf16", "wavenet_chain_slots_bf16",
           CHAIN_ROWS_BF16),
}


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    source, entry, slots, _ = _VARIANTS[dtype]
    lib = cuda_build.load(source)
    getattr(lib, entry).argtypes = _ARGTYPES
    getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, slots).argtypes = [ctypes.c_int]
    getattr(lib, slots).restype = ctypes.c_int
    return lib


def _chain_slots(lib, dev: torch.device, dtype: torch.dtype = torch.float32) -> dict:
    """Co-resident chain blocks on ``dev`` for each tile-row choice (once a
    device and variant)."""
    _, _, query, table = _VARIANTS[dtype]
    key = (dev.index, dtype)
    if key not in _slots:
        got = {rows: getattr(lib, query)(rows) for rows in table}
        if min(got.values()) < 1:
            raise RuntimeError(f"{query}: occupancy query failed ({got})")
        _slots[key] = got
    return _slots[key]


def residual_stack(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                   w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C].

    CPU tensors run :func:`residual_stack_plain`; CUDA tensors launch the
    kernels (:func:`stack_launches`: 3 while zc fits ``ZC_BUDGET``), the
    float32 ones for float32 weights (counted in ``residual_stack.launches``)
    and the bf16 ones for bf16 weights (``residual_stack.bf16_launches``).
    The kernel has no backward: with grad mode on, an operand that requires
    grad raises. A stack that trains goes through
    ``ops/wavenet_train.py:differentiable_stack``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x0, cond, step, *w)):
        raise RuntimeError(
            "residual_stack has no backward and an operand requires grad: call it under "
            "torch.no_grad(), or train through ops/wavenet_train.py:differentiable_stack"
        )
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, cond, step, w)
    b, t, c, h, n_layers = check_operands("residual_stack", x0, cond, step, w)
    wdt = operand_dtype(w)
    cond, step = cond.contiguous(), step.contiguous()
    w = StackedWaveNet(*(a.contiguous() for a in w))
    x = x0.contiguous().clone()
    skip = torch.empty_like(x)
    gate = torch.empty_like(x, dtype=wdt)  # the out product's operand
    step_proj = torch.empty((n_layers, b, c), device=x.device, dtype=x.dtype)
    group = layer_group(b, t, c, n_layers)
    zc = torch.empty((group, b, t, 2 * c), device=x.device, dtype=x.dtype)
    lib = _library(wdt)
    _, entry, _, table = _VARIANTS[wdt]
    with torch.cuda.device(x.device):
        rows = chain_rows(b, t, c, _chain_slots(lib, x.device, wdt), table)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            zc.data_ptr(), cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, group, rows, stream,
        )
    cuda_build.check(err, entry)
    counter = residual_stack.bf16_launches if wdt == BF16 else residual_stack.launches
    counter.add(stack_launches(b, t, c, n_layers))
    return skip


residual_stack.launches = cuda_build.LaunchCounter()
residual_stack.bf16_launches = cuda_build.LaunchCounter()
