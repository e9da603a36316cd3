"""FastDiff's location-variable convolution (LVC): CUDA kernel wrapper and its
plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/lvc.py`` (``lvc_pallas``) and of
``prodiff_tpu/models/fastdiff.py:location_variable_convolution``: per hop
window ``l``, ``y[t] = bias[l] + taps(x)[t] @ kmat[l]`` with the k=3 taps
tap-major (row ``d*Cin + ci``, d = 0 for time t-1), zero at the sequence ends
and read across window edges. The kernel is ``csrc/lvc.cu``;
:func:`lvc_plain` computes the same function with ``torch.matmul``.
:func:`lvc` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.

Window kernels come either per layer (``kmat [B, L, 3Cin, Cout]``, ``bias
[B, L, Cout]``, ``step_idx=None``) or as the hoisted KernelPredictor stack
(``kmat [N, B, L, layers*3Cin, Cout]``, ``bias [N, B, L, layers*Cout]``),
read in place at ``(step_idx, layer_idx)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.ops import cuda_build

KERNEL_C = 32  # the kernels' fixed input width (FastDiff's inner channels)


def window_kernels(kmat: torch.Tensor, bias: torch.Tensor, cin: int,
                   step_idx: Optional[int] = None, layer_idx: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-layer ``[B, L, 3Cin, Cout]`` / ``[B, L, Cout]`` views of either
    form (no copy)."""
    if step_idx is None:
        return kmat, bias
    kc, cout = 3 * cin, kmat.shape[-1]
    return (kmat[step_idx, :, :, layer_idx * kc:(layer_idx + 1) * kc],
            bias[step_idx, :, :, layer_idx * cout:(layer_idx + 1) * cout])


def lvc_plain(x: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor, hop: int,
              step_idx: Optional[int] = None, layer_idx: int = 0) -> torch.Tensor:
    """x [B, T, Cin] -> [B, T, Cout], T = L * hop."""
    b, t, cin = x.shape
    km, lb = window_kernels(kmat, bias, cin, step_idx, layer_idx)
    n_win, kc, cout = km.shape[1:]
    if t != n_win * hop or kc != 3 * cin:
        raise ValueError(f"lvc: x {tuple(x.shape)} does not match kernels {tuple(km.shape)} at hop {hop}")
    xp = F.pad(x, (0, 0, 1, 1))
    taps = torch.cat([xp[:, i: i + t] for i in range(3)], dim=2)  # [B, T, 3Cin]
    y = torch.matmul(taps.view(b, n_win, hop, kc), km) + lb[:, :, None, :]
    return y.reshape(b, t, cout)


def check_kernel_operands(name: str, x: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor,
                          hop: int, step_idx: Optional[int], layer_idx: int, *extra: torch.Tensor):
    """Validate the operands of a window-kernel launch; returns the stack's
    ``(n_win, layers, step, layer)`` and the contiguous operands."""
    b, t, c = x.shape
    dtype = device.compute_dtype()
    for a in (x, kmat, bias, *extra):
        if a.device != x.device or a.dtype != dtype:
            raise ValueError(f"{name}: every operand must be {dtype} on {x.device}, "
                             f"got {a.dtype} on {a.device}")
    if c != KERNEL_C:
        raise ValueError(f"{name}: the kernel takes C = {KERNEL_C} channels, got {c}")
    if not (hop in (8, 16) or (hop > 0 and hop % 32 == 0)) or t % hop:
        raise ValueError(f"{name}: hop must be 8, 16 or a multiple of 32 dividing T={t}, got {hop}")
    if kmat.ndim != (4 if step_idx is None else 5):
        raise ValueError(f"{name}: kmat {tuple(kmat.shape)}: 4-D per layer, 5-D with step_idx")
    if step_idx is None:
        km_want = (b, t // hop, 3 * c, 2 * c)
        if tuple(kmat.shape) != km_want or tuple(bias.shape) != (b, t // hop, 2 * c):
            raise ValueError(f"{name}: kmat {tuple(kmat.shape)} / bias {tuple(bias.shape)}, "
                             f"expected {km_want} / {km_want[:2] + (2 * c,)}")
        n_steps, layers, step, layer = 1, 1, 0, 0
    else:
        n_steps, _, n_win, rows, cout = kmat.shape
        layers = rows // (3 * c)
        if (kmat.shape[1] != b or n_win * hop != t or rows != layers * 3 * c or cout != 2 * c
                or tuple(bias.shape) != (n_steps, b, n_win, layers * 2 * c)):
            raise ValueError(f"{name}: stack {tuple(kmat.shape)} / bias {tuple(bias.shape)} "
                             f"does not match x {tuple(x.shape)} at hop {hop}")
        step, layer = int(step_idx), int(layer_idx)
        if not (0 <= step < n_steps and 0 <= layer < layers):
            raise ValueError(f"{name}: (step {step}, layer {layer}) outside {n_steps} x {layers}")
    ops = [a.contiguous() for a in (x, kmat, bias, *extra)]
    if any(a.data_ptr() % 16 for a in ops):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    return (t // hop, layers, step, layer), ops


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("lvc")
    lib.lvc_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.lvc_forward.restype = ctypes.c_int
    return lib


def lvc(x: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor, hop: int,
        step_idx: Optional[int] = None, layer_idx: int = 0) -> torch.Tensor:
    """x [B, T, Cin] -> [B, T, Cout].

    CPU tensors run :func:`lvc_plain`; CUDA tensors launch the kernel (one
    launch, counted in ``lvc.launches``), which needs Cin = 32, Cout = 64."""
    if x.device.type == "cpu":
        return lvc_plain(x, kmat, bias, hop, step_idx, layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"lvc: unsupported device {x.device}")
    (n_win, layers, step, layer), (x, kmat, bias) = check_kernel_operands(
        "lvc", x, kmat, bias, hop, step_idx, layer_idx)
    b, t, c = x.shape
    y = torch.empty((b, t, 2 * c), device=x.device, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lvc_forward(x.data_ptr(), kmat.data_ptr(), bias.data_ptr(), y.data_ptr(),
                              b, t, n_win, hop, layers, step, layer, stream)
    cuda_build.check(err, "lvc_forward")
    lvc.launches.add(1)
    return y


lvc.launches = cuda_build.LaunchCounter()
