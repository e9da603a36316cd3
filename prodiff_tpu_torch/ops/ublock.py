"""One FastDiff LVC layer, fused: CUDA kernel wrapper and its plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/ublock.py:ublock_layer_packed`` (the body
``_fused_layer_compute``), on the unpacked ``[B, T, C]`` layout: the packed
``[B, T/4, 128]`` trunk and its block-diagonal kernels are a TPU lane layout
and are not ported. The layer (``TimeAwareLVCBlock``'s loop body):

    xa  = x + audio_down
    y   = leaky_0.2(conv_d(leaky_0.2(xa)))      k=3, dilation d, SAME zero pad
    y   = LVC(y, window kernels, hop)           (ops/lvc.py)
    out = xa + sigmoid(y[..., :C]) * tanh(y[..., C:])

The kernel is ``csrc/ublock.cu``; :func:`ublock_layer_plain` computes the same
function with ``F.conv1d`` and :func:`~prodiff_tpu_torch.ops.lvc.lvc_plain`.
:func:`ublock_layer` takes the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises. The conv weight is in torch's
``Conv1d`` layout ``[C, C, 3]``; the window kernels come per layer or as the
hoisted stack read at ``(step_idx, layer_idx)``, as for ``ops/lvc.py``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from prodiff_tpu_torch.ops import cuda_build
from prodiff_tpu_torch.ops.lvc import check_kernel_operands, lvc_plain

LRELU_SLOPE = 0.2


def gated_residual(xa: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``xa + sigmoid(gate) * tanh(filter)`` with y = [gate | filter]."""
    c = xa.shape[-1]
    return xa + torch.sigmoid(y[..., :c]) * torch.tanh(y[..., c:])


def dilated_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """The layer's SAME k=3 conv on ``[B, T, C]`` (cuDNN on the card)."""
    y = F.conv1d(x.transpose(1, 2), conv_w, conv_b, padding=dilation, dilation=dilation)
    return y.transpose(1, 2)


def ublock_layer_plain(x: torch.Tensor, audio_down: torch.Tensor, conv_w: torch.Tensor,
                       conv_b: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor,
                       dilation: int, hop: int, step_idx: Optional[int] = None,
                       layer_idx: int = 0) -> torch.Tensor:
    """x, audio_down [B, T, C] -> the next layer's x [B, T, C]."""
    xa = x + audio_down
    y = F.leaky_relu(dilated_conv(F.leaky_relu(xa, LRELU_SLOPE), conv_w, conv_b, dilation),
                     LRELU_SLOPE)
    return gated_residual(xa, lvc_plain(y, kmat, bias, hop, step_idx, layer_idx))


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("ublock")
    lib.ublock_layer_forward.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.ublock_layer_forward.restype = ctypes.c_int
    return lib


def ublock_layer(x: torch.Tensor, audio_down: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor,
                 dilation: int, hop: int, step_idx: Optional[int] = None,
                 layer_idx: int = 0) -> torch.Tensor:
    """x, audio_down [B, T, C] -> the next layer's x [B, T, C].

    CPU tensors run :func:`ublock_layer_plain`; CUDA tensors launch the kernel
    (one launch, counted in ``ublock_layer.launches``), which needs C = 32."""
    if x.device.type == "cpu":
        return ublock_layer_plain(x, audio_down, conv_w, conv_b, kmat, bias, dilation, hop,
                                  step_idx, layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"ublock_layer: unsupported device {x.device}")
    (n_win, layers, step, layer), (x, kmat, bias, audio_down, conv_w, conv_b) = \
        check_kernel_operands("ublock_layer", x, kmat, bias, hop, step_idx, layer_idx,
                              audio_down, conv_w, conv_b)
    b, t, c = x.shape
    if audio_down.shape != x.shape or conv_w.shape != (c, c, 3) or conv_b.shape != (c,):
        raise ValueError(f"ublock_layer: audio_down {tuple(audio_down.shape)}, conv "
                         f"{tuple(conv_w.shape)} / {tuple(conv_b.shape)} for x {tuple(x.shape)}")
    if dilation < 1:
        raise ValueError(f"ublock_layer: dilation must be >= 1, got {dilation}")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ublock_layer_forward(
            x.data_ptr(), audio_down.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            kmat.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, t, n_win, hop, dilation, layers, step, layer, stream,
        )
    cuda_build.check(err, "ublock_layer_forward")
    ublock_layer.launches.add(1)
    return out


ublock_layer.launches = cuda_build.LaunchCounter()
