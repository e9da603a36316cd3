"""One HiFiGAN ResBlock1 stage: CUDA kernel wrapper and its plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/resblock.py`` (``resblock_group_packed`` and
``resblock_group_streamed``, one entry here): ``mean_j ResBlock1_j(x)`` over
a stage's ResBlock1s on ``[B, T, C]``. The kernel is ``csrc/resblock.cu``;
:func:`resblock_stage_plain` computes the same function with ``F.conv1d``.
:func:`resblock_stage` takes the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.

A stage's weights travel as one flat tensor: the convs in (resblock, unit,
conv1/conv2) order, each ``[k, C_in, C_out]``, plus biases ``[n_convs, C]``.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.ops import cuda_build

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _conv_layout(ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]
                 ) -> Iterator[Tuple[int, int]]:
    """(kernel size, dilation) of every conv, in weight order."""
    for k, ds in zip(ksizes, dsizes):
        for d in ds:
            yield k, d
            yield k, 1


def resblock_stage_plain(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
                         ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """x [B,T,C] -> mean_j ResBlock1_j(x) [B,T,C]."""
    c = x.shape[-1]
    convs = []
    off = 0
    for ci, (k, d) in enumerate(_conv_layout(ksizes, dsizes)):
        kern = weights[off: off + k * c * c].view(k, c, c).permute(2, 1, 0)  # [out, in, k]
        convs.append((kern, biases[ci], d, get_padding(k, d)))
        off += k * c * c

    def conv(h, i):
        kern, bias, d, pad = convs[i]
        return F.conv1d(h, kern, bias, padding=pad, dilation=d)

    xc = x.transpose(1, 2)  # [B, C, T]
    total = None
    ci = 0
    for ds in dsizes:
        h = xc
        for _ in ds:
            xt = conv(F.leaky_relu(h, LRELU_SLOPE), ci)
            xt = conv(F.leaky_relu(xt, LRELU_SLOPE), ci + 1)
            h = xt + h
            ci += 2
        total = h if total is None else total + h
    return (total / len(dsizes)).transpose(1, 2)


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("resblock")
    lib.resblock_stage.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.resblock_stage.restype = ctypes.c_int
    return lib


def _int_array(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def resblock_stage(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
                   ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """x [B,T,C] -> mean_j ResBlock1_j(x) [B,T,C].

    CPU tensors run :func:`resblock_stage_plain`; CUDA tensors launch the
    kernel (one launch per conv, counted in ``resblock_stage.launches``)."""
    if x.device.type == "cpu":
        return resblock_stage_plain(x, weights, biases, ksizes, dsizes)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_stage: unsupported device {x.device}")
    b, t, c = x.shape
    dtype = device.compute_dtype()
    for a in (x, weights, biases):
        if a.device != x.device or a.dtype != dtype:
            raise ValueError(
                f"resblock_stage: every operand must be {dtype} on {x.device}, "
                f"got {a.dtype} on {a.device}"
            )
    if not (c in (16, 32) or c % 64 == 0):
        raise ValueError(f"resblock_stage: C must be 16, 32 or a multiple of 64, got {c}")
    if len(ksizes) != len(dsizes) or any(k % 2 == 0 for k in ksizes):
        raise ValueError(f"resblock_stage: odd kernel sizes, one per resblock: {ksizes}")
    layout = list(_conv_layout(ksizes, dsizes))
    n_w = sum(k * c * c for k, _ in layout)
    if weights.numel() != n_w or tuple(biases.shape) != (len(layout), c):
        raise ValueError(
            f"resblock_stage: weights {tuple(weights.shape)} / biases "
            f"{tuple(biases.shape)} do not match {len(layout)} convs at C={c}"
        )
    x = x.contiguous()
    weights, biases = weights.contiguous(), biases.contiguous()
    out = torch.empty_like(x)
    h = torch.empty_like(x)
    tmp = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.resblock_stage(
            x.data_ptr(), out.data_ptr(), h.data_ptr(), tmp.data_ptr(),
            weights.data_ptr(), biases.data_ptr(),
            _int_array(list(ksizes)), _int_array([len(ds) for ds in dsizes]),
            _int_array([d for ds in dsizes for d in ds]),
            len(ksizes), b, t, c, stream,
        )
    cuda_build.check(err, "resblock_stage")
    resblock_stage.launches.add(len(layout))
    return out


resblock_stage.launches = cuda_build.LaunchCounter()
