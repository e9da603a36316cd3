"""FastDiff's LVC layers, fused: CUDA kernel wrappers and their plain PyTorch twins.

:func:`ublock_layer` (K4) is the port of
``prodiff_tpu/ops/pallas/ublock.py:ublock_layer_packed`` (the body
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

:func:`ublock_block` (K7) is the port of ``ublock_block_packed``: all layers
of one ``TimeAwareLVCBlock`` (layer i with conv dilation ``dilations[i]``)
in one cooperative launch of ``csrc/ublock_block.cu`` (a grid barrier
between layers, the activations ping-ponging through one scratch tensor),
reading layer i's windows from the hoisted stack at ``(step_idx, i)``.
:func:`ublock_block_plain` is the chain of :func:`ublock_layer_plain`;
:func:`mono_block_supported` is the static gate of the blocks the kernel
takes. Both kernels run ``csrc/lvc_tiles.cuh``'s work units, whose plan
:func:`layer_plan` mirrors.

Each kernel has a float32-window build and a bf16-window build (K4-bf16,
K7-bf16: the same source, the window element a template argument), which
the window kernels' dtype picks: bf16 windows are the KernelPredictor's
output in ``fast`` mode. Both compute ``ublock_layer_packed``'s /
``ublock_block_packed``'s function, each bf16 window value widened exactly
and the product in float32; the plain twins compute on ``kmat.float()``.
The bf16 build runs the window product on the tensor cores, the bf16
window as it is against y split into ``TERMS`` bf16 terms (each the
rounded remainder of the ones before), each product accumulated in float32.
Every other operand is float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from prodiff_tpu_torch.ops import cuda_build
# HOP_RULE: K4's hop contract, every multiple of 8 as K6 and from hop 64 on
# every multiple of 4 (csrc/lvc_tiles.cuh:layer_hop_supported; an 8-row tile
# of its units lies in one window, or in two at a hop of 4 mod 8). K7 checks
# its operands by it too, behind its own gate (mono_block_supported).
from prodiff_tpu_torch.ops.lvc import LAYER_HOP_RULE as HOP_RULE
from prodiff_tpu_torch.ops.lvc import KERNEL_C, MAX_SMEM, check_kernel_operands, lvc_plain

LRELU_SLOPE = 0.2
WINDOW_DTYPES = (torch.float32, torch.bfloat16)  # K4's and K7's builds
# bf16 terms of y in the bf16 build's tensor-core product (csrc/lvc_tiles.cuh:
# TERMS, split_pair): three keep float32's 24 significant bits; two leave
# 2^-17 of |y| (tests/test_torch_ublock_bf16_split.py)
TERMS = 3


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


def _library(window_dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    return bind_layer_library(cuda_build.load("ublock"), window_dtype)


def bind_layer_library(lib: ctypes.CDLL, window_dtype: torch.dtype = torch.float32
                       ) -> ctypes.CDLL:
    """Declare the C entry points of K4's build for ``window_dtype`` windows
    (those of the bf16 build have the suffix ``_bf16``) on ``lib``
    (``csrc/ublock.cu``, or a variant of it built with defines, which only
    measurement code loads)."""
    sfx = _suffix(window_dtype)
    fwd = getattr(lib, f"ublock_layer_forward{sfx}")
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    getattr(lib, f"ublock_layer_smem{sfx}").argtypes = [ctypes.c_int] * 2
    getattr(lib, f"ublock_layer_grid{sfx}").argtypes = [ctypes.c_int] * 4
    return lib


def _suffix(window_dtype: torch.dtype) -> str:
    """The C entries' suffix of the build for ``window_dtype`` windows."""
    return "_bf16" if window_dtype == torch.bfloat16 else ""


def ublock_layer(x: torch.Tensor, audio_down: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor,
                 dilation: int, hop: int, step_idx: Optional[int] = None,
                 layer_idx: int = 0) -> torch.Tensor:
    """x, audio_down [B, T, C] -> the next layer's x [B, T, C].

    CPU tensors run :func:`ublock_layer_plain`; CUDA tensors launch the
    kernel's build for the window kernels' dtype (one launch, counted in
    ``ublock_layer.launches``, bf16 windows in ``ublock_layer.bf16_launches``),
    which needs C = 32."""
    if kmat.dtype not in WINDOW_DTYPES:
        raise ValueError(f"ublock_layer: the window kernels must be one of "
                         f"{list(WINDOW_DTYPES)}, got {kmat.dtype}")
    if x.device.type == "cpu":
        return ublock_layer_plain(x, audio_down, conv_w, conv_b, kmat, bias, dilation, hop,
                                  step_idx, layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"ublock_layer: unsupported device {x.device}")
    (n_win, layers, step, layer), (x, kmat, bias, audio_down, conv_w, conv_b) = \
        check_kernel_operands("ublock_layer", HOP_RULE, x, kmat, bias, hop, step_idx, layer_idx,
                              audio_down, conv_w, conv_b, window_dtypes=WINDOW_DTYPES)
    b, t, c = x.shape
    if audio_down.shape != x.shape or conv_w.shape != (c, c, 3) or conv_b.shape != (c,):
        raise ValueError(f"ublock_layer: audio_down {tuple(audio_down.shape)}, conv "
                         f"{tuple(conv_w.shape)} / {tuple(conv_b.shape)} for x {tuple(x.shape)}")
    if dilation < 1 or layer_plan(hop, dilation, kmat.dtype)["smem"] > MAX_SMEM:
        raise ValueError(f"ublock_layer: dilation {dilation} at hop {hop} is outside the kernel "
                         f"(>= 1, its halo within {MAX_SMEM} bytes of shared memory)")
    out = torch.empty_like(x)
    entry = f"ublock_layer_forward{_suffix(kmat.dtype)}"
    fwd = getattr(_library(kmat.dtype), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(
            x.data_ptr(), audio_down.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
            kmat.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, t, n_win, hop, dilation, layers, step, layer, stream,
        )
    cuda_build.check(err, entry)
    (ublock_layer.bf16_launches if kmat.dtype == torch.bfloat16 else ublock_layer.launches).add(1)
    return out


ublock_layer.launches = cuda_build.LaunchCounter()
ublock_layer.bf16_launches = cuda_build.LaunchCounter()


# The work-unit plan of csrc/lvc_tiles.cuh, shared by K4 and K7 (the C side
# computes the same numbers: ublock_layer_smem, ublock_block_smem).
MONO_MIN_HOP = 64  # the JAX route's _FUSED_MIN_HOP: K7 runs on the audio-rate blocks only
MONO_MAX_LAYERS = 8
TILED_MIN_HOP = 64  # hop >= 64: 256-row units of 8 x 8 register tiles; below, 32-row streaming units
_WS = 3 * KERNEL_C * KERNEL_C + KERNEL_C  # the staged conv weight and bias, floats


def _window_floats(window_dtype: torch.dtype) -> int:
    """Floats of one staged window: its kernel in ``window_dtype``, then its
    float32 bias (``csrc/lvc_tiles.cuh:kw_floats``)."""
    size = torch.finfo(window_dtype).bits // 8
    return 3 * KERNEL_C * 2 * KERNEL_C * size // 4 + 2 * KERNEL_C


def layer_plan(hop: int, dilation: int, window_dtype: torch.dtype = torch.float32) -> dict:
    """One block's work unit for an LVC layer at (hop, dilation): ``rows`` (R),
    the most ``windows`` a unit touches (units start at multiples of R),
    whether it ``streams`` the window kernels into registers rather than
    staging them in shared memory, the ``product`` and its ``warp_rows``
    (rows a warp's share of it holds), ``terms`` (bf16 terms of y, 0 for the
    float build) and the block's shared-memory bytes (staged window kernels
    in ``window_dtype``, conv weight, x + audio_down with a dilation + 1
    halo, y).

    float32 windows: FP32 FMAs, ``rows_per_thread`` 8; hop < 64 streams (a
    warp 8 rows x 32 outputs, a lane 8 rows x 4 outputs over a quarter of
    the channels), hop >= 64 stages (a thread 8 rows x 8 outputs); y k-major
    ``[C][R + 8]`` floats. bf16 windows: ``mma`` (mma.sync m16n8k16 on the
    tensor cores), every hop staged; a warp 32 rows x 64 outputs (R = 256)
    or 16 rows x 16 outputs (R = 32); y as ``TERMS`` bf16 terms ``[TERMS][C
    / 8][R + 2][8]``."""
    tiled = hop >= TILED_MIN_HOP
    mma = window_dtype == torch.bfloat16
    rows = 256 if tiled else 32
    windows = (hop - math.gcd(rows, hop) + rows - 1) // hop + 1
    staged = tiled or mma
    y_floats = TERMS * (rows + 2) * KERNEL_C // 2 if mma else KERNEL_C * (rows + 8)
    floats = ((windows * _window_floats(window_dtype) if staged else 0) + _WS
              + (rows + 2 * (dilation + 1)) * KERNEL_C + y_floats)
    return {"rows": rows, "windows": windows, "streams": not staged,
            "product": "mma" if mma else "fma", "rows_per_thread": None if mma else 8,
            "warp_rows": (32 if tiled else 16) if mma else (32 if tiled else 8),
            "terms": TERMS if mma else 0, "smem": 4 * floats}



def pingpong(n_layers: int) -> list:
    """K7's buffers: ``(source, destination)`` of each layer among ``"x"``,
    ``"out"`` and ``"scratch"``. Layer i reads what layer i - 1 wrote and
    never writes what it reads; the last writes ``"out"``; the scratch (one
    ``[B, T, C]`` tensor) is needed from two layers on."""
    dst = ["out" if (n_layers - 1 - i) % 2 == 0 else "scratch" for i in range(n_layers)]
    return list(zip(["x"] + dst[:-1], dst))


def mono_block_supported(hop: int, dilations: Sequence[int],
                         window_dtype: torch.dtype = torch.float32) -> bool:
    """Static gate of :func:`ublock_block`: the audio-rate blocks (hop a
    multiple of 32, at least ``MONO_MIN_HOP``, where the layers run the tiled
    plan) of at most ``MONO_MAX_LAYERS`` layers whose largest dilation's halo
    fits in shared memory (in the build for ``window_dtype`` windows). At the
    LJSpeech config that is blocks 1 and 2 (hops 64 and 256), the blocks the
    JAX route runs ``ublock_block_packed`` on; no sequence length is too
    short for the kernel."""
    dilations = list(dilations)
    return (hop >= MONO_MIN_HOP and hop % 32 == 0 and 1 <= len(dilations) <= MONO_MAX_LAYERS
            and min(dilations) >= 1
            and layer_plan(hop, max(dilations), window_dtype)["smem"] <= MAX_SMEM)


def ublock_block_plain(x: torch.Tensor, audio_down: torch.Tensor, conv_ws: Sequence[torch.Tensor],
                       conv_bs: Sequence[torch.Tensor], kmat: torch.Tensor, bias: torch.Tensor,
                       dilations: Sequence[int], hop: int, step_idx: int) -> torch.Tensor:
    """x, audio_down [B, T, C] -> the block's output [B, T, C]: layer i of the
    hoisted stack ``kmat [N, B, L, layers*3C, 2C]`` / ``bias [N, B, L,
    layers*2C]`` at step ``step_idx``, one :func:`ublock_layer_plain` each."""
    for i, (w, b, d) in enumerate(zip(conv_ws, conv_bs, dilations)):
        x = ublock_layer_plain(x, audio_down, w, b, kmat, bias, d, hop, step_idx, i)
    return x


def _block_library(window_dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    return bind_block_library(cuda_build.load("ublock_block"), window_dtype)


def bind_block_library(lib: ctypes.CDLL, window_dtype: torch.dtype = torch.float32
                       ) -> ctypes.CDLL:
    """Declare the C entries of K7's build for ``window_dtype`` windows on
    ``lib`` (``csrc/ublock_block.cu``, or another checkout's build of it,
    which only measurement code loads)."""
    sfx = _suffix(window_dtype)
    fwd = getattr(lib, f"ublock_block_forward{sfx}")
    fwd.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_void_p] * 5
                    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    getattr(lib, f"ublock_block_smem{sfx}").argtypes = [ctypes.c_int] * 2
    getattr(lib, f"ublock_block_slots{sfx}").argtypes = [ctypes.c_int] * 2
    return lib


def ublock_block(x: torch.Tensor, audio_down: torch.Tensor, conv_ws: Sequence[torch.Tensor],
                 conv_bs: Sequence[torch.Tensor], kmat: torch.Tensor, bias: torch.Tensor,
                 dilations: Sequence[int], hop: int, step_idx: int) -> torch.Tensor:
    """x, audio_down [B, T, C] -> the block's output [B, T, C].

    CPU tensors run :func:`ublock_block_plain`; CUDA tensors launch the
    kernel's build for the window kernels' dtype once (counted in
    ``ublock_block.launches``, bf16 windows in ``ublock_block.bf16_launches``),
    which needs C = 32, every layer of the stack and
    :func:`mono_block_supported`."""
    if kmat.dtype not in WINDOW_DTYPES:
        raise ValueError(f"ublock_block: the window kernels must be one of "
                         f"{list(WINDOW_DTYPES)}, got {kmat.dtype}")
    if x.device.type == "cpu":
        return ublock_block_plain(x, audio_down, conv_ws, conv_bs, kmat, bias, dilations, hop,
                                  step_idx)
    if x.device.type != "cuda":
        raise ValueError(f"ublock_block: unsupported device {x.device}")
    dilations = [int(d) for d in dilations]
    n = len(dilations)
    if not (len(conv_ws) == len(conv_bs) == n) or not mono_block_supported(hop, dilations,
                                                                          kmat.dtype):
        raise ValueError(f"ublock_block: {len(conv_ws)} convs, {len(conv_bs)} biases, dilations "
                         f"{dilations} at hop {hop}: outside the kernel's gate")
    cw, cb = torch.stack(list(conv_ws)), torch.stack(list(conv_bs))
    (n_win, layers, step, _), (x, kmat, bias, audio_down, cw, cb) = check_kernel_operands(
        "ublock_block", HOP_RULE, x, kmat, bias, hop, step_idx, 0, audio_down, cw, cb,
        window_dtypes=WINDOW_DTYPES)
    b, t, c = x.shape
    if audio_down.shape != x.shape or cw.shape != (n, c, c, 3) or cb.shape != (n, c):
        raise ValueError(f"ublock_block: audio_down {tuple(audio_down.shape)}, convs "
                         f"{tuple(cw.shape)} / {tuple(cb.shape)} for x {tuple(x.shape)}")
    if layers != n:
        raise ValueError(f"ublock_block: the stack holds {layers} layers, the block {n}")
    bufs = {"x": x, "out": torch.empty_like(x)}
    if n > 1:
        bufs["scratch"] = torch.empty_like(x)
    plan = pingpong(n)
    src = (ctypes.c_void_p * n)(*(bufs[s].data_ptr() for s, _ in plan))
    dst = (ctypes.c_void_p * n)(*(bufs[d].data_ptr() for _, d in plan))
    entry = f"ublock_block_forward{_suffix(kmat.dtype)}"
    fwd = getattr(_block_library(kmat.dtype), entry)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(
            src, dst, audio_down.data_ptr(), cw.data_ptr(), cb.data_ptr(),
            kmat.data_ptr(), bias.data_ptr(), (ctypes.c_int * n)(*dilations),
            n, b, t, n_win, hop, layers, step, stream,
        )
    cuda_build.check(err, entry)
    (ublock_block.bf16_launches if kmat.dtype == torch.bfloat16 else ublock_block.launches).add(1)
    return bufs["out"]


ublock_block.launches = cuda_build.LaunchCounter()
ublock_block.bf16_launches = cuda_build.LaunchCounter()
