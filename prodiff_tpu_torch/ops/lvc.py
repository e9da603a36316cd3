"""FastDiff's location-variable convolution (LVC): CUDA kernel wrapper and its
plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/lvc.py`` (``lvc_pallas``) and of
``prodiff_tpu/models/fastdiff.py:location_variable_convolution``: per hop
window ``l``, ``y[t] = bias[l] + taps(x)[t] @ kmat[l]`` with the k=3 taps
tap-major (row ``d*Cin + ci``, d = 0 for time t-1), zero at the sequence ends
and read across window edges, at every hop that is a multiple of 8 (as
``lvc_pallas``). The kernel is ``csrc/lvc.cu``, whose work units
:func:`lvc_plan` mirrors; :func:`lvc_plain` computes the same function with
``torch.matmul``.
:func:`lvc` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. At a hop outside the kernels' contract the
caller takes :func:`lvc_matmul` instead, as :func:`on_kernels` decides.

Window kernels come either per layer (``kmat [B, L, 3Cin, Cout]``, ``bias
[B, L, Cout]``, ``step_idx=None``) or as the hoisted KernelPredictor stack
(``kmat [N, B, L, layers*3Cin, Cout]``, ``bias [N, B, L, layers*Cout]``),
read in place at ``(step_idx, layer_idx)``. The plain versions take float32
or bf16 window kernels (the KernelPredictor's output in ``fast`` mode) and
widen bf16 ones to float32, as XLA promotes the JAX package's mixed einsum;
K6 takes float32 windows only: the JAX package reaches ``lvc_pallas`` only
from its linen route, whose KernelPredictor is float32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.ops import cuda_build

KERNEL_C = 32  # the kernels' fixed input width (FastDiff's inner channels)
STREAM_MAX_HOP = 64  # hop < 64: K4 and K6 stream a window's kernel into registers
MAX_SMEM = 232448  # the H100's shared memory a block (227 KB)


# A window-kernel launch's hop contract: its description and its test (T =
# L * hop always). K6's is lvc_pallas's (prodiff_tpu/ops/pallas/lvc.py:90);
# K4's adds the multiples of 4 from hop 64 on, which ublock_layer_packed
# takes (hop % (128 // C), prodiff_tpu/ops/pallas/ublock.py:291) and which
# csrc/lvc_tiles.cuh's tiled plan (hop >= 64) splits a tile for.
HopRule = Tuple[str, Callable[[int], bool]]
HOP_RULE: HopRule = ("a multiple of 8", lambda hop: hop >= 8 and hop % 8 == 0)
LAYER_HOP_RULE: HopRule = (
    "a multiple of 8, or of 4 from 64 on",
    lambda hop: HOP_RULE[1](hop) or (hop >= STREAM_MAX_HOP and hop % 4 == 0))


def on_kernels(hop: int, fused_layer: bool) -> bool:
    """Whether FastDiff's window product at ``hop`` runs on this package's
    kernels, decided before any launch: the fused layer (K4, K7 behind its
    own gate) where :data:`LAYER_HOP_RULE` admits the hop, the unfused one
    (K6) where :data:`HOP_RULE` does. Elsewhere the caller takes
    :func:`lvc_matmul`, the ``torch.matmul`` product that the JAX package
    computes with its XLA einsum there: on its linen route at every hop
    (``use_pallas_lvc`` off), on its packed route below hop 64
    (``_FUSED_MIN_HOP``)."""
    return (LAYER_HOP_RULE if fused_layer else HOP_RULE)[1](hop)


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
    km = km.float()
    n_win, kc, cout = km.shape[1:]
    if t != n_win * hop or kc != 3 * cin:
        raise ValueError(f"lvc: x {tuple(x.shape)} does not match kernels {tuple(km.shape)} at hop {hop}")
    xp = F.pad(x, (0, 0, 1, 1))
    taps = torch.cat([xp[:, i: i + t] for i in range(3)], dim=2)  # [B, T, 3Cin]
    y = torch.matmul(taps.view(b, n_win, hop, kc), km) + lb[:, :, None, :]
    return y.reshape(b, t, cout)


def lvc_matmul(x: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor, hop: int,
               step_idx: Optional[int] = None, layer_idx: int = 0) -> torch.Tensor:
    """The window product off the kernels (:func:`on_kernels` false):
    :func:`lvc_plain` on any device, bf16 windows widened to float32, each
    call counted in ``lvc_matmul.launches`` (library launches, no kernel of
    this package)."""
    lvc_matmul.launches.add(1)
    return lvc_plain(x, kmat, bias, hop, step_idx, layer_idx)


def check_kernel_operands(name: str, hop_rule: HopRule, x: torch.Tensor, kmat: torch.Tensor,
                          bias: torch.Tensor, hop: int, step_idx: Optional[int], layer_idx: int,
                          *extra: torch.Tensor,
                          window_dtypes: Tuple[torch.dtype, ...] = (torch.float32,)):
    """Validate the operands of a window-kernel launch, its hop against the
    kernel's ``hop_rule`` and its window kernels' dtype against the builds it
    has (``window_dtypes``: K4 and K7 float32 and bfloat16, K6 float32);
    every other operand is float32. Returns the stack's ``(n_win, layers,
    step, layer)`` and the contiguous operands."""
    b, t, c = x.shape
    dtype = device.compute_dtype()
    if kmat.dtype not in window_dtypes:
        raise ValueError(f"{name}: the window kernels must be one of {list(window_dtypes)}, "
                         f"got {kmat.dtype}")
    for a in (x, kmat, bias, *extra):
        if a.device != x.device or (a is not kmat and a.dtype != dtype):
            raise ValueError(f"{name}: every operand but the window kernels must be {dtype}, "
                             f"all on {x.device}, got {a.dtype} on {a.device}")
    if c != KERNEL_C:
        raise ValueError(f"{name}: the kernel takes C = {KERNEL_C} channels, got {c}")
    rule, hop_ok = hop_rule
    if not hop_ok(hop) or t % hop:
        raise ValueError(f"{name}: hop must be {rule} dividing T={t}, got {hop}")
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


# csrc/lvc.cu's plans (plan_for computes the same numbers)
UNIT_MAX = 128  # pipelined: rows a unit at most
_CONSUMERS = 256  # pipelined: consumer threads a block, one a row of a unit
MAX_STAGES = 8
_STREAM_WARPS, _XLD = 8, 20
_STAGE_FIXED = 4 * (3 * KERNEL_C * 2 * KERNEL_C + 2 * KERNEL_C)  # a window's kernel and bias


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def lvc_plan(hop: int) -> dict:
    """K6's work unit at ``hop`` (a multiple of 8). Streaming (hop < 64): a
    unit is one warp's 8 ``rows`` of a window (``pieces``: the window's
    8-row slices) x 32 outputs, ``groups`` = 8 warps a block, no ring;
    ``smem`` is the warps' staged x. Pipelined (hop >= 64): a unit is
    ``rows`` rows (a multiple of 8, at most 128) of one window, cut into
    ``pieces`` (the last may be short); ``groups`` = 256 // rows units are
    computed at once, by ``rows`` threads each (8 rows x 8 outputs a
    thread); a ring of ``stages`` (a multiple of ``groups``) holds a unit's
    kernel, bias and rows + 2 halo rows of x; ``smem`` counts the stages
    and their two mbarriers."""
    if hop < 8 or hop % 8:
        raise ValueError(f"lvc_plan: hop must be a multiple of 8, got {hop}")
    if hop < STREAM_MAX_HOP:
        return {"streams": True, "rows": 8, "pieces": hop // 8, "groups": _STREAM_WARPS,
                "stages": 0, "smem": _STREAM_WARPS * KERNEL_C * _XLD * 4}
    share = _ceil_div(hop, UNIT_MAX)
    rows = _ceil_div(_ceil_div(hop, share), 8) * 8
    groups = _CONSUMERS // rows
    per = _STAGE_FIXED + (rows + 2) * KERNEL_C * 4 + 16
    stages = min(MAX_STAGES, MAX_SMEM // per) // groups * groups
    return {"streams": False, "rows": rows, "pieces": _ceil_div(hop, rows), "groups": groups,
            "stages": stages, "smem": stages * per}


def _library() -> ctypes.CDLL:
    return bind_library(cuda_build.load("lvc"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare K6's C entry points on ``lib`` (``csrc/lvc.cu``, or a variant
    of it built with defines, which only measurement code loads)."""
    lib.lvc_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.lvc_forward.restype = ctypes.c_int
    lib.lvc_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.lvc_grid.argtypes = [ctypes.c_int] * 3
    return lib


def lvc(x: torch.Tensor, kmat: torch.Tensor, bias: torch.Tensor, hop: int,
        step_idx: Optional[int] = None, layer_idx: int = 0) -> torch.Tensor:
    """x [B, T, Cin] -> [B, T, Cout].

    CPU tensors run :func:`lvc_plain`; CUDA tensors launch the kernel (one
    launch, counted in ``lvc.launches``), which needs Cin = 32, Cout = 64 and
    float32 window kernels. bf16 windows raise on both."""
    if kmat.dtype != torch.float32:
        raise ValueError(f"lvc: the kernel takes float32 window kernels, got {kmat.dtype}")
    if x.device.type == "cpu":
        return lvc_plain(x, kmat, bias, hop, step_idx, layer_idx)
    if x.device.type != "cuda":
        raise ValueError(f"lvc: unsupported device {x.device}")
    (n_win, layers, step, layer), (x, kmat, bias) = check_kernel_operands(
        "lvc", HOP_RULE, x, kmat, bias, hop, step_idx, layer_idx)
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
lvc_matmul.launches = cuda_build.LaunchCounter()
