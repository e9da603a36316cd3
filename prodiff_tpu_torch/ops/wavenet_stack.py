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
step projection stay float32; its layer chain runs one thread-block cluster
a row tile with a halo of the group's layer count (:func:`bf16_schedule`).
The plain twin emulates that exactly: each operand of a product is rounded
to bf16 and back, and the product runs in float32. Biases stay float32 in
both.
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
CHAIN_PAIRS = 32  # column pairs (j, C+j) a chain tile; a cluster block of the bf16 chain

# the bf16 chain (csrc/wavenet_stack_bf16.cu:cluster_chain_kernel): a cluster
# of C / 32 blocks computes a window of 64 * nwg frames (a wgmma m64 tile for
# each of nwg warpgroups), its middle 64 * nwg - 2 * group exact
CLUSTER_MAX_BLOCKS = 16  # C <= 512
CLUSTER_MAX_NWG = 2
CLUSTER_STAGE = 2 * 128 * CHAIN_PAIRS * 2  # bytes of a weight-ring stage: two 128-row boxes
CLUSTER_MAX_STAGES = 8
CLUSTER_MIN_STAGES = 2
# the schedule's cost, in frames of a window a layer (a ranking fitted to the
# card's times at B=1, T=512/2048): a layer of a round of clusters costs its
# window plus CLUSTER_LAYER_FRAMES (the exchanges and waits that do not
# shrink with it), a layer group CLUSTER_GROUP_FRAMES more (its launches)
CLUSTER_LAYER_FRAMES, CLUSTER_GROUP_FRAMES = 144, 192
H100_CLUSTER_SLOTS = {1: 16, 2: 16}  # co-resident 8-block clusters on an H100 (C = 256)
SMEM_LIMIT = 232448


def layer_group(b: int, t: int, c: int, n_layers: int) -> int:
    """Layers a cond + chain launch pair covers: as many as keep zc under
    ``ZC_BUDGET`` bytes (at least one)."""
    budget, per_layer = ZC_BUDGET, 4 * b * t * 2 * c
    return max(1, min(n_layers, budget // per_layer))


def cluster_plan(c: int, nwg: int) -> dict:
    """A bf16 chain block's shared memory at ``nwg`` warpgroups (as
    ``cluster_smem`` in the source): y [C/32][64 nwg + 8][32] and the gate
    [C/32][64 nwg][32] in bf16, the two exchange mbarriers, the weight
    ring's stages and their mbarriers, 1024 bytes of alignment slack;
    ``stages`` < ``CLUSTER_MIN_STAGES`` where it does not fit."""
    window = 64 * nwg
    fixed = 1024 + (c // CHAIN_PAIRS) * ((window + 8) + window) * CHAIN_PAIRS * 2 + 16
    stages = min(CLUSTER_MAX_STAGES, (SMEM_LIMIT - fixed) // (CLUSTER_STAGE + 16))
    return {"window": window, "stages": stages, "smem": fixed + stages * (CLUSTER_STAGE + 16)}


def bf16_group(b: int, t: int, c: int, n_layers: int) -> int:
    """Layers a bf16 cond + chain launch pair covers: ``layer_group``'s, and
    at most as many as leave a row tile of 16 frames in the widest window
    that fits (the window's halo is the group's layer count a side)."""
    widest = max((64 * m for m in range(1, CLUSTER_MAX_NWG + 1)
                  if cluster_plan(c, m)["stages"] >= CLUSTER_MIN_STAGES), default=64)
    return max(1, min(layer_group(b, t, c, n_layers), (widest - 16) // 2))


def bf16_schedule(b: int, t: int, c: int, n_layers: int, slots: dict = None) -> tuple:
    """The bf16 stack's schedule ``(group, nwg)``: layers a cond + chain
    launch pair covers (at most ``bf16_group``'s) and warpgroups a chain
    block (a window of 64 * nwg frames, row tiles of 64 * nwg - 2 * group),
    the pair whose clusters take the least time: rounds of ``slots[nwg]``
    co-resident clusters (default ``H100_CLUSTER_SLOTS``) times each group's
    layers times the window plus ``CLUSTER_LAYER_FRAMES``, and
    ``CLUSTER_GROUP_FRAMES`` a group. A narrower window with a shorter halo
    wins where it fills the card in as many rounds (B=1, T=512: 10 layers a
    group, one warpgroup); ties go to fewer groups, then the wider window."""
    slots = H100_CLUSTER_SLOTS if slots is None else slots
    cap = bf16_group(b, t, c, n_layers)
    best = None
    for n_groups in range(-(-n_layers // cap), n_layers + 1):
        group = -(-n_layers // n_groups)
        if -(-n_layers // group) != n_groups:
            continue  # the same group size as fewer groups
        for nwg in range(CLUSTER_MAX_NWG, 0, -1):
            bm = 64 * nwg - 2 * group
            if (bm < 1 or slots.get(nwg, 0) < 1
                    or cluster_plan(c, nwg)["stages"] < CLUSTER_MIN_STAGES):
                continue
            rounds = -(-(b * -(-t // bm)) // slots[nwg])
            cost = n_groups * CLUSTER_GROUP_FRAMES + rounds * n_layers * (
                64 * nwg + CLUSTER_LAYER_FRAMES)
            if best is None or cost < best[0]:
                best = (cost, group, nwg)
    if best is None:
        raise ValueError(f"no bf16 chain window fits C={c} with {n_layers} layers")
    return best[1], best[2]


def stack_launches(b: int, t: int, c: int, n_layers: int, dtype: torch.dtype = torch.float32,
                   slots: dict = None) -> int:
    """Kernel launches of one stack: the step projection, then a cond GEMM
    and a chain launch per layer group (``layer_group``'s for float32
    weights; ``bf16_schedule``'s, at the card's cluster ``slots``, for
    bf16)."""
    if dtype == BF16:
        group = bf16_schedule(b, t, c, n_layers, slots)[0]
    else:
        group = layer_group(b, t, c, n_layers)
    return 1 + 2 * -(-n_layers // group)


def chain_rows(b: int, t: int, c: int, slots: dict) -> int:
    """The float32 chain's tile rows: the choice of ``CHAIN_ROWS`` whose
    tiles take the least time, counted as rounds of the grid times the rows
    of a tile times their relative cost; ``slots[rows]`` is how many blocks
    of that kernel can be co-resident."""
    def cost(rows):
        tiles = b * -(-t // rows) * (c // CHAIN_PAIRS)
        return -(-tiles // max(1, slots[rows])) * rows * CHAIN_ROWS[rows]

    return min(CHAIN_ROWS, key=cost)


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_ARGTYPES_BF16 = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_slots: dict = {}
# (source, entry point, slots query) by the weights' dtype
_VARIANTS = {
    torch.float32: ("wavenet_stack", "wavenet_residual_stack", "wavenet_chain_slots"),
    BF16: ("wavenet_stack_bf16", "wavenet_residual_stack_bf16", "wavenet_cluster_slots_bf16"),
}


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    source, entry, slots = _VARIANTS[dtype]
    lib = cuda_build.load(source)
    getattr(lib, entry).argtypes = _ARGTYPES_BF16 if dtype == BF16 else _ARGTYPES
    getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, slots).argtypes = [ctypes.c_int] * (2 if dtype == BF16 else 1)
    getattr(lib, slots).restype = ctypes.c_int
    return lib


def _chain_slots(lib, dev: torch.device, dtype: torch.dtype = torch.float32, c: int = 0) -> dict:
    """Co-resident chain blocks (float32: by tile rows) or clusters (bf16, at
    C: by window tiles) on ``dev``, asked once a device, variant and C."""
    _, _, query = _VARIANTS[dtype]
    key = (dev.index, dtype, c) if dtype == BF16 else (dev.index, dtype)
    if key not in _slots:
        if dtype == BF16:
            got = {m: getattr(lib, query)(c, m) for m in range(1, CLUSTER_MAX_NWG + 1)}
            bad = min(got.values()) < 0 or max(got.values()) < 1
        else:
            got = {rows: getattr(lib, query)(rows) for rows in CHAIN_ROWS}
            bad = min(got.values()) < 1
        if bad:
            raise RuntimeError(f"{query}: occupancy query failed ({got})")
        _slots[key] = got
    return _slots[key]


def residual_stack(x0: torch.Tensor, cond: torch.Tensor, step: torch.Tensor,
                   w: StackedWaveNet) -> torch.Tensor:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> skip sum / sqrt(L), [B,T,C].

    CPU tensors run :func:`residual_stack_plain`; CUDA tensors launch the
    kernels (:func:`stack_launches`: 3 while zc fits ``ZC_BUDGET``), the
    float32 ones for float32 weights (counted in ``residual_stack.launches``)
    and the bf16 ones for bf16 weights (``residual_stack.bf16_launches``;
    C <= 512).
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
    if wdt == BF16:
        return _residual_stack_bf16(x0.contiguous(), cond, step, w, b, t, c, h, n_layers)
    x = x0.contiguous().clone()
    skip = torch.empty_like(x)
    gate = torch.empty_like(x)  # the out product's operand
    step_proj = torch.empty((n_layers, b, c), device=x.device, dtype=x.dtype)
    group = layer_group(b, t, c, n_layers)
    zc = torch.empty((group, b, t, 2 * c), device=x.device, dtype=x.dtype)
    lib = _library()
    _, entry, _ = _VARIANTS[torch.float32]
    with torch.cuda.device(x.device):
        rows = chain_rows(b, t, c, _chain_slots(lib, x.device))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            zc.data_ptr(), cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, group, rows, stream,
        )
    cuda_build.check(err, entry)
    residual_stack.launches.add(stack_launches(b, t, c, n_layers))
    return skip


def _residual_stack_bf16(x0, cond, step, w, b, t, c, h, n_layers) -> torch.Tensor:
    """The bf16 kernels on checked, contiguous CUDA operands."""
    if c // CHAIN_PAIRS > CLUSTER_MAX_BLOCKS:
        raise ValueError(f"residual_stack: bf16 weights take C <= "
                         f"{CLUSTER_MAX_BLOCKS * CHAIN_PAIRS}, got {c}")
    lib = _library(BF16)
    _, entry, _ = _VARIANTS[BF16]
    with torch.cuda.device(x0.device):
        group, nwg = bf16_schedule(b, t, c, n_layers, _chain_slots(lib, x0.device, BF16, c))
    skip = torch.empty_like(x0)
    # the residual between layer groups, in two buffers (x0 stays as it is)
    xa, xb = ((torch.empty_like(x0), torch.empty_like(x0)) if group < n_layers else (None, None))
    step_proj = torch.empty((n_layers, b, c), device=x0.device, dtype=x0.dtype)
    zc = torch.empty((group, b, t, 2 * c), device=x0.device, dtype=x0.dtype)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = getattr(lib, entry)(
            x0.data_ptr(), None if xa is None else xa.data_ptr(),
            None if xb is None else xb.data_ptr(), skip.data_ptr(), step_proj.data_ptr(),
            zc.data_ptr(), cond.data_ptr(), step.data_ptr(), *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, group, nwg, stream,
        )
    cuda_build.check(err, entry)
    residual_stack.bf16_launches.add(1 + 2 * -(-n_layers // group))
    return skip


residual_stack.launches = cuda_build.LaunchCounter()
residual_stack.bf16_launches = cuda_build.LaunchCounter()
