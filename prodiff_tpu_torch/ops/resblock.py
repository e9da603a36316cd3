"""One HiFiGAN ResBlock1 stage: CUDA kernel wrapper and its plain PyTorch twin.

Port of ``prodiff_tpu/ops/pallas/resblock.py`` (``resblock_group_packed`` and
``resblock_group_streamed``, one entry here): ``mean_j ResBlock1_j(x)`` over
a stage's ResBlock1s on ``[B, T, C]``. The kernels are ``csrc/resblock.cu``
(float32 taps) and ``csrc/resblock_bf16.cu`` (bf16 taps, the tap stacks of
``prepare_resblock_stage(dtype=bfloat16)``, on the tensor cores, a unit's
two convs in one launch); the weights' dtype picks the route. At C = 8 both
run the whole stage in one launch (``csrc/resblock_c8.cuh``, planned by
:func:`c8_plan`).
:func:`resblock_stage_plain` computes the same function with ``F.conv1d``.
:func:`resblock_stage` takes the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.

A stage's weights travel as one flat tensor: the convs in (resblock, unit,
conv1/conv2) order, each ``[k, C_in, C_out]``, float32 or bfloat16, plus
float32 biases ``[n_convs, C]``. With bf16 taps each conv rounds its
leaky'd float32 input to bf16 and accumulates in float32, as the Pallas
kernels' walk does (``_stage_walk``: ``yb = y.astype(wdtype)``); bias,
residual, the mean and the activations between convs stay float32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch import device
from prodiff_tpu_torch.ops import cuda_build

LRELU_SLOPE = 0.1
KERNEL_SIZES = (3, 7, 11)  # the kernel's taps (csrc/resblock.cu: a template argument)
MAX_PAD = 32  # the kernel's largest halo a side, get_padding(k, d)
BF16_CHANNELS = (8, 16, 32, 64, 128, 256)  # csrc/resblock_bf16.cu's widths

# csrc/resblock_bf16.cu:unit_kernel's configuration by C: frames a conv
# (M1), weight rows a ring stage and the shared-memory bytes a block may take
# (a third, a half or all of an SM's)
SMEM_LIMIT, SMEM_HALF, SMEM_THIRD = 232448, 115712, 75776
UNIT_TILES = {16: (128, 256, SMEM_THIRD), 32: (128, 256, SMEM_THIRD), 64: (128, 128, SMEM_HALF),
              128: (128, 32, SMEM_HALF), 256: (64, 32, SMEM_LIMIT)}
UNIT_MAX_STAGES = 8

# csrc/resblock.cu:pick_tile: the float32 per-conv kernel's tiles (BM frames,
# BN channels, FM frames a thread), and those a width may take in order of
# preference; a tile is taken where its grid has MIN_BLOCKS blocks
F32_TILES = ((512, 16, 4), (256, 32, 4), (256, 64, 8), (128, 64, 4), (64, 32, 4))
MIN_BLOCKS = 128  # about one block an SM of the H100's 132

# csrc/resblock_c8.cuh: the C = 8 stage kernels' block (16-row tiles a warp,
# warps at most, guard rows a side, the frames a block may own)
C8_TILES, C8_MAX_WARPS, C8_GUARD, C8_MAX_UNITS = 5, 16, 16, 512
C8_MAX_ROWS = 16 * C8_TILES * C8_MAX_WARPS  # 1280: M + 2 halo at most
C8_BLOCK_FRAMES = (512, 256, 128, 64)


def channels_supported(c: int) -> bool:
    """The kernels' widths: 8 (a HiFiGAN V2's last stage, the Pallas kernel's
    pack 16), 16, 32 and the multiples of 64 (``csrc/resblock.cu:conv``,
    ``csrc/resblock_bf16.cu:conv``). At every one of them a frame's row of
    ``C`` float32 (and a tap row of ``C`` bf16) is a whole number of 16-byte
    vectors, so a 16-byte aligned tensor keeps every row aligned."""
    return c in (8, 16, 32) or (c > 0 and c % 64 == 0)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def unit_plan(c: int, k: int, d: int) -> dict:
    """The fused-unit bf16 kernel's block at (C, k, d), as
    ``csrc/resblock_bf16.cu:unit_smem`` computes it: ``rows`` frames a conv
    (M1), ``out_rows`` stored (M1 less conv2's halo, 2 * (k - 1) / 2),
    ``halo`` the input frames a side beyond them (conv1's and conv2's
    padding: conv1 is recomputed on conv2's halo), and ``smem`` the bytes a
    block takes: X and Y as bf16 rows of C, 1024 of alignment slack, and the
    taps, either ``resident`` (C <= 32: both convs' k * C rows of C, loaded
    with X) or streamed through a ring of ``stages`` stages of
    ``stage_bytes`` and their mbarriers."""
    rows, bkr, limit = UNIT_TILES[c]
    p2 = (k - 1) // 2
    p1 = p2 * d
    fixed = 1024 + ((rows + 2 * p1) + (rows + 2 * p2)) * c * 2
    plan = {"rows": rows, "out_rows": rows - 2 * p2, "halo": p1 + p2, "limit": limit,
            "resident": c <= 32}
    if plan["resident"]:
        return dict(plan, stages=0, stage_rows=0, stage_bytes=0, smem=fixed + 2 * k * c * c * 2)
    stage = bkr * c * 2
    per_conv = -(-k * c // bkr)
    stages = min(UNIT_MAX_STAGES, 2 * per_conv, (limit - fixed) // (stage + 16))
    return dict(plan, stages=stages, stage_rows=bkr, stage_bytes=stage,
                smem=fixed + stages * (stage + 16))


def f32_tile(c: int, b: int, t: int) -> Tuple[int, int, int]:
    """The float32 per-conv kernel's tile (BM, BN, FM) at C >= 16, as
    ``csrc/resblock.cu:pick_tile`` takes it: the first of the width's list
    whose grid (B x C / BN x ceil(T / BM) blocks) has ``MIN_BLOCKS`` blocks,
    else the one with the most."""
    order = (0,) if c == 16 else (1, 4) if c == 32 else (2, 3, 4) if c <= 128 else (3, 4)
    grids = [b * (c // F32_TILES[i][1]) * -(-t // F32_TILES[i][0]) for i in order]
    for i, n in zip(order, grids):
        if n >= MIN_BLOCKS:
            return F32_TILES[i]
    return F32_TILES[order[grids.index(max(grids))]]


def c8_plan(b: int, t: int, ksizes: Sequence[int], dsizes: Sequence[Sequence[int]],
            tap_dtype: torch.dtype) -> dict:
    """The C = 8 stage kernel's block, as ``csrc/resblock_c8.cuh:plan_stage``
    computes it: ``halo`` the largest ResBlock's reach (sum over its units
    of get_padding(k, d) + get_padding(k, 1), the Pallas ``stage_meta``'s at
    pack 1 without its rounding to 8 rows), ``rows_per_block`` (M) the
    largest of ``C8_BLOCK_FRAMES`` whose grid (B x ceil(T / M)) has
    ``MIN_BLOCKS`` blocks among those that fit, else the smallest that fits;
    ``rows`` = M + 2 halo (at most ``C8_MAX_ROWS``), ``warps`` to own them in
    16-row tiles, ``smem`` the bytes (``rows + 2 C8_GUARD`` rows of x and two
    staging tiles, every conv's taps, the biases; at most ``SMEM_LIMIT``),
    ``blocks``. Raises ValueError where no M fits."""
    if any(len(ds) < 1 for ds in dsizes) or not ksizes:
        raise ValueError("resblock_stage: a C = 8 stage needs a unit in every ResBlock")
    layout = list(_conv_layout(ksizes, dsizes))
    if len(layout) // 2 > C8_MAX_UNITS:
        raise ValueError(f"resblock_stage: a C = 8 stage takes at most {C8_MAX_UNITS} units, "
                         f"got {len(layout) // 2}")
    halo = max(sum(get_padding(k, d) + get_padding(k, 1) for d in ds)
               for k, ds in zip(ksizes, dsizes))
    # bytes: a tap element; a row (x, and the leaky'd h and conv1's output
    # in float32 or the two bf16 staging tiles)
    tap_bytes, row_bytes = (2, 32 + 2 * 16) if tap_dtype == torch.bfloat16 else (4, 3 * 32)
    fixed = sum(k for k, _ in layout) * 64 * tap_bytes + len(layout) * 8 * 4

    def smem(m):
        return (m + 2 * halo + 2 * C8_GUARD) * row_bytes + fixed

    fits = [m for m in C8_BLOCK_FRAMES if m + 2 * halo <= C8_MAX_ROWS and smem(m) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"resblock_stage: no C = 8 block fits this stage: a block of M frames takes M + 2 x "
            f"{halo} (its halo) rows, at most {C8_MAX_ROWS}, and {row_bytes} bytes a row plus "
            f"{fixed} of taps and biases, at most {SMEM_LIMIT} bytes of shared memory, for M in "
            f"{C8_BLOCK_FRAMES}")
    m = next((m for m in fits if b * -(-t // m) >= MIN_BLOCKS), fits[-1])
    rows = m + 2 * halo
    return {"rows_per_block": m, "halo": halo, "rows": rows,
            "warps": -(-rows // (16 * C8_TILES)),
            "smem": smem(m), "blocks": b * -(-t // m)}


_c8_plan_cached = functools.lru_cache(maxsize=256)(c8_plan)  # the wrapper's, by shape


@functools.lru_cache(maxsize=256)
def _stage_args(c: int, tap_dtype: torch.dtype, ksizes: Tuple[int, ...],
                dsizes: Tuple[Tuple[int, ...], ...]) -> tuple:
    """A stage's checks that do not depend on its tensors' data, once per
    shape: (weight elements, convs, the kernel's int arrays); raises
    ValueError on a stage the kernels do not take."""
    if not channels_supported(c):
        raise ValueError(f"resblock_stage: C must be 8, 16, 32 or a multiple of 64, got {c}")
    if tap_dtype == torch.bfloat16 and c not in BF16_CHANNELS:
        raise ValueError(f"resblock_stage: bf16 taps take C in {BF16_CHANNELS}, got {c}")
    if len(ksizes) != len(dsizes) or any(k not in KERNEL_SIZES for k in ksizes):
        raise ValueError(
            f"resblock_stage: kernel sizes in {KERNEL_SIZES}, one per resblock: {ksizes}")
    layout = list(_conv_layout(ksizes, dsizes))
    if any(get_padding(k, d) > MAX_PAD for k, d in layout):
        raise ValueError(f"resblock_stage: a conv's halo exceeds {MAX_PAD} frames: {dsizes}")
    arrays = (_int_array(list(ksizes)), _int_array([len(ds) for ds in dsizes]),
              _int_array([d for ds in dsizes for d in ds]))
    return sum(k * c * c for k, _ in layout), len(layout), arrays


def stage_launches(c: int, tap_dtype: torch.dtype, ksizes: Sequence[int],
                   dsizes: Sequence[Sequence[int]]) -> int:
    """Kernel launches of one stage: one at C = 8 (the whole stage, either
    tap dtype); one a unit (its two convs fused) with bf16 taps at C >= 16;
    one a conv with float32 taps at C >= 16."""
    if c == 8:
        return 1
    n_convs = 2 * sum(len(ds) for ds in dsizes)
    return n_convs // 2 if tap_dtype == torch.bfloat16 else n_convs


def _conv_layout(ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]
                 ) -> Iterator[Tuple[int, int]]:
    """(kernel size, dilation) of every conv, in weight order."""
    for k, ds in zip(ksizes, dsizes):
        for d in ds:
            yield k, d
            yield k, 1


def resblock_stage_plain(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
                         ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """x [B,T,C] -> mean_j ResBlock1_j(x) [B,T,C]. bf16 ``weights``: each
    conv's input is rounded to bf16 and the float32 conv runs on the rounded
    operands (a product of two bf16 values is exact in float32), the
    kernels' function."""
    c = x.shape[-1]
    tap_dtype = weights.dtype
    convs = []
    off = 0
    for ci, (k, d) in enumerate(_conv_layout(ksizes, dsizes)):
        kern = weights[off: off + k * c * c].view(k, c, c).permute(2, 1, 0).float()  # [out, in, k]
        convs.append((kern, biases[ci], d, get_padding(k, d)))
        off += k * c * c

    def conv(h, i):
        kern, bias, d, pad = convs[i]
        return F.conv1d(h.to(tap_dtype).float(), kern, bias, padding=pad, dilation=d)

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


# the tap dtype -> (library, C entry)
_ENTRIES = {torch.float32: ("resblock", "resblock_stage"),
            torch.bfloat16: ("resblock_bf16", "resblock_stage_bf16")}


def _entry(tap_dtype: torch.dtype):
    name, fn_name = _ENTRIES[tap_dtype]
    fn = getattr(cuda_build.load(name), fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _int_array(values: Sequence[int]):
    return (ctypes.c_int * len(values))(*values)


def resblock_stage(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
                   ksizes: Sequence[int], dsizes: Sequence[Sequence[int]]) -> torch.Tensor:
    """x [B,T,C] -> mean_j ResBlock1_j(x) [B,T,C].

    CPU tensors run :func:`resblock_stage_plain`; CUDA tensors launch the
    kernel of the weights' dtype (:func:`stage_launches`): float32 taps
    ``csrc/resblock.cu``, one launch a conv (counted in
    ``resblock_stage.launches``), bf16 taps ``csrc/resblock_bf16.cu``, one
    launch a unit (``resblock_stage.bf16_launches``); at C = 8 either runs
    the whole stage in one launch (its block by :func:`c8_plan`, which
    raises before any launch where none fits), counted also in
    ``resblock_stage.c8_launches`` / ``.c8_bf16_launches``. ``x`` and
    ``biases`` are float32 on both; any other dtype raises."""
    dtype = device.compute_dtype()
    if weights.dtype not in _ENTRIES:
        raise ValueError(f"resblock_stage: taps must be one of {list(_ENTRIES)}, "
                         f"got {weights.dtype}")
    for a in (x, biases):
        if a.dtype != dtype:
            raise ValueError(f"resblock_stage: x and biases must be {dtype} (the kernels' "
                             f"activations and biases), got {a.dtype}")
    if x.device.type == "cpu":
        return resblock_stage_plain(x, weights, biases, ksizes, dsizes)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_stage: unsupported device {x.device}")
    b, t, c = x.shape
    for a in (weights, biases):
        if a.device != x.device:
            raise ValueError(f"resblock_stage: every operand must be on {x.device}, "
                             f"got {a.device}")
    ksizes, dsizes = tuple(ksizes), tuple(tuple(ds) for ds in dsizes)
    n_w, n_convs, arrays = _stage_args(c, weights.dtype, ksizes, dsizes)
    if weights.numel() != n_w or tuple(biases.shape) != (n_convs, c):
        raise ValueError(
            f"resblock_stage: weights {tuple(weights.shape)} / biases "
            f"{tuple(biases.shape)} do not match {n_convs} convs at C={c}"
        )
    if c == 8:
        _c8_plan_cached(b, t, ksizes, dsizes, weights.dtype)
    x = x.contiguous()
    weights, biases = weights.contiguous(), biases.contiguous()
    if weights.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("resblock_stage: x and the weights must be 16-byte aligned")
    if biases.data_ptr() % 16:  # the kernels read them as float4s
        biases = biases.clone()
    out = torch.empty_like(x)
    h, tmp = (out, out) if c == 8 else (torch.empty_like(x), torch.empty_like(x))
    entry = _entry(weights.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(
            x.data_ptr(), out.data_ptr(), h.data_ptr(), tmp.data_ptr(),
            weights.data_ptr(), biases.data_ptr(), *arrays, len(ksizes), b, t, c, stream,
        )
    cuda_build.check(err, _ENTRIES[weights.dtype][1])
    bf16 = weights.dtype == torch.bfloat16
    n = stage_launches(c, weights.dtype, ksizes, dsizes)
    (resblock_stage.bf16_launches if bf16 else resblock_stage.launches).add(n)
    if c == 8:  # the one-launch C = 8 stage kernels, apart
        (resblock_stage.c8_bf16_launches if bf16 else resblock_stage.c8_launches).add(n)
    return out


resblock_stage.launches = cuda_build.LaunchCounter()
resblock_stage.bf16_launches = cuda_build.LaunchCounter()
resblock_stage.c8_launches = cuda_build.LaunchCounter()  # also in .launches
resblock_stage.c8_bf16_launches = cuda_build.LaunchCounter()  # also in .bf16_launches
