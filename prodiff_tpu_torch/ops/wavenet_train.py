"""The trainable WaveNet residual stack (K5): kernels, their plain twins and
the autograd Function that joins them.

Port of ``prodiff_tpu/ops/pallas/wavenet_train.py``: the JAX package's
custom VJP (primal = K1, fwd = the save kernel, bwd = the chain kernel +
XLA einsums) becomes :class:`ResidualStackFn`:

- forward: K1 (``ops/wavenet_stack.py``) when no gradient is needed, else the
  save-forward kernel, which also returns each layer's input ``xs
  [L,B,T,C]`` and pre-gate ``zs [L,B,T,2C]``;
- backward: the chain kernel walks the layers top-down and returns ``dz
  [L,B,T,2C]`` (the gradient at the pre-gate), ``dy [L,B,T,C]`` (at the
  dilated conv's input) and ``dx0``; :func:`stack_param_grads` turns them
  into the weight, cond and step gradients with ``torch.matmul`` (cuBLAS),
  where the JAX package uses XLA einsums.

The kernels are ``csrc/wavenet_train.cu``. :func:`residual_stack_save` and
:func:`residual_stack_chain` take their plain twins
(:func:`residual_stack_save_plain`, :func:`residual_stack_chain_plain`) only
for CPU tensors; a CUDA tensor launches the kernel or raises.

The weights' dtype selects the variant, as the JAX package's ``save_dtype``
and ``cdt = dw.dtype`` do (``prodiff_tpu/ops/pallas/wavenet_train.py``):
float32 weights keep the saved activations in float32 (``csrc/
wavenet_train.cu``); bf16 weights run ``csrc/wavenet_train_bf16.cu``, which
saves ``xs``/``zs`` in bf16, runs the chain's products on bf16 operands
with float32 accumulation and a float32 carry, and emits ``dz``/``dy`` in
bf16. The weight gradients then take bf16 operands with float32
accumulation (as ``_train_bwd``'s einsums), computed as float32 products of
the bf16 values, so every gradient is float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch.ops import cuda_build
from prodiff_tpu_torch.ops.wavenet_stack import (
    BF16,
    MATRICES,
    RSQRT2,
    StackedWaveNet,
    cast_stack,
    check_operands,
    operand_dtype,
    residual_stack,
    rounder,
    wavenet_layer_plain,
)

Tensor = torch.Tensor


def residual_stack_save_plain(x0: Tensor, cond: Tensor, step: Tensor,
                              w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> (skip / sqrt(L) [B,T,C],
    xs [L,B,T,C] each layer's input, zs [L,B,T,2C] each layer's pre-gate),
    the saves in the weights' dtype (bf16 weights: bf16 saves)."""
    n_layers = w.dilated_w.shape[0]
    save = operand_dtype(w) if operand_dtype(w) == BF16 else x0.dtype
    x, skip, xs, zs = x0, torch.zeros_like(x0), [], []
    for i in range(n_layers):
        xs.append(x)
        x, s, z = wavenet_layer_plain(x, cond, step, w, i)
        zs.append(z)
        skip = skip + s
    return (skip * (1.0 / math.sqrt(n_layers)), torch.stack(xs).to(save),
            torch.stack(zs).to(save))


def residual_stack_chain_plain(zs: Tensor, g: Tensor,
                               w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """zs [L,B,T,2C], g [B,T,C] (cotangent of skip / sqrt(L)) -> (dz
    [L,B,T,2C], dy [L,B,T,C], dx0 [B,T,C]), top-down as the chain kernel:
    ``do = [dx / sqrt(2), g / sqrt(L)]``, ``dgate = do W_o^T``, ``dz`` from
    the gate derivative, ``dy_t = dz_t W1^T + dz_{t+1} W0^T + dz_{t-1} W2^T``,
    ``dx = dx / sqrt(2) + dy``. With bf16 weights (``zs`` bf16) ``do`` and
    ``dz`` are rounded to bf16 as the products' operands, the carry ``dx``
    stays float32, and ``dz``/``dy`` come out bf16
    (``_bwd_chain_single``)."""
    n_layers = zs.shape[0]
    c = g.shape[-1]
    inv_sqrt_l = 1.0 / math.sqrt(n_layers)
    dtype = operand_dtype(w)
    r = rounder(dtype)
    dx = torch.zeros_like(g)
    dzs, dys = [None] * n_layers, [None] * n_layers
    for l in reversed(range(n_layers)):
        dw, out_w = w.dilated_w[l].to(g.dtype), w.out_w[l].to(g.dtype)
        z = zs[l].to(g.dtype)
        do = r(torch.cat([dx * RSQRT2, g * inv_sqrt_l], dim=-1))
        dgate = do @ out_w.t()
        a, tb = torch.sigmoid(z[..., :c]), torch.tanh(z[..., c:])
        dz = r(torch.cat([dgate * tb * a * (1.0 - a), dgate * a * (1.0 - tb * tb)], dim=-1))
        dz_next = F.pad(dz, (0, 0, 0, 1))[:, 1:]
        dz_prev = F.pad(dz, (0, 0, 1, 0))[:, :-1]
        dy = dz @ dw[1].t() + dz_next @ dw[0].t() + dz_prev @ dw[2].t()
        dx = dx * RSQRT2 + dy
        dzs[l], dys[l] = dz, dy
    save = dtype if dtype == BF16 else g.dtype
    return torch.stack(dzs).to(save), torch.stack(dys).to(save), dx


def stack_param_grads(xs: Tensor, zs: Tensor, dz: Tensor, dy: Tensor, dx0: Tensor,
                      g: Tensor, cond: Tensor, step: Tensor, w: StackedWaveNet,
                      needs: Sequence[bool]) -> Tuple[Optional[Tensor], ...]:
    """The gradients of every input of the stack, in the order (x0, cond,
    step, *StackedWaveNet), from the chain's ``dz``/``dy``/``dx0``; ``None``
    where ``needs`` is false. Shared by the kernel route and the plain route.

    Every product is a ``torch.matmul`` over the flattened ``B*T`` frames.
    The conv taps' shifted products use row slices of the flattened frames
    (no padded copies) and subtract the B-1 products that cross a sequence
    boundary. ``dz`` may be a permuted view of ``[B,T,L,2C]`` storage (the
    kernel's layout), which makes the cond gradient one
    ``[B*T, L*2C] x [L*2C, H]`` product.

    The products take the operands ``_train_bwd`` gives its einsums, rounded
    to the weights' dtype (a no-op for float32): ``y = xs + step_proj``,
    ``cond``, the gate and ``do`` (the scaled float32 carry). With bf16
    weights (bf16 saves, ``dz`` and ``dy``) they multiply the bf16 values in
    float32, and the bias and step sums run in float32, so every gradient
    comes out in the carry's dtype, float32."""
    n_layers, b, t, c = xs.shape
    h = cond.shape[-1]
    bt = b * t
    inv_sqrt_l = 1.0 / math.sqrt(n_layers)
    r = rounder(operand_dtype(w))
    work = dx0.dtype  # float32 (float64 in gradcheck): the gradients' dtype
    wf = cast_stack(w, work)
    dsp = dy.to(work).sum(dim=2)  # [L, B, C]: the step projection's gradient
    out = [None] * 11
    if needs[0]:
        out[0] = dx0
    if needs[1]:
        dz_frames = dz.permute(1, 2, 0, 3).reshape(bt, n_layers * 2 * c).to(work)
        cond_w = wf.cond_w.transpose(1, 2).reshape(n_layers * 2 * c, h)
        out[1] = (dz_frames @ cond_w).reshape(b, t, h)
    if needs[2]:
        out[2] = torch.einsum("lbd,lcd->bc", dsp, wf.diff_w)
    dzf = dz.to(work) if needs[3] or needs[4] or needs[7] or needs[8] else None
    if needs[3]:
        sp = step @ wf.diff_w + w.diff_b[:, None, :]  # [L, B, C]
        out[3] = _tap_grads(r(xs.to(work) + r(sp)[:, :, None, :]), dzf)
    if needs[4] or needs[8]:
        db = dzf.sum(dim=(1, 2))
        out[4] = db if needs[4] else None
        out[8] = db if needs[8] else None
    if needs[5]:
        out[5] = step.t() @ dsp
    if needs[6]:
        out[6] = dsp.sum(dim=1)
    if needs[7]:
        out[7] = r(cond).reshape(bt, h).t() @ dzf.reshape(n_layers, bt, 2 * c)
    if needs[9] or needs[10]:
        do_res = r(RSQRT2 * _carries(dy, dx0))  # [L, B, T, C]
        do_skip = r(inv_sqrt_l * g)  # [B, T, C], every layer's
        if needs[9]:
            z = zs.to(work)
            gate = r(r(torch.sigmoid(z[..., :c])) * r(torch.tanh(z[..., c:])))
            gf = gate.reshape(n_layers, bt, c)
            out[9] = torch.cat([gf.mT @ do_res.reshape(n_layers, bt, c),
                                gf.mT @ do_skip.reshape(bt, c)], dim=-1)
        if needs[10]:
            out[10] = torch.cat([do_res.sum(dim=(1, 2)),
                                 do_skip.sum(dim=(0, 1)).expand(n_layers, c)], dim=-1)
    return tuple(out)


def _tap_grads(y: Tensor, dz: Tensor) -> Tensor:
    """The dilated conv's weight gradient [L, 3, C, 2C] from its input ``y``
    [L,B,T,C] and ``dz`` [L,B,T,2C]."""
    n_layers, b, t, c = y.shape
    yf = y.reshape(n_layers, b * t, c)
    dzf = dz.reshape(n_layers, b * t, 2 * c)
    # tap 0 pairs y_{t-1} with dz_t, tap 2 y_{t+1} with dz_t
    tap0 = yf[:, :-1].mT @ dzf[:, 1:] - torch.einsum(
        "lbc,lbd->lcd", y[:, :-1, -1], dz[:, 1:, 0])
    tap2 = yf[:, 1:].mT @ dzf[:, :-1] - torch.einsum(
        "lbc,lbd->lcd", y[:, 1:, 0], dz[:, :-1, -1])
    return torch.stack([tap0, yf.mT @ dzf, tap2], dim=1)


def _carries(dy: Tensor, dx0: Tensor) -> Tensor:
    """The carry before each layer, dL/d(its output x), rebuilt from dy
    (float32)."""
    carry_in = torch.empty(dy.shape, dtype=dx0.dtype, device=dx0.device)
    carry = torch.zeros_like(dx0)
    for l in reversed(range(dy.shape[0])):
        carry_in[l] = carry
        carry = dy[l].to(dx0.dtype) + RSQRT2 * carry
    return carry_in


_SAVE_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CHAIN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


# the entry points of the float32 and bf16 libraries, by the weights' dtype
_VARIANTS = {
    torch.float32: ("wavenet_train", "wavenet_stack_save_forward", "wavenet_stack_backward_chain"),
    BF16: ("wavenet_train_bf16", "wavenet_stack_save_forward_bf16",
           "wavenet_stack_backward_chain_bf16"),
}


def _library(dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    source, save, chain = _VARIANTS[dtype]
    lib = cuda_build.load(source)
    getattr(lib, save).argtypes = _SAVE_ARGTYPES
    getattr(lib, save).restype = ctypes.c_int
    getattr(lib, chain).argtypes = _CHAIN_ARGTYPES
    getattr(lib, chain).restype = ctypes.c_int
    return lib


def residual_stack_save(x0: Tensor, cond: Tensor, step: Tensor,
                        w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """(skip / sqrt(L), xs, zs) as :func:`residual_stack_save_plain`. CUDA
    tensors launch the save-forward kernel (1 + 2L launches, counted in
    ``residual_stack_save.launches``, or ``.bf16_launches`` for bf16
    weights, whose saves are bf16); CPU tensors run the plain twin."""
    if x0.device.type == "cpu":
        return residual_stack_save_plain(x0, cond, step, w)
    b, t, c, h, n_layers = check_operands("residual_stack_save", x0, cond, step, w)
    wdt = operand_dtype(w)
    cond, step = cond.contiguous(), step.contiguous()
    w = StackedWaveNet(*(a.contiguous() for a in w))
    x = x0.contiguous().clone()
    skip, gate = torch.empty_like(x), torch.empty_like(x, dtype=wdt)
    step_proj = x.new_empty((n_layers, b, c))
    xs = x.new_empty((n_layers, b, t, c), dtype=wdt)
    zs = x.new_empty((n_layers, b, t, 2 * c), dtype=wdt)
    lib = _library(wdt)
    entry = _VARIANTS[wdt][1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            xs.data_ptr(), zs.data_ptr(), cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w), b, t, c, h, n_layers, stream,
        )
    cuda_build.check(err, entry)
    counter = residual_stack_save.bf16_launches if wdt == BF16 else residual_stack_save.launches
    counter.add(1 + 2 * n_layers)
    return skip, xs, zs


residual_stack_save.launches = cuda_build.LaunchCounter()
residual_stack_save.bf16_launches = cuda_build.LaunchCounter()


def residual_stack_chain(zs: Tensor, g: Tensor,
                         w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """(dz, dy, dx0) as :func:`residual_stack_chain_plain`. CUDA tensors
    launch the chain kernel (2L launches, counted in
    ``residual_stack_chain.launches``, or ``.bf16_launches`` for bf16
    weights and saves, which give bf16 ``dz``/``dy``); its ``dz`` is a
    permuted view of ``[B,T,L,2C]`` storage. CPU tensors run the plain
    twin."""
    if g.device.type == "cpu":
        return residual_stack_chain_plain(zs, g, w)
    n_layers, b, t, c2 = zs.shape
    c = c2 // 2
    wdt = operand_dtype(w)
    if g.device.type != "cuda":
        raise ValueError(f"residual_stack_chain: unsupported device {g.device}")
    if wdt not in _VARIANTS:
        raise ValueError(f"residual_stack_chain: weights must be float32 or {BF16}, got {wdt}")
    for name, a, want, dt in (("zs", zs, (n_layers, b, t, c2), wdt), ("g", g, (b, t, c), torch.float32),
                              ("dilated_w", w.dilated_w, (n_layers, 3, c, c2), wdt),
                              ("out_w", w.out_w, (n_layers, c, c2), wdt)):
        if tuple(a.shape) != want or a.device != g.device or a.dtype != dt:
            raise ValueError(f"residual_stack_chain: {name} must be {dt} {want} on "
                             f"{g.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if c2 != 2 * c or c % 64:
        raise ValueError(f"residual_stack_chain: needs C % 64 == 0 (C={c})")
    zs, g = zs.contiguous(), g.contiguous()
    # the chain's B tiles read W_d and W_o transposed: [L,3,2C,C], [L,2C,C]
    dwt = w.dilated_w.transpose(2, 3).contiguous()
    owt = w.out_w.transpose(1, 2).contiguous()
    dx = torch.zeros_like(g)
    dz = g.new_empty((b, t, n_layers, c2), dtype=wdt)
    dy = g.new_empty((n_layers, b, t, c), dtype=wdt)
    lib = _library(wdt)
    entry = _VARIANTS[wdt][2]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = getattr(lib, entry)(
            zs.data_ptr(), g.data_ptr(), dwt.data_ptr(), owt.data_ptr(), dx.data_ptr(),
            dz.data_ptr(), dy.data_ptr(), b, t, c, n_layers, stream,
        )
    cuda_build.check(err, entry)
    counter = residual_stack_chain.bf16_launches if wdt == BF16 else residual_stack_chain.launches
    counter.add(2 * n_layers)
    return dz.permute(2, 0, 1, 3), dy, dx


residual_stack_chain.launches = cuda_build.LaunchCounter()
residual_stack_chain.bf16_launches = cuda_build.LaunchCounter()


class ResidualStackFn(torch.autograd.Function):
    """``(x0, cond, step, *StackedWaveNet[, operand dtype]) -> skip /
    sqrt(L)``, differentiable in every input. On CUDA tensors the forward is
    K1 when no input needs a gradient and the save-forward kernel otherwise;
    the backward is the chain kernel + :func:`stack_param_grads`. CPU
    tensors run the plain twins. A trailing ``torch.bfloat16`` runs the bf16
    variants on a copy of the weight matrices cast to it (the casts are
    inside the Function, so the gradients reach the given weights in their
    own dtype, float32)."""

    @staticmethod
    def forward(ctx, x0, cond, step, *weights):
        dtype = weights[8] if len(weights) > 8 else None
        ctx.extra = len(weights) - 8
        w = StackedWaveNet(*weights[:8])
        if dtype is not None:
            w = cast_stack(w, dtype)
        if not any(ctx.needs_input_grad):
            return residual_stack(x0, cond, step, w)
        skip, xs, zs = residual_stack_save(x0, cond, step, w)
        ctx.save_for_backward(xs, zs, cond, step, *w)
        return skip

    @staticmethod
    def backward(ctx, g):
        xs, zs, cond, step, *weights = ctx.saved_tensors
        w = StackedWaveNet(*weights)
        g = g.contiguous()
        dz, dy, dx0 = residual_stack_chain(zs, g, w)
        needs = ctx.needs_input_grad[:11]
        grads = stack_param_grads(xs, zs, dz, dy, dx0, g, cond, step, w, needs)
        return grads + (None,) * ctx.extra


def differentiable_stack(x0: Tensor, cond: Tensor, step: Tensor, w: StackedWaveNet,
                         dtype: torch.dtype = torch.float32) -> Tensor:
    """The denoiser's residual stack with its products on ``dtype`` operands
    (the weight matrices cast to it): :class:`ResidualStackFn` when grad
    mode is on and an operand requires grad, else K1
    (:func:`residual_stack`) directly. Inside ``Function.forward`` grad mode
    reads off, so this is where serving and validation keep to K1."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x0, cond, step, *w)):
        extra = () if dtype == torch.float32 else (dtype,)
        return ResidualStackFn.apply(x0, cond, step, *w, *extra)
    return residual_stack(x0, cond, step, w if dtype == torch.float32 else cast_stack(w, dtype))
