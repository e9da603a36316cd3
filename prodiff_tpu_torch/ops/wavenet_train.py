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
for CPU tensors; a CUDA tensor launches the kernel or raises. Parity mode
keeps the saved activations in float32.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from prodiff_tpu_torch.ops import cuda_build
from prodiff_tpu_torch.ops.wavenet_stack import (
    RSQRT2,
    StackedWaveNet,
    check_operands,
    residual_stack,
    wavenet_layer_plain,
)

Tensor = torch.Tensor


def residual_stack_save_plain(x0: Tensor, cond: Tensor, step: Tensor,
                              w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """x0 [B,T,C], cond [B,T,H], step [B,C] -> (skip / sqrt(L) [B,T,C],
    xs [L,B,T,C] each layer's input, zs [L,B,T,2C] each layer's pre-gate)."""
    n_layers = w.dilated_w.shape[0]
    x, skip, xs, zs = x0, torch.zeros_like(x0), [], []
    for i in range(n_layers):
        xs.append(x)
        x, s, z = wavenet_layer_plain(x, cond, step, w, i)
        zs.append(z)
        skip = skip + s
    return skip * (1.0 / math.sqrt(n_layers)), torch.stack(xs), torch.stack(zs)


def residual_stack_chain_plain(zs: Tensor, g: Tensor,
                               w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """zs [L,B,T,2C], g [B,T,C] (cotangent of skip / sqrt(L)) -> (dz
    [L,B,T,2C], dy [L,B,T,C], dx0 [B,T,C]), top-down as the chain kernel:
    ``do = [dx / sqrt(2), g / sqrt(L)]``, ``dgate = do W_o^T``, ``dz`` from
    the gate derivative, ``dy_t = dz_t W1^T + dz_{t+1} W0^T + dz_{t-1} W2^T``,
    ``dx = dx / sqrt(2) + dy``."""
    n_layers = zs.shape[0]
    c = g.shape[-1]
    inv_sqrt_l = 1.0 / math.sqrt(n_layers)
    dx = torch.zeros_like(g)
    dzs, dys = [None] * n_layers, [None] * n_layers
    for l in reversed(range(n_layers)):
        do = torch.cat([dx * RSQRT2, g * inv_sqrt_l], dim=-1)
        dgate = do @ w.out_w[l].t()
        a, tb = torch.sigmoid(zs[l, ..., :c]), torch.tanh(zs[l, ..., c:])
        dz = torch.cat([dgate * tb * a * (1.0 - a), dgate * a * (1.0 - tb * tb)], dim=-1)
        dz_next = F.pad(dz, (0, 0, 0, 1))[:, 1:]
        dz_prev = F.pad(dz, (0, 0, 1, 0))[:, :-1]
        dy = (dz @ w.dilated_w[l, 1].t() + dz_next @ w.dilated_w[l, 0].t()
              + dz_prev @ w.dilated_w[l, 2].t())
        dx = dx * RSQRT2 + dy
        dzs[l], dys[l] = dz, dy
    return torch.stack(dzs), torch.stack(dys), dx


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
    ``[B*T, L*2C] x [L*2C, H]`` product."""
    n_layers, b, t, c = xs.shape
    h = cond.shape[-1]
    bt = b * t
    inv_sqrt_l = 1.0 / math.sqrt(n_layers)
    dzf = dz.reshape(n_layers, bt, 2 * c)
    dsp = dy.sum(dim=2)  # [L, B, C]: the step projection's gradient
    out = [None] * 11
    if needs[0]:
        out[0] = dx0
    if needs[1]:
        dz_frames = dz.permute(1, 2, 0, 3).reshape(bt, n_layers * 2 * c)
        cond_w = w.cond_w.transpose(1, 2).reshape(n_layers * 2 * c, h)
        out[1] = (dz_frames @ cond_w).reshape(b, t, h)
    if needs[2]:
        out[2] = torch.einsum("lbd,lcd->bc", dsp, w.diff_w)
    if needs[3]:
        y = xs + (step @ w.diff_w + w.diff_b[:, None, :])[:, :, None, :]  # [L,B,T,C]
        yf = y.reshape(n_layers, bt, c)
        # tap 0 pairs y_{t-1} with dz_t, tap 2 y_{t+1} with dz_t
        tap0 = yf[:, :-1].mT @ dzf[:, 1:] - torch.einsum(
            "lbc,lbd->lcd", y[:, :-1, -1], dz[:, 1:, 0])
        tap2 = yf[:, 1:].mT @ dzf[:, :-1] - torch.einsum(
            "lbc,lbd->lcd", y[:, 1:, 0], dz[:, :-1, -1])
        out[3] = torch.stack([tap0, yf.mT @ dzf, tap2], dim=1)
    if needs[4] or needs[8]:
        db = dz.sum(dim=(1, 2))
        out[4] = db if needs[4] else None
        out[8] = db if needs[8] else None
    if needs[5]:
        out[5] = step.t() @ dsp
    if needs[6]:
        out[6] = dsp.sum(dim=1)
    if needs[7]:
        out[7] = cond.reshape(bt, h).t() @ dzf
    if needs[9] or needs[10]:
        # the carry before each layer, dL/d(its output x), rebuilt from dy
        carry_in = torch.empty_like(dy)
        carry = torch.zeros_like(dx0)
        for l in reversed(range(n_layers)):
            carry_in[l] = carry
            carry = dy[l] + RSQRT2 * carry
        if needs[9]:
            gate = torch.sigmoid(zs[..., :c]) * torch.tanh(zs[..., c:])
            gf = gate.reshape(n_layers, bt, c)
            out[9] = torch.cat([RSQRT2 * (gf.mT @ carry_in.reshape(n_layers, bt, c)),
                                inv_sqrt_l * (gf.mT @ g.reshape(bt, c))], dim=-1)
        if needs[10]:
            out[10] = torch.cat([RSQRT2 * carry_in.sum(dim=(1, 2)),
                                 (inv_sqrt_l * g.sum(dim=(0, 1))).expand(n_layers, c)], dim=-1)
    return tuple(out)


_SAVE_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CHAIN_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("wavenet_train")
    lib.wavenet_stack_save_forward.argtypes = _SAVE_ARGTYPES
    lib.wavenet_stack_save_forward.restype = ctypes.c_int
    lib.wavenet_stack_backward_chain.argtypes = _CHAIN_ARGTYPES
    lib.wavenet_stack_backward_chain.restype = ctypes.c_int
    return lib


def residual_stack_save(x0: Tensor, cond: Tensor, step: Tensor,
                        w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """(skip / sqrt(L), xs, zs) as :func:`residual_stack_save_plain`. CUDA
    tensors launch the save-forward kernel (1 + 2L launches, counted in
    ``residual_stack_save.launches``); CPU tensors run the plain twin."""
    if x0.device.type == "cpu":
        return residual_stack_save_plain(x0, cond, step, w)
    b, t, c, h, n_layers = check_operands("residual_stack_save", x0, cond, step, w)
    cond, step = cond.contiguous(), step.contiguous()
    w = StackedWaveNet(*(a.contiguous() for a in w))
    x = x0.contiguous().clone()
    skip, gate = torch.empty_like(x), torch.empty_like(x)
    step_proj = x.new_empty((n_layers, b, c))
    xs = x.new_empty((n_layers, b, t, c))
    zs = x.new_empty((n_layers, b, t, 2 * c))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wavenet_stack_save_forward(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), step_proj.data_ptr(),
            xs.data_ptr(), zs.data_ptr(), cond.data_ptr(), step.data_ptr(),
            *(a.data_ptr() for a in w), b, t, c, h, n_layers, stream,
        )
    cuda_build.check(err, "wavenet_stack_save_forward")
    residual_stack_save.launches.add(1 + 2 * n_layers)
    return skip, xs, zs


residual_stack_save.launches = cuda_build.LaunchCounter()


def residual_stack_chain(zs: Tensor, g: Tensor,
                         w: StackedWaveNet) -> Tuple[Tensor, Tensor, Tensor]:
    """(dz, dy, dx0) as :func:`residual_stack_chain_plain`. CUDA tensors
    launch the chain kernel (2L launches, counted in
    ``residual_stack_chain.launches``); its ``dz`` is a permuted view of
    ``[B,T,L,2C]`` storage. CPU tensors run the plain twin."""
    if g.device.type == "cpu":
        return residual_stack_chain_plain(zs, g, w)
    n_layers, b, t, c2 = zs.shape
    c = c2 // 2
    if g.device.type != "cuda":
        raise ValueError(f"residual_stack_chain: unsupported device {g.device}")
    for name, a, want in (("zs", zs, (n_layers, b, t, c2)), ("g", g, (b, t, c)),
                          ("dilated_w", w.dilated_w, (n_layers, 3, c, c2)),
                          ("out_w", w.out_w, (n_layers, c, c2))):
        if tuple(a.shape) != want or a.device != g.device or a.dtype != torch.float32:
            raise ValueError(f"residual_stack_chain: {name} must be float32 {want} on "
                             f"{g.device}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    if c2 != 2 * c or c % 64:
        raise ValueError(f"residual_stack_chain: needs C % 64 == 0 (C={c})")
    zs, g = zs.contiguous(), g.contiguous()
    # the chain's B tiles read W_d and W_o transposed: [L,3,2C,C], [L,2C,C]
    dwt = w.dilated_w.transpose(2, 3).contiguous()
    owt = w.out_w.transpose(1, 2).contiguous()
    dx = torch.zeros_like(g)
    dz = g.new_empty((b, t, n_layers, c2))
    dy = g.new_empty((n_layers, b, t, c))
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.wavenet_stack_backward_chain(
            zs.data_ptr(), g.data_ptr(), dwt.data_ptr(), owt.data_ptr(), dx.data_ptr(),
            dz.data_ptr(), dy.data_ptr(), b, t, c, n_layers, stream,
        )
    cuda_build.check(err, "wavenet_stack_backward_chain")
    residual_stack_chain.launches.add(2 * n_layers)
    return dz.permute(2, 0, 1, 3), dy, dx


residual_stack_chain.launches = cuda_build.LaunchCounter()


class ResidualStackFn(torch.autograd.Function):
    """``(x0, cond, step, *StackedWaveNet) -> skip / sqrt(L)``, differentiable
    in every input. On CUDA tensors the forward is K1 when no input needs a
    gradient and the save-forward kernel otherwise; the backward is the chain
    kernel + :func:`stack_param_grads`. CPU tensors run the plain twins."""

    @staticmethod
    def forward(ctx, x0, cond, step, *weights):
        w = StackedWaveNet(*weights)
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
        return stack_param_grads(xs, zs, dz, dy, dx0, g, cond, step, w, ctx.needs_input_grad)


def differentiable_stack(x0: Tensor, cond: Tensor, step: Tensor, w: StackedWaveNet) -> Tensor:
    """The denoiser's residual stack: :class:`ResidualStackFn` when grad mode
    is on and an operand requires grad, else K1 (:func:`residual_stack`)
    directly. Inside ``Function.forward`` grad mode reads off, so this is
    where serving and validation keep to K1."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x0, cond, step, *w)):
        return ResidualStackFn.apply(x0, cond, step, *w)
    return residual_stack(x0, cond, step, w)
