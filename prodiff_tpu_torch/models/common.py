"""Transformer primitives: attention, conv-FFN, FFT blocks (port of
``prodiff_tpu/models/common.py``).

Pre-LN self-attention without qkv bias, conv-FFN with kernel 9 scaled by
``k^-0.5`` then exact GELU, padding-aware sinusoidal positions, per-layer
nonpadding masking, and :class:`Dropout` (flax's) at the JAX package's four
places (after the embeddings, after attention, inside the FFN after GELU,
after the FFN), active in ``.train()`` only. Public layout is ``[B, T, C]``.
Parameter names follow the torch reference's state dict
(``encoder.layers.{i}.op.self_attn.in_proj_weight`` ...), which
``prodiff_tpu/utils/teacher_convert.py`` maps to the JAX package's tree. LayerNorm epsilon is flax's 1e-6, the reference this
port is held against.

``dtype`` is flax's ``dtype=``: a module given ``torch.bfloat16`` casts its
operands (input, weight, bias) to bf16 and returns bf16, while its
parameters stay float32 ``nn.Parameter``s. The casts are explicit, not
``torch.autocast``, so the ops that stay in float32 are the JAX modules'
own: attention scores accumulate and the softmax runs in float32, and the
LayerNorms (no dtype) promote a bf16 input to float32, as bf16 + f32 does
in both frameworks. In bf16 the port rounds where the JAX program does, op
by op: a product is rounded before its bias is added (:func:`linear`,
:func:`conv1d`), a Python constant is rounded to the operand's dtype before
it multiplies (:func:`weak`), and the activations run JAX's own formulas
and differentiation rules in the operand's dtype (:func:`sigmoid`,
:func:`tanh`, :func:`gelu`). In float32 the torch ops run as they are.

``tp`` (a ``parallel.megatron.TensorParallel``, the JAX modules' ``tp_axis``)
splits the attention's heads and the FFN's filter channels over the model
axis: a column-parallel ``in_proj``/``ffn_1`` and a row-parallel
``out_proj``/``ffn_2``, each module holding its rank's slices under the
one-process names (listed in ``tp_kinds``).

Dropout draws its masks as one process draws them for the global batch: a
training step hands every :class:`Dropout` its generator
(:func:`dropout_generator`, the JAX step's ``fold_in(rng, 2)``), each mask
is drawn at the global batch's rows and the rank keeps its own
(``parallel.mesh.draw_rows``), and the FFN's hidden under ``tp`` is drawn at
the full filter width, the rank keeping its channels.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from prodiff_tpu_torch.parallel.mesh import draw_rows

LN_EPS = 1e-6  # flax.linen.LayerNorm default
_DROPOUT = threading.local()


def cast(dtype: Optional[torch.dtype], *xs):
    """flax's ``promote_dtype(..., dtype=dtype)``: every operand in the
    module's compute dtype; ``None`` leaves them as they are."""
    if dtype is None:
        return xs
    return tuple(None if x is None else x.to(dtype) for x in xs)


def weak(c: float, x: torch.Tensor) -> float:
    """A Python constant as JAX applies it to ``x``: weakly typed, so first
    rounded to x's dtype (in bf16 ``9 ** -0.5`` is 0.333984375, where
    torch would multiply by the float32 value)."""
    return torch.tensor(c, dtype=x.dtype).item()


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``F.linear`` as flax's ``Dense(dtype=dtype)``: the operands cast to
    ``dtype``, the product rounded to it, then the bias added in it (two
    roundings, ``dot_general`` then ``y + bias``). Without ``dtype`` the
    bias is fused, as float32 leaves no rounding to tell apart."""
    x, weight, bias = cast(dtype, x, weight, bias)
    fused = dtype is None or bias is None
    y = F.linear(x, weight, bias if fused else None)
    return y if fused else y + bias


def conv1d(x: torch.Tensor, conv: nn.Conv1d, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``conv`` (its padding and dilation) on ``[B, T, C]`` as flax's
    ``Conv(dtype=dtype)``: the bias added after the product is rounded, as
    :func:`linear` adds it."""
    x, w, b = cast(dtype, x, conv.weight, conv.bias)
    fused = dtype is None or b is None
    y = F.conv1d(x.transpose(1, 2), w, b if fused else None, padding=conv.padding,
                 dilation=conv.dilation).transpose(1, 2)
    return y if fused else y + b


class _Logistic(torch.autograd.Function):
    """``lax.logistic`` in bf16: ``1 / (1 + exp(-x))``,
    each op rounded (JAX lowers it so), and JAX's VJP ``g * (ans * (1 -
    ans))``, each op rounded."""

    @staticmethod
    def forward(ctx, x):
        ans = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (ans * (1 - ans))


class _Tanh(torch.autograd.Function):
    """``jnp.tanh`` in bf16: one rounding forward, and the
    transpose of JAX's JVP ``(g + g * ans) * (1 - ans)``, each op rounded:
    ``u = g * (1 - ans)``, then ``u + u * ans``."""

    @staticmethod
    def forward(ctx, x):
        ans = torch.tanh(x)
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        u = g * (1 - ans)
        return u + u * ans


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=False)`` in bf16: ``0.5 * x * erfc(-x *
    s)`` with ``s`` the bf16 ``sqrt(0.5)``, each op
    rounded, and the transpose of JAX's JVPs (erfc's ``-2 / sqrt(pi) * g *
    exp(-b ** 2)``), each op rounded."""

    @staticmethod
    def forward(ctx, x):
        b = -x * weak(0.5 ** 0.5, x)
        e = torch.special.erfc(b)
        ctx.save_for_backward(x, b, e)
        return 0.5 * x * e

    @staticmethod
    def backward(ctx, g):
        x, b, e = ctx.saved_tensors
        db = g * (0.5 * x) * weak(-2 / math.sqrt(math.pi), x) * torch.exp(-(b * b))
        return (g * e) * 0.5 - db * weak(0.5 ** 0.5, x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: torch's in float32, JAX's rounding points in bf16."""
    return _Logistic.apply(x) if x.dtype == torch.bfloat16 else torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh``: torch's in float32, JAX's backward rounding in bf16."""
    return _Tanh.apply(x) if x.dtype == torch.bfloat16 else torch.tanh(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: torch's exact GELU in float32,
    JAX's rounding points in bf16."""
    return _Gelu.apply(x) if x.dtype == torch.bfloat16 else F.gelu(x)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32 (exact); any other dtype as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm without dtype: a bf16 input meets the float32 scale and
    bias and comes out float32 (flax's promotion)."""
    return ln(widen(x))


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Within: every :class:`Dropout` in train mode draws from ``generator``
    (a training step's own stream); None, or outside, torch's default
    generator, as torch's own dropout draws."""
    before = getattr(_DROPOUT, "generator", None)
    _DROPOUT.generator = generator
    try:
        yield
    finally:
        _DROPOUT.generator = before


class Dropout(nn.Module):
    """``flax.linen.Dropout``: in train mode ``where(keep, x / (1 - p), 0)``
    with ``keep = rand >= p``; in eval mode or at ``p == 0`` ``x`` itself,
    drawing nothing (a rate of 0 shifts no later draw), and zeros at
    ``p == 1``. No parameters. The mask is drawn at the global batch's rows
    (``draw_rows``) and, with ``tp``, at the full width of a column-parallel
    last dim, this rank keeping its columns (``TensorParallel.index``)."""

    def __init__(self, p: float, tp=None):
        super().__init__()
        self.p, self.tp = float(p), tp

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def keep(self, shape: Sequence[int], device: torch.device) -> torch.Tensor:
        """The keep mask of an input of ``shape`` (bool, this rank's part of
        the one-process mask)."""
        generator = getattr(_DROPOUT, "generator", None)
        shape = list(shape)
        if self.tp is not None:
            shape[-1] *= self.tp.size
        keep = draw_rows(lambda s: torch.rand(s, generator=generator, device=device) >= self.p,
                         shape)
        if self.tp is not None:
            keep = keep.index_select(-1, self.tp.index("out", shape[-1]).to(device))
        return keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        # the keep probability in x's dtype, as flax's weakly typed scalar
        return torch.where(self.keep(x.shape, x.device), x / weak(1.0 - self.p, x), 0.0)


class Embedding(nn.Embedding):
    """Token embedding with reference init (normal std=H^-0.5, zero pad row)."""

    def __init__(self, num_embeddings: int, features: int, padding_idx: Optional[int] = 0):
        super().__init__(num_embeddings, features, padding_idx=padding_idx)
        nn.init.normal_(self.weight, mean=0.0, std=features ** -0.5)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx].zero_()


class Linear(nn.Linear):
    """Dense with xavier-uniform weight and zero bias (reference ``Linear``);
    ``dtype`` is the compute dtype (flax's), the parameters stay float32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        nn.init.xavier_uniform_(self.weight)
        if bias:
            nn.init.zeros_(self.bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.dtype)


def sinusoidal_embedding_table(num_embeddings: int, embedding_dim: int,
                               padding_idx: Optional[int] = 0) -> np.ndarray:
    """fairseq/tensor2tensor sinusoid table: [sin | cos] blocks, zeroed pad row."""
    half_dim = embedding_dim // 2
    emb = math.log(10000) / (half_dim - 1)
    emb = np.exp(np.arange(half_dim, dtype=np.float64) * -emb)
    emb = np.arange(num_embeddings, dtype=np.float64)[:, None] * emb[None, :]
    emb = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if embedding_dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_embeddings, 1))], axis=1)
    if padding_idx is not None:
        emb[padding_idx, :] = 0
    return emb.astype(np.float32)


def make_positions(nonpad_mask: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """Padding-aware positions: first real token gets padding_idx+1."""
    mask = nonpad_mask.long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class SinusoidalPositionalEmbedding(nn.Module):
    """Padding-aware sinusoidal positions; the table is a non-persistent buffer."""

    def __init__(self, embedding_dim: int, padding_idx: int = 0, init_size: int = 2048):
        super().__init__()
        self.padding_idx = padding_idx
        table = sinusoidal_embedding_table(init_size + padding_idx + 1, embedding_dim, padding_idx)
        self.register_buffer("table", torch.from_numpy(table), persistent=False)

    def forward(self, nonpad_mask: torch.Tensor) -> torch.Tensor:
        if nonpad_mask.shape[1] + self.padding_idx >= self.table.shape[0]:
            raise ValueError(f"sequence longer than the {self.table.shape[0] - 1}-position table")
        return self.table[make_positions(nonpad_mask, self.padding_idx)]


class MultiheadSelfAttention(nn.Module):
    """fairseq ``MultiheadAttention(self_attention=True, bias=False)``.

    Plain matmul + softmax: the JAX package has no kernel for it either. In
    bf16 the scores accumulate in float32 (``preferred_element_type``) and
    the float32 softmax is cast to the query's dtype. With ``tp`` a rank
    computes its share of the heads and the out_proj's partial sum."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None,
                 tp=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype, self.tp = dtype, tp
        width = embed_dim if tp is None else tp.split(embed_dim)
        if tp is not None:
            tp.split(num_heads, "heads")
            self.tp_kinds = {"in_proj_weight": "qkv", "out_proj.weight": "in"}
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, embed_dim))
        self.out_proj = Linear(width, embed_dim, bias=False, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        d = self.embed_dim // self.num_heads
        if self.tp is not None:
            x = self.tp.copy(x)
        x, w = cast(self.dtype, x, self.in_proj_weight)
        q, k, v = (x @ w.t()).chunk(3, dim=-1)
        h = q.shape[-1] // d  # this rank's heads
        q = q.reshape(b, t, h, d)
        q = q * weak(d ** -0.5, q)
        k = k.reshape(b, t, h, d)
        v = v.reshape(b, t, h, d)
        attn = torch.einsum("bqhd,bkhd->bhqk", widen(q), widen(k))
        if key_padding_mask is not None:
            attn = attn.masked_fill(key_padding_mask[:, None, None, :], torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, h * d))
        return out if self.tp is None else self.tp.reduce(out)


class TransformerFFNLayer(nn.Module):
    """Conv(k) -> *k^-0.5 -> GELU -> Linear FFN (reference ``common_layers.py:542-585``).
    With ``tp`` a rank holds its slice of the filter channels: ``ffn_1``
    column-parallel, ``ffn_2`` row-parallel (its bias added after the reduce)."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int = 9,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None, tp=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype, self.tp = dtype, tp
        if tp is not None:
            filter_size = tp.split(filter_size)
            self.tp_kinds = {"ffn_1.weight": "out", "ffn_1.bias": "out", "ffn_2.weight": "in"}
        self.ffn_1 = nn.Conv1d(hidden_size, filter_size, kernel_size, padding=kernel_size // 2)
        self.dropout = Dropout(dropout, tp=tp)
        self.ffn_2 = Linear(filter_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.copy(x)
        x = conv1d(x, self.ffn_1, self.dtype)
        x = self.dropout(gelu(x * weak(self.kernel_size ** -0.5, x)))
        if self.tp is None:
            return self.ffn_2(x)
        x, w, b = cast(self.dtype, x, self.ffn_2.weight, self.ffn_2.bias)
        return self.tp.reduce(F.linear(x, w)) + b


class EncSALayer(nn.Module):
    """Pre-LN encoder layer: LN->MHA->res->mask, LN->FFN->res->mask."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None, tp=None):
        super().__init__()
        self.num_heads = num_heads
        if num_heads > 0:
            self.layer_norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
            self.self_attn = MultiheadSelfAttention(hidden_size, num_heads, dtype=dtype, tp=tp)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.ffn = TransformerFFNLayer(hidden_size, 4 * hidden_size, kernel_size, dropout, dtype,
                                       tp=tp)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        nonpad = (~padding_mask).to(x.dtype)[:, :, None]
        if self.num_heads > 0:
            residual = x
            x = self.self_attn(layer_norm(self.layer_norm1, x), key_padding_mask=padding_mask)
            x = (residual + self.dropout(x)) * nonpad
        residual = x
        x = self.ffn(layer_norm(self.layer_norm2, x))
        return (residual + self.dropout(x)) * nonpad


class TransformerEncoderLayer(nn.Module):
    """The reference's wrapper that names each layer's body ``op``."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None, tp=None):
        super().__init__()
        self.op = EncSALayer(hidden_size, num_heads, kernel_size, dropout, dtype, tp=tp)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return self.op(x, padding_mask)


class FFTBlocks(nn.Module):
    """Stack of encoder layers with a final LayerNorm (reference
    ``modules/fastspeech/tts_modules.py:232-288``); positions are added by the
    encoder that owns the stack, as on the slice's path."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, dropout: float = 0.1, dtype: Optional[torch.dtype] = None,
                 tp=None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, num_heads, ffn_kernel_size, dropout, dtype, tp)
            for _ in range(num_layers)
        )
        self.layer_norm = nn.LayerNorm(hidden_size, eps=LN_EPS)

    def run_layers(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        nonpad = (~padding_mask).to(x.dtype)[:, :, None]
        x = x * nonpad
        for layer in self.layers:
            x = layer(x, padding_mask) * nonpad
        return layer_norm(self.layer_norm, x) * nonpad


class SinusoidalPosEmb(nn.Module):
    """Diffusion-timestep embedding (reference ``modules/decoder/wavenet.py:26-38``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        emb = math.log(10000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
        emb = t.float()[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def params_key(module: nn.Module) -> tuple:
    """Changes whenever a parameter of ``module`` is replaced, moved or
    written in place; keys caches of weights re-laid-out for a kernel."""
    return tuple((p.data_ptr(), p._version) for p in module.parameters())
