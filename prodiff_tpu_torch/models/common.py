"""Transformer primitives: attention, conv-FFN, FFT blocks (port of
``prodiff_tpu/models/common.py``).

Pre-LN self-attention without qkv bias, conv-FFN with kernel 9 scaled by
``k^-0.5`` then exact GELU, padding-aware sinusoidal positions, per-layer
nonpadding masking, and ``nn.Dropout`` at the JAX package's four places
(after the embeddings, after attention, inside the FFN after GELU, after the
FFN), active in ``.train()`` only. Public layout is ``[B, T, C]``.
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
in both frameworks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6  # flax.linen.LayerNorm default


def cast(dtype: Optional[torch.dtype], *xs):
    """flax's ``promote_dtype(..., dtype=dtype)``: every operand in the
    module's compute dtype; ``None`` leaves them as they are."""
    if dtype is None:
        return xs
    return tuple(None if x is None else x.to(dtype) for x in xs)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as float32 (exact); any other dtype as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """A LayerNorm without dtype: a bf16 input meets the float32 scale and
    bias and comes out float32 (flax's promotion)."""
    return ln(widen(x))


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
        return F.linear(*cast(self.dtype, x, self.weight, self.bias))


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
    the float32 softmax is cast to the query's dtype."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, bias=False, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.num_heads, self.embed_dim // self.num_heads
        x, w = cast(self.dtype, x, self.in_proj_weight)
        q, k, v = (x @ w.t()).chunk(3, dim=-1)
        q = q.reshape(b, t, h, d) * d ** -0.5
        k = k.reshape(b, t, h, d)
        v = v.reshape(b, t, h, d)
        attn = torch.einsum("bqhd,bkhd->bhqk", widen(q), widen(k))
        if key_padding_mask is not None:
            attn = attn.masked_fill(key_padding_mask[:, None, None, :], torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, self.embed_dim)
        return self.out_proj(out)


class TransformerFFNLayer(nn.Module):
    """Conv(k) -> *k^-0.5 -> GELU -> Linear FFN (reference ``common_layers.py:542-585``)."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int = 9,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.ffn_1 = nn.Conv1d(hidden_size, filter_size, kernel_size, padding=kernel_size // 2)
        self.dropout = nn.Dropout(dropout)
        self.ffn_2 = Linear(filter_size, hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast(self.dtype, x, self.ffn_1.weight, self.ffn_1.bias)
        x = F.conv1d(x.transpose(1, 2), w, b, padding=self.kernel_size // 2).transpose(1, 2)
        x = F.gelu(x * self.kernel_size ** -0.5)
        return self.ffn_2(self.dropout(x))


class EncSALayer(nn.Module):
    """Pre-LN encoder layer: LN->MHA->res->mask, LN->FFN->res->mask."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        if num_heads > 0:
            self.layer_norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
            self.self_attn = MultiheadSelfAttention(hidden_size, num_heads, dtype=dtype)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.ffn = TransformerFFNLayer(hidden_size, 4 * hidden_size, kernel_size, dropout, dtype)
        self.dropout = nn.Dropout(dropout)

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
                 dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.op = EncSALayer(hidden_size, num_heads, kernel_size, dropout, dtype)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        return self.op(x, padding_mask)


class FFTBlocks(nn.Module):
    """Stack of encoder layers with a final LayerNorm (reference
    ``modules/fastspeech/tts_modules.py:232-288``); positions are added by the
    encoder that owns the stack, as on the slice's path."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, dropout: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_size, num_heads, ffn_kernel_size, dropout, dtype)
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
