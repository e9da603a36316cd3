"""The bf16 training step op by op: the port's ops against the JAX package's.

Each case feeds the same bf16 inputs, float32 parameters (flax's: promoted
to bf16 inside the op) and a seeded cotangent to a flax or lax op and to the
port's counterpart, and reads the output and every VJP (input, kernel,
bias) three ways: the share of elements that are bit-equal, the largest
distance in bf16 ulps (ordered bit patterns; a float32 result's distance
over 2 ** 16, so it too is in bf16 units), and max |d| over the peak. The
JAX side is jitted twice: as XLA compiles it by default, and with
``xla_allow_excess_precision`` off, which keeps every rounding the program
writes (the same bits as running it op by op, as
``tests/test_torch_bf16.py``'s student step does).

Each result has a class:

- (a) a rounding point the JAX program writes: flax's ``dtype=`` (a bf16
  product rounded before its bias is added, a sum of two bf16 values in
  bf16, a bf16 value promoted to float32 where it meets one), JAX's weakly
  typed constants (rounded to bf16 before they multiply) and JAX's
  formulas and differentiation rules for sigmoid, tanh and exact GELU.
  The port rounds there too (``models/common.py``: ``linear``,
  ``conv1d``, ``weak``, ``sigmoid``, ``tanh``, ``gelu``). Held against the
  strict compile at <= 1 bf16 ulp, and bit-equal in >= 99.9% of elements
  where the op computes no library function (exp, tanh, erfc, rsqrt),
  whose last bit may differ between the two libraries ("a*", reported).
  "a-f32": a result both compute in float32 (a sum in another order,
  a fused multiply-add, flax's LayerNorm formula): held within one bf16
  ulp of the peak, at the peak's binade, its bit-equal share reported.
- (b) arithmetic that XLA's CPU backend chooses inside the program, which
  the port does not copy:
  - "b-reduce": a bf16 reduction (the bias gradient, ``lax.reduce_sum`` of
    the bf16 cotangent) accumulated with less precision than float32. The
    port keeps the float32-accumulated sum rounded once, as cuBLAS, cuDNN
    and the accelerator's reductions give it. Held: JAX's result is the
    farther one from the float64 sum, and the port is within half a bf16
    ulp of it.
  - "b-fusion": a rounding the program writes that the default compile
    skips inside a fused elementwise chain (excess precision). Held: the
    port equals the strict compile as class (a) does, and the default
    compile differs from the strict one.

The float32 ops of the step (the diffusion step's ``q_sample``, the losses)
are class (a) with no bf16 rounding at all. Widths <= 128, B x T <= 600.
"""

import functools
import math
from types import SimpleNamespace
from typing import Callable, Dict, NamedTuple, Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from prodiff_tpu.models import common as jc
from prodiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from prodiff_tpu.ops import losses as jax_losses
from prodiff_tpu_torch.models import common as pc
from prodiff_tpu_torch.models import wavenet as pw
from prodiff_tpu_torch.models.diffusion import GaussianDiffusion
from prodiff_tpu_torch.ops import losses

BF16 = torch.bfloat16
STRICT = {"xla_allow_excess_precision": False}
MIN_EQUAL = 0.999  # bit-equal share of a class-(a) result without a library function
MAX_ULPS = 1.0


class Case(NamedTuple):
    args: Sequence  # (name, float32 array, "bf16" or "f32")
    jax_fn: Callable
    port_fn: Callable
    classes: Dict[str, str]  # "fwd" and "d<name>" -> a, a*, b-reduce, b-fusion
    exact: Dict[str, np.ndarray] = {}  # float64 answers of the b-reduce results


def _rng(seed):
    return np.random.default_rng(seed)


def _bf(a):
    """float32 values that bf16 holds exactly."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _conv_params(rng, cin, cout, k):
    return (_bf(rng.normal(size=(k, cin, cout)) * (cin * k) ** -0.5).astype(np.float32),
            rng.normal(size=cout).astype(np.float32))


def _bias_exact(ct):
    return ct.astype(np.float64).reshape(-1, ct.shape[-1]).sum(0)


def _conv_case(seed, b, t, cin, cout, k, dilation=1):
    """flax ``Conv(dtype=bfloat16)`` (the WaveNet's and the FFN's) vs the
    port's ``conv1d``; at k = 1 the port's ``wavenet.conv1x1``. The port's
    side takes the weights as an ``nn.Conv1d`` does (out, in, k)."""
    rng = _rng(seed)
    x = _bf(rng.normal(size=(b, t, cin)))
    kernel, bias = _conv_params(rng, cin, cout, k)

    def jax_fn(x, kernel, bias):
        mod = nn.Conv(cout, kernel_size=(k,), kernel_dilation=(dilation,), padding="SAME",
                      dtype=jnp.bfloat16)
        return mod.apply({"params": {"kernel": kernel, "bias": bias}}, x)

    def port_fn(x, kernel, bias):
        conv = SimpleNamespace(weight=kernel.permute(2, 1, 0), bias=bias,
                               padding=(dilation * (k - 1) // 2,), dilation=(dilation,))
        return pw.conv1x1(x, conv, BF16) if k == 1 else pc.conv1d(x, conv, BF16)

    return Case([("x", x, "bf16"), ("kernel", kernel, "f32"), ("bias", bias, "f32")],
                jax_fn, port_fn,
                {"fwd": "a", "dx": "a", "dkernel": "b-fusion", "dbias": "b-reduce"},
                {"dbias": _bias_exact})


def case_conv1x1():
    return _conv_case(1, 3, 100, 64, 128, 1)


def case_dilated_conv():
    return _conv_case(2, 3, 100, 64, 128, 3, dilation=2)


def case_ffn_conv():
    return _conv_case(3, 2, 60, 32, 128, 9)


def case_linear():
    """The FFN's ``ffn_2``: ``Linear(dtype=bfloat16)`` over ``nn.Dense``
    (the port's ``Linear.forward`` is ``linear``)."""
    rng = _rng(4)
    x = _bf(rng.normal(size=(2, 60, 128)))
    kernel = (rng.normal(size=(128, 32)) * 128 ** -0.5).astype(np.float32)
    bias = rng.normal(size=32).astype(np.float32)

    def jax_fn(x, kernel, bias):
        return jc.Linear(32, dtype=jnp.bfloat16).apply(
            {"params": {"Dense_0": {"kernel": kernel, "bias": bias}}}, x)

    return Case([("x", x, "bf16"), ("kernel", kernel, "f32"), ("bias", bias, "f32")],
                jax_fn, lambda x, kernel, bias: pc.linear(x, kernel.t(), bias, BF16),
                {"fwd": "a", "dx": "a", "dkernel": "a", "dbias": "b-reduce"},
                {"dbias": _bias_exact})


def case_step_projection():
    """A bf16 x plus the float32 ``diffusion_projection`` of the step
    embedding: bf16 + float32 promotes to float32 in both frameworks."""
    rng = _rng(5)
    x = _bf(rng.normal(size=(3, 100, 64)))
    step = rng.normal(size=(3, 64)).astype(np.float32)
    kernel = (rng.normal(size=(64, 64)) * 0.125).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)

    def jax_fn(x, step, kernel, bias):
        proj = jc.Linear(64).apply({"params": {"Dense_0": {"kernel": kernel, "bias": bias}}}, step)
        return x + proj[:, None, :]

    def port_fn(x, step, kernel, bias):
        return x + pc.linear(step, kernel.t(), bias)[:, None, :]

    return Case([("x", x, "bf16"), ("step", step, "f32"), ("kernel", kernel, "f32"),
                 ("bias", bias, "f32")], jax_fn, port_fn,
                {"fwd": "a", "dx": "a", "dstep": "a-f32", "dkernel": "a-f32", "dbias": "a-f32"})


def case_gate():
    """``sigmoid(gate) * tanh(filter)`` of the residual block."""
    y = _bf(_rng(6).normal(size=(3, 100, 128)) * 2)
    return Case([("y", y, "bf16")],
                lambda y: jax.nn.sigmoid(y[..., :64]) * jnp.tanh(y[..., 64:]),
                lambda y: pc.sigmoid(y[..., :64]) * pc.tanh(y[..., 64:]),
                {"fwd": "a*", "dy": "a*"})


def case_residual():
    """The residual block's ``(x + residual) * 2 ** -0.5``, its constant
    rounded to bf16 (0.70703125) as JAX's weak type rounds it."""
    rng = _rng(7)
    x, r = (_bf(rng.normal(size=(3, 100, 64))) for _ in range(2))

    def port_fn(x, r):
        s = x + r
        return s * pc.weak(2.0 ** -0.5, s)

    return Case([("x", x, "bf16"), ("r", r, "bf16")], lambda x, r: (x + r) * (2.0 ** -0.5),
                port_fn, {"fwd": "a", "dx": "a", "dr": "a"})


def case_skip_sum():
    """The bf16 skip sum over 3 layers from zeros, times ``1 / sqrt(3)``,
    then cast to float32 (the WaveNet's last step before its projections
    is the sum; its output's ``.astype(float32)`` is the same cast)."""
    rng = _rng(8)
    skips = [_bf(rng.normal(size=(3, 100, 64))) for _ in range(3)]

    def jax_fn(a, b, c):
        s = jnp.zeros_like(a)
        for k in (a, b, c):
            s = s + k
        return (s * (1.0 / math.sqrt(3))).astype(jnp.float32)

    def port_fn(a, b, c):
        s = torch.zeros_like(a)
        for k in (a, b, c):
            s = s + k
        return pc.widen(s * pc.weak(1.0 / math.sqrt(3), s))

    return Case([(n, s, "bf16") for n, s in zip("abc", skips)], jax_fn, port_fn,
                {"fwd": "b-fusion", "da": "a", "db": "a", "dc": "a"})


def case_in_proj():
    """Attention's ``in_proj``: ``nn.Dense(dtype=bfloat16)`` without bias."""
    rng = _rng(9)
    x = _bf(rng.normal(size=(2, 60, 32)))
    kernel = (rng.normal(size=(32, 96)) * 32 ** -0.5).astype(np.float32)

    def jax_fn(x, kernel):
        return nn.Dense(96, use_bias=False, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": kernel}}, x)

    return Case([("x", x, "bf16"), ("kernel", kernel, "f32")], jax_fn,
                lambda x, kernel: pc.linear(x, kernel.t(), None, BF16),
                {"fwd": "a", "dx": "a", "dkernel": "a"})


def case_attention_scores():
    """``q * d ** -0.5`` in bf16 (d = 32: 0.1767578125 once rounded), then
    the scores with float32 accumulation (``preferred_element_type``), the
    padding masked."""
    rng = _rng(10)
    q, k = (_bf(rng.normal(size=(2, 60, 2, 32))) for _ in range(2))
    mask = np.zeros((2, 60), bool)
    mask[1, 45:] = True
    scale = 32 ** -0.5

    def jax_fn(q, k):
        attn = jnp.einsum("bqhd,bkhd->bhqk", q * scale, k, preferred_element_type=jnp.float32)
        return jnp.where(mask[:, None, None, :], jnp.finfo(jnp.float32).min, attn)

    def port_fn(q, k):
        attn = torch.einsum("bqhd,bkhd->bhqk", pc.widen(q * pc.weak(scale, q)), pc.widen(k))
        return attn.masked_fill(torch.from_numpy(mask)[:, None, None, :],
                                torch.finfo(attn.dtype).min)

    return Case([("q", q, "bf16"), ("k", k, "bf16")], jax_fn, port_fn,
                {"fwd": "a-f32", "dq": "a", "dk": "b-fusion"})


def case_attention_softmax():
    """The float32 softmax cast to the query's dtype (bf16)."""
    s = (_rng(11).normal(size=(2, 2, 60, 60)) * 3).astype(np.float32)
    return Case([("scores", s, "f32")],
                lambda s: jax.nn.softmax(s, axis=-1).astype(jnp.bfloat16),
                lambda s: torch.softmax(s, dim=-1).to(BF16),
                {"fwd": "a*", "dscores": "a-f32"})


def case_attention_values():
    """The bf16 probabilities times the bf16 values (a bf16 einsum)."""
    rng = _rng(12)
    p = _bf(rng.uniform(size=(2, 2, 60, 60)) / 30)
    v = _bf(rng.normal(size=(2, 60, 2, 32)))
    return Case([("probs", p, "bf16"), ("v", v, "bf16")],
                lambda p, v: jnp.einsum("bhqk,bkhd->bqhd", p, v),
                lambda p, v: torch.einsum("bhqk,bkhd->bqhd", p, v),
                {"fwd": "a", "dprobs": "a", "dv": "a"})


def case_attention():
    """The port's ``MultiheadSelfAttention(dtype=bfloat16)`` as a whole
    (its parameters through ``torch.func.functional_call``) vs flax's:
    the pieces above chained, softmax's exp inside."""
    rng = _rng(19)
    x = _bf(rng.normal(size=(2, 40, 32)))
    w_in, w_out = ((rng.normal(size=s) * 32 ** -0.5).astype(np.float32)
                   for s in ((32, 96), (32, 32)))
    mask = np.zeros((2, 40), bool)
    mask[1, 30:] = True
    module = pc.MultiheadSelfAttention(32, 2, dtype=BF16)

    def jax_fn(x, w_in, w_out):
        params = {"in_proj": {"kernel": w_in}, "out_proj": {"kernel": w_out}}
        return jc.MultiheadSelfAttention(32, 2, dtype=jnp.bfloat16).apply(
            {"params": params}, x, jnp.asarray(mask))

    def port_fn(x, w_in, w_out):
        weights = {"in_proj_weight": w_in.t(), "out_proj.weight": w_out.t()}
        return torch.func.functional_call(module, weights, (x, torch.from_numpy(mask)))

    return Case([("x", x, "bf16"), ("in_proj", w_in, "f32"), ("out_proj", w_out, "f32")],
                jax_fn, port_fn, {"fwd": "a*", "dx": "a*", "din_proj": "a*", "dout_proj": "a*"})


def case_ffn():
    """The port's ``TransformerFFNLayer(dtype=bfloat16)`` as a whole vs
    flax's: the conv, the scale, GELU and ``ffn_2`` chained (``ffn_1``'s
    bias gradient, a reduction of an inner cotangent, is read alone in the
    ``ffn_conv`` case)."""
    rng = _rng(20)
    x = _bf(rng.normal(size=(2, 40, 32)))
    k1, b1 = _conv_params(rng, 32, 128, 9)
    k2 = (rng.normal(size=(128, 32)) * 128 ** -0.5).astype(np.float32)
    b2 = rng.normal(size=32).astype(np.float32)
    module = pc.TransformerFFNLayer(32, 128, 9, dropout=0.0, dtype=BF16)

    def jax_fn(x, k1, b1, k2, b2):
        params = {"ffn_1": {"kernel": k1, "bias": b1},
                  "ffn_2": {"Dense_0": {"kernel": k2, "bias": b2}}}
        return jc.TransformerFFNLayer(32, 128, kernel_size=9, dtype=jnp.bfloat16).apply(
            {"params": params}, x)

    def port_fn(x, k1, b1, k2, b2):
        weights = {"ffn_1.weight": k1.permute(2, 1, 0), "ffn_1.bias": b1,
                   "ffn_2.weight": k2.t(), "ffn_2.bias": b2}
        return torch.func.functional_call(module, weights, (x,))

    return Case([("x", x, "bf16"), ("k1", k1, "f32"), ("b1", b1, "f32"), ("k2", k2, "f32"),
                 ("b2", b2, "f32")], jax_fn, port_fn,
                {"fwd": "b-fusion", "dx": "b-fusion", "dk1": "b-fusion", "dk2": "b-fusion",
                 "db2": "b-reduce"}, {"db2": _bias_exact})


def case_ffn_gelu():
    """The FFN's ``x * 9 ** -0.5`` (0.333984375 in bf16) and exact GELU."""
    x = _bf(_rng(13).normal(size=(2, 60, 128)) * 3)
    scale = 9 ** -0.5

    def port_fn(x):
        return pc.gelu(x * pc.weak(scale, x))

    return Case([("x", x, "bf16")], lambda x: jax.nn.gelu(x * scale, approximate=False),
                port_fn, {"fwd": "b-fusion", "dx": "b-fusion"})


def case_layer_norm():
    """flax's ``LayerNorm`` (no dtype) on a bf16 input: promoted to float32
    and normalised there, as the port's ``layer_norm``."""
    rng = _rng(14)
    x = _bf(rng.normal(size=(2, 60, 32)) * 2 + 0.5)
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)

    def jax_fn(x, scale, bias):
        return nn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, x)

    def port_fn(x, scale, bias):  # the port's layer_norm: its LayerNorm on widen(x)
        return torch.nn.functional.layer_norm(pc.widen(x), (32,), scale, bias, pc.LN_EPS)

    return Case([("x", x, "bf16"), ("scale", scale, "f32"), ("bias", bias, "f32")], jax_fn,
                port_fn, {"fwd": "a-f32", "dx": "a-f32", "dscale": "a-f32", "dbias": "a-f32"})


def case_residual_mask():
    """The encoder layer's ``(residual + x) * nonpad``: a float32 residual
    and the bf16 output of attention or the FFN promote to float32."""
    rng = _rng(15)
    res = rng.normal(size=(2, 60, 32)).astype(np.float32)
    x = _bf(rng.normal(size=(2, 60, 32)))
    nonpad = np.ones((2, 60, 1), np.float32)
    nonpad[1, 45:] = 0
    return Case([("residual", res, "f32"), ("x", x, "bf16")],
                lambda r, x: (r + x) * nonpad,
                lambda r, x: (r + x) * torch.from_numpy(nonpad),
                {"fwd": "a", "dresidual": "a", "dx": "a"})


def case_embeddings():
    """The encoder's float32 input: ``sqrt(H) x`` the token embedding plus
    the extra embedding plus the positions (the JAX encoder's ``x + positions``
    with ``pos_embed_alpha`` 1), masked as the blocks mask it (so the pad
    row, which the port's ``padding_idx`` keeps at zero gradient, gets none
    in JAX either)."""
    rng = _rng(16)
    table = rng.normal(size=(12, 32)).astype(np.float32)
    extra = rng.normal(size=(2, 30, 32)).astype(np.float32)
    tokens = rng.integers(1, 12, size=(2, 30))
    tokens[1, 24:] = 0
    positions = pc.sinusoidal_embedding_table(2049, 32)[
        np.asarray(pc.make_positions(torch.from_numpy(tokens != 0)))]

    nonpad = (tokens != 0).astype(np.float32)[:, :, None]

    def jax_fn(table, extra):
        return (32 ** 0.5 * jnp.take(table, tokens, axis=0) + extra + positions) * nonpad

    def port_fn(table, extra):
        emb = torch.nn.functional.embedding(torch.from_numpy(tokens), table, padding_idx=0)
        return (32 ** 0.5 * emb + extra + torch.from_numpy(positions)) * torch.from_numpy(nonpad)

    return Case([("table", table, "f32"), ("extra", extra, "f32")], jax_fn, port_fn,
                {"fwd": "a-f32", "dtable": "a-f32", "dextra": "a-f32"})


def case_q_sample():
    """The diffusion step's ``q_sample`` (float32) at t = [1, 3, 0]."""
    rng = _rng(17)
    x0, noise = (rng.normal(size=(3, 1, 40, 16)).astype(np.float32) for _ in range(2))
    t = np.array([1, 3, 0])
    jd = JaxDiffusion(denoise_fn=nn.Dense(1), out_dims=16, timesteps=4)
    pd = GaussianDiffusion(torch.nn.Identity(), 16, timesteps=4)
    return Case([("x0", x0, "f32"), ("noise", noise, "f32")],
                lambda x0, n: jd.apply({}, x0, jnp.asarray(t), n, method=JaxDiffusion.q_sample),
                lambda x0, n: pd.q_sample(x0, torch.from_numpy(t), n),
                {"fwd": "a-f32", "dx0": "a-f32", "dnoise": "a-f32"})


def case_losses():
    """``spec_loss_prodiff`` with l1 and ssim (the teacher step's
    ``l1:0.5|ssim:0.5``) on a float32 prediction, padding masked."""
    rng = _rng(18)
    pred, gt = (rng.normal(size=(2, 1, 40, 16)).astype(np.float32) for _ in range(2))
    nonpad = np.ones((2, 40), bool)
    nonpad[1, 30:] = False
    kinds = {"l1": 0.5, "ssim": 0.5}

    def jax_fn(pred):
        out = jax_losses.spec_loss_prodiff(pred, jnp.asarray(gt), jnp.asarray(nonpad), kinds)
        return jnp.stack([out["spec_l1"], out["spec_ssim"]])

    def port_fn(pred):
        out = losses.spec_loss_prodiff(pred, torch.from_numpy(gt), torch.from_numpy(nonpad), kinds)
        return torch.stack([out["spec_l1"], out["spec_ssim"]])

    return Case([("pred", pred, "f32")], jax_fn, port_fn, {"fwd": "a-f32", "dpred": "a-f32"})


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


# ---- XLA's bias reduction, for the step tests ------------------------------

class XlaBiasAdd(torch.autograd.Function):
    """``y + bias`` whose bias gradient is XLA's CPU arithmetic: the JAX
    VJP's ``lax.reduce_sum`` of the bf16 cotangent, run by XLA. A stand-in
    for the class-(b) reduction in the port's step, never part of the
    port."""

    @staticmethod
    def forward(ctx, y, bias):
        return y + bias

    @staticmethod
    def backward(ctx, g):
        db = lax.reduce_sum(jnp.asarray(g.float().numpy(), jnp.bfloat16), tuple(range(g.dim() - 1)))
        return g, torch.from_numpy(np.asarray(db, np.float32)).to(g.dtype)


_PORT_LINEAR, _PORT_CONV1D = pc.linear, pc.conv1d


def xla_linear(x, weight, bias=None, dtype=None):
    """The port's ``linear`` with its bf16 bias added by :class:`XlaBiasAdd`."""
    if dtype is None or bias is None:
        return _PORT_LINEAR(x, weight, bias, dtype)
    return XlaBiasAdd.apply(_PORT_LINEAR(x, weight, None, dtype), bias.to(dtype))


def xla_conv1d(x, conv, dtype=None):
    """The port's ``conv1d`` with its bf16 bias added by :class:`XlaBiasAdd`."""
    if dtype is None or conv.bias is None:
        return _PORT_CONV1D(x, conv, dtype)
    plain = SimpleNamespace(weight=conv.weight, bias=None, padding=conv.padding,
                            dilation=conv.dilation)
    return XlaBiasAdd.apply(_PORT_CONV1D(x, plain, dtype), conv.bias.to(dtype))


def mimic_xla_reductions(monkeypatch):
    """Within ``monkeypatch``: every bf16 bias of the port's modules (the
    encoder's and the WaveNet's) takes its gradient from XLA's reduction."""
    for module in (pc, pw):
        monkeypatch.setattr(module, "linear", xla_linear)
        monkeypatch.setattr(module, "conv1d", xla_conv1d)


# ---- the readings ------------------------------------------------------------

def ordered(a: np.ndarray) -> np.ndarray:
    """A bf16 or float32 array's bit patterns as integers in value order,
    in bf16 ulps (a float32 pattern over 2 ** 16)."""
    if a.dtype == np.float32:
        u = a.view(np.uint32).astype(np.int64)
        o = np.where(u < 2 ** 31, u, 2 ** 31 - u)
        return o / 2.0 ** 16
    u = np.asarray(a).view(np.uint16).astype(np.int64)
    return np.where(u < 2 ** 15, u, 2 ** 15 - u).astype(np.float64)


class Reading(NamedTuple):
    equal: float  # share of bit-equal elements
    ulps: float  # the largest distance in bf16 ulps
    peak: float  # max |got - want| / max |want|


def reading(got: np.ndarray, want: np.ndarray) -> Reading:
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    d = np.abs(ordered(got) - ordered(want))
    g64, w64 = got.astype(np.float64), want.astype(np.float64)
    return Reading(float((d == 0).mean()), float(d.max()),
                   float(np.abs(g64 - w64).max() / max(np.abs(w64).max(), 1e-30)))


def _np(a) -> np.ndarray:
    """A result as numpy in its own dtype (bf16 as ml_dtypes' bfloat16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == BF16:
            return np.asarray(jnp.asarray(a.float().numpy(), jnp.bfloat16))
        return a.numpy()
    return np.asarray(a)


@functools.lru_cache(maxsize=None)
def results(name: str):
    """{result: (port, JAX strict, JAX default)} of a case: the forward
    and the VJPs, each as numpy in its own dtype; and the cotangent."""
    case = CASES[name]()
    jargs = [jnp.asarray(a, jnp.bfloat16 if kind == "bf16" else jnp.float32)
             for _, a, kind in case.args]
    out = jax.eval_shape(case.jax_fn, *jargs)
    ct = jnp.asarray(_rng(99).normal(size=out.shape), out.dtype)

    def fwd_vjp(*a):
        y, vjp = jax.vjp(case.jax_fn, *a[:-1])
        return (y,) + vjp(a[-1])

    compiled = jax.jit(fwd_vjp).lower(*jargs, ct)
    strict, default = (compiled.compile(opts)(*jargs, ct) for opts in (STRICT, None))
    targs = [torch.from_numpy(np.array(a, np.float32)).to(
        BF16 if kind == "bf16" else torch.float32).requires_grad_()
        for (_, _, kind), a in zip(case.args, jargs)]
    y = case.port_fn(*targs)
    y.backward(torch.from_numpy(np.array(ct, np.float32)).to(y.dtype))
    port = [y] + [a.grad for a in targs]
    names = ["fwd"] + ["d" + n for n, _, _ in case.args]
    got = {n: (_np(p), _np(s), _np(d)) for n, p, s, d in zip(names, port, strict, default)}
    return case, got, np.asarray(ct, np.float32)


PAIRS = [(name, result) for name, fn in CASES.items() for result in fn().classes]


@pytest.mark.parametrize("name,result", PAIRS, ids=[f"{n}-{r}" for n, r in PAIRS])
def test_bf16_op_matches_jax(name, result):
    """One result of one op, held by its class (the module docstring)."""
    case, got, ct = results(name)
    kind = case.classes[result]
    port, strict, default = got[result]
    assert port.dtype == strict.dtype, (port.dtype, strict.dtype)
    vs_strict, vs_default = reading(port, strict), reading(port, default)
    print(f"{name} {result} [{kind}]: vs strict {vs_strict}, vs default {vs_default}")
    if kind == "b-reduce":
        exact = case.exact[result](ct)
        err = {k: np.abs(a.astype(np.float64) - exact)
               for k, a in (("port", port), ("jax", default))}
        half_ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 8)
        assert (err["port"] <= half_ulp * (1 + 1e-6)).all(), "the port's sum is not rounded once"
        assert err["jax"].max() > err["port"].max(), "JAX's reduction is not the farther one"
        assert reading(strict, default).equal == 1.0  # the same XLA op either way
        bias = torch.zeros(ct.shape[-1], dtype=BF16, requires_grad=True)  # the step tests' stand-in
        XlaBiasAdd.apply(torch.zeros(ct.shape, dtype=BF16), bias).backward(
            torch.from_numpy(ct).to(BF16))
        assert reading(_np(bias.grad).astype(np.float32), default).equal == 1.0
        return
    if kind == "a-f32":
        peak = np.abs(strict.astype(np.float64)).max()
        ulp = 2.0 ** (np.floor(np.log2(max(peak, 1e-30))) - 7)
        assert vs_strict.peak * peak <= ulp, vs_strict
        return
    assert vs_strict.ulps <= MAX_ULPS, vs_strict
    if kind == "a":
        assert vs_strict.equal >= MIN_EQUAL, vs_strict
    if kind == "b-fusion":
        assert vs_strict.equal >= MIN_EQUAL, vs_strict
        assert reading(default, strict).equal < 1.0, "the default compile rounds as written"
