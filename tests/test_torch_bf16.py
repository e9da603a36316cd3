"""The bf16 compute policy of the PyTorch port vs the JAX package, on the CPU.

- The precision modes (``parity``, ``fast``) and the config resolvers of
  ``prodiff_tpu_torch/device.py`` against ``resolve_train_bf16`` of the JAX
  package and the dtype rules of its teacher.
- The encoder layers, ``FastspeechEncoder`` and the linen WaveNet with
  ``dtype=bfloat16`` against the JAX modules with the same dtype (flax's
  semantics: operands and outputs bf16, parameters float32, the attention
  scores, softmax and LayerNorms in float32).
- K1-bf16's plain twin against ``wavenet_apply_pallas`` with bf16-stacked
  weights in interpret mode; K5a/K5b-bf16's twins against the Pallas
  save-forward and chain with ``save_dtype=bfloat16`` (2 layers, one tile),
  and ``ResidualStackFn``'s gradients against the JAX custom VJP's Pallas
  route and ``jax.vjp`` of ``_xla_stack`` with bf16 weights.
- One ``train svs`` and one ``train svs_rectified`` step with ``bf16:
  true``: the loss and every gradient against the JAX task's
  ``jax.value_and_grad`` in bf16, and a bf16-trained checkpoint read by the
  other package both ways.

Tolerances, each against the reference's peak: the kernels' twins 1e-3 of
K1's output (the same rounding points as the Pallas kernel, another sum
order) and 1e-2 of each K5 output and gradient; the modules, the WaveNet and
the training steps' losses 2e-2 (a flip of one bf16 unit is 2^-8 of a
value). A training step's parameter gradients have their own limits, one
for the teacher and one for the student (``TEACHER_STEP_LIMITS``,
``STUDENT_STEP_LIMITS``): each lies between the port's bf16 step, which
meets it, and the port's float32 step on the same batch, which breaks it,
both held to the JAX bf16 step. They are wider than 2e-2 because the two
packages' bf16 gradients differ by up to 4.0e-2 (teacher) and 5.9e-2
(student) of a peak on these batches, against 9.7e-2 and 9.0e-2 for
float32. The gradients of these small seeded models cancel heavily, so a
rounding that lands elsewhere moves them far; the cause of the gap is not
pinned down further (these tests run with XLA's
``--xla_allow_excess_precision=false`` move it by under 1e-3). Against
float32 the bf16 kernel routes stay within the JAX package's own bounds
(``tests/test_pallas_wavenet.py``): atol 5e-3 / rtol 2e-2 for the forward,
atol 0.02 x peak / rtol 0.05 for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (build_optimizer's tree)
import pytest
import torch
from flax import serialization
from jax.experimental.pallas import tpu as pltpu

from prodiff_tpu.models import common as jax_common
from prodiff_tpu.models.encoder import FastspeechEncoder as JaxEncoder
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.models.prodiff import resolve_train_bf16 as jax_resolve_train_bf16
from prodiff_tpu.models.wavenet import WaveNet as JaxWaveNet
from prodiff_tpu.ops import losses as jax_losses
from prodiff_tpu.ops.pallas import wavenet_train as jwt
from prodiff_tpu.ops.pallas.wavenet import stack_wavenet_params, wavenet_apply_pallas
from prodiff_tpu.tasks.svs import SVSRectifiedTask as JaxRectifiedTask
from prodiff_tpu.training.optim import build_optimizer
from prodiff_tpu.utils import ckpt_utils as jax_ckpt
from prodiff_tpu_torch import device
from prodiff_tpu_torch.models import wavenet as wavenet_mod
from prodiff_tpu_torch.models.common import Linear
from prodiff_tpu_torch.models.encoder import FastspeechEncoder
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.wavenet import WaveNet, conv1x1
from prodiff_tpu_torch.ops.wavenet_stack import (
    StackedWaveNet,
    cast_stack,
    residual_stack,
    residual_stack_plain,
)
from prodiff_tpu_torch.ops.wavenet_train import (
    ResidualStackFn,
    residual_stack_chain_plain,
    residual_stack_save_plain,
)
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.tasks.svs import SVSTask
from prodiff_tpu_torch.training.optim import Optimizer
from prodiff_tpu_torch.training.trainer import host_tensors
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import (
    encoder_state_dict,
    load_flax_checkpoint,
    rectified_flax_params,
    rectified_state_dict,
    teacher_flax_params,
    teacher_state_dict,
    wavenet_state_dict,
)
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset
from tests.test_torch_distillation import rect_hp
from tests.test_torch_modules import TEACHER_HP, _jax_teacher, perturb, text_batch
from tests.test_torch_train import LOSS_SPEC, _train_batch
from tests.test_torch_variance_train import jax_draws  # noqa: F401  (a fixture)
from tests.test_torch_wavenet_train import jax_weights, stacked

BF16 = torch.bfloat16
MODULE_TOL = 2e-2  # of the peak: modules, forwards, training steps
K1_TOL = 1e-3  # of the peak: K1-bf16's twin vs the Pallas kernel
K5_TOL = 1e-2  # of each peak: K5-bf16's twins and the Function's gradients
# a training step's parameter gradients vs the JAX step in bf16, each
# parameter's worst element over its peak and its relative L2 distance:
# (limit on the worst element, limit on the relative L2) between the port's
# bf16 step (which must meet both) and its float32 step on the same batch
# (which must break one). Readings on the CPU, worst over the parameters:
#   teacher: bf16 3.98e-2 / 2.43e-2, float32 9.72e-2 / 6.54e-2
#   student: bf16 5.92e-2 / 5.73e-2, float32 8.98e-2 / 7.45e-2
TEACHER_STEP_LIMITS = (5e-2, 4e-2)
STUDENT_STEP_LIMITS = (7.5e-2, 6.5e-2)
T = torch.as_tensor


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def peak_close(got, want, tol, name=""):
    """max |got - want| <= tol x peak |want|; returns the ratio."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-6)
    ratio = float(np.abs(got - want).max()) / peak
    assert np.isfinite(got).all() and ratio <= tol, f"{name}: {ratio:.3e} of the peak > {tol}"
    return ratio


# ---- the modes and the resolvers ------------------------------------------

def test_precision_modes():
    """``fast`` is a mode beside ``parity`` with TF32 off in both; an
    unknown mode (``bf16``) raises; parity is back after."""
    try:
        device.set_precision(device.FAST)
        assert device.precision() == "fast"
        assert device.compute_dtype() == torch.float32
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(NotImplementedError, match="bf16"):
            device.set_precision("bf16")
    finally:
        device.set_precision(device.PARITY)
    assert device.precision() == "parity"


@pytest.mark.parametrize("keys", [{}, {"bf16": None}, {"bf16": True}, {"bf16": False},
                                  {"amp": True}, {"bf16": False, "amp": True}])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_resolve_train_bf16_matches_jax(keys, mode):
    """On the CPU the port resolves as the JAX package does on its CPU, in
    both modes (the returned dict itself where a key decides); on a CUDA
    device ``bf16: null`` is on only in fast mode."""
    hp = dict(TEACHER_HP, **keys)
    want = jax_resolve_train_bf16(hp)
    try:
        device.set_precision(mode)
        got = device.resolve_train_bf16(hp, "cpu")
        assert got == want and (got is hp) == (want is hp)
        card = device.resolve_train_bf16(hp, "cuda")  # a device name: no card needed
        decided = hp.get("bf16") is not None or hp.get("amp", False)
        assert card is hp if decided else card == dict(hp, bf16=mode == "fast")
        on = bool(hp.get("bf16") or hp.get("amp"))
        assert device.module_dtype(got) == (BF16 if on else None)
    finally:
        device.set_precision(device.PARITY)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_teacher_stack_dtype_rules(mode, monkeypatch):
    """The operand dtype a teacher's WaveNet passes to
    ``differentiable_stack`` on the card route, for teachers built as the
    trainer builds them on the card (``resolve_train_bf16(hp, "cuda")``)
    and as a render builds them (``hp`` as it is): in training (grad on)
    the resolved bf16; at inference (grad off) ``pallas_wavenet_dtype`` in
    fast mode, else bf16 only where bf16/amp is true. The card route is
    taken on CPU tensors here (``on_kernels`` patched), where it runs the
    kernels' twins; unpatched, the CPU runs the linen loop in the module's
    dtype and never reaches the stack."""
    fast = mode == "fast"
    seen = []
    real = wavenet_mod.differentiable_stack

    def record(x0, cond, step, w, dtype=torch.float32):
        seen.append(dtype)
        return real(x0, cond, step, w, dtype)

    monkeypatch.setattr(wavenet_mod, "differentiable_stack", record)
    rng = np.random.default_rng(39)
    spec = T(rng.normal(size=(1, 8, 16)).astype(np.float32))
    cond = T(rng.normal(size=(1, 8, 32)).astype(np.float32))
    steps = T(np.array([2]))

    def operand_dtype(hp, train, card=True):
        net = ProDiffTeacher(12, hp).diffusion.denoise_fn
        seen.clear()
        with monkeypatch.context() as m:
            if card:
                m.setattr(wavenet_mod, "on_kernels", lambda x, cycle: cycle == 1)
            with torch.set_grad_enabled(train):
                out = net(spec, steps, cond)
        assert out.dtype == torch.float32 and len(seen) == card
        return seen[0] if card else net.dtype

    try:
        device.set_precision(mode)
        for keys, train_card, infer_card, linen in [
            ({}, BF16 if fast else torch.float32, BF16 if fast else torch.float32, None),
            ({"bf16": False}, torch.float32, BF16 if fast else torch.float32, None),
            ({"bf16": True}, BF16, BF16, BF16),
            ({"amp": True}, BF16, BF16, BF16),
            ({"pallas_wavenet_dtype": "float32"}, BF16 if fast else torch.float32,
             torch.float32, None),
            ({"bf16": True, "pallas_wavenet_dtype": "float32"}, BF16,
             torch.float32 if fast else BF16, BF16),
        ]:
            hp = dict(TEACHER_HP, **{"bf16": None, **keys})
            trained = device.resolve_train_bf16(hp, "cuda")  # a device name: no card needed
            assert operand_dtype(trained, train=True) == train_card, keys
            assert operand_dtype(hp, train=False) == infer_card, keys
            on_cpu = device.resolve_train_bf16(hp, "cpu")
            assert operand_dtype(on_cpu, train=True, card=False) == linen, keys
            assert operand_dtype(hp, train=False, card=False) == linen, keys
        assert device.stream_dtype({}) == BF16
        assert device.stream_dtype({"pallas_wavenet_dtype": "float32"}) == torch.float32
    finally:
        device.set_precision(device.PARITY)


# ---- the modules in bf16 ---------------------------------------------------

@pytest.fixture(scope="module")
def encoder_pair():
    """A JAX ``FastspeechEncoder(dtype=bfloat16)``, perturbed params, and
    the port's encoder with them."""
    rng = np.random.default_rng(40)
    tokens, _ = text_batch(rng)
    extra = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jenc = JaxEncoder(vocab_size=12, hidden_size=32, num_layers=2, dtype=jnp.bfloat16)
    params = perturb(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                        jnp.asarray(extra)))
    enc = FastspeechEncoder(12, 32, 2, dtype=BF16).eval()
    enc.load_state_dict(encoder_state_dict(params["params"], 2, prefix=""))
    return jenc, params, enc, tokens, extra


def test_encoder_layers_bf16_match_jax(encoder_pair):
    """``MultiheadSelfAttention``, ``TransformerFFNLayer`` and ``EncSALayer``
    (layer 0 of the encoder) and ``Linear`` with ``dtype=bfloat16`` vs the
    JAX modules: the same outputs within 2e-2 of the peak and the same
    output dtypes (bf16 out of the attention and the FFN, float32 out of
    the layer, whose LayerNorms and residual sums promote)."""
    _, params, enc, tokens, _ = encoder_pair
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    mask = tokens == 0
    lp = params["params"]["fft_blocks"]["layers_0"]
    layer = enc.layers[0].op
    cases = {
        "self_attn": (jax_common.MultiheadSelfAttention(32, 2, dtype=jnp.bfloat16), lp["self_attn"],
                      (jnp.asarray(x), jnp.asarray(mask)), lambda: layer.self_attn(T(x), T(mask)),
                      BF16),
        "ffn": (jax_common.TransformerFFNLayer(32, 128, kernel_size=9, dtype=jnp.bfloat16), lp["ffn"],
                (jnp.asarray(x),), lambda: layer.ffn(T(x)), BF16),
        "enc_sa_layer": (jax_common.EncSALayer(32, 2, dtype=jnp.bfloat16), lp,
                         (jnp.asarray(x), jnp.asarray(mask)), lambda: layer(T(x), T(mask)),
                         torch.float32),
    }
    with torch.no_grad():
        for name, (jmod, p, args, port, dtype) in cases.items():
            want = jmod.apply({"params": p}, *args)
            got = port()
            assert got.dtype == dtype and want.dtype == jnp.dtype(str(dtype).split(".")[-1]), name
            peak_close(got, want, MODULE_TOL, name)
        jlin = jax_common.Linear(16, dtype=jnp.bfloat16)
        lin_p = perturb(jlin.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed=2)
        lin = Linear(32, 16, dtype=BF16)
        lin.weight.copy_(T(np.asarray(lin_p["params"]["Dense_0"]["kernel"]).T))
        lin.bias.copy_(T(np.asarray(lin_p["params"]["Dense_0"]["bias"])))
        got = lin(T(x))
        assert got.dtype == BF16 and lin.weight.dtype == torch.float32
        peak_close(got, jlin.apply(lin_p, jnp.asarray(x)), MODULE_TOL, "linear")


def test_fastspeech_encoder_bf16_matches_jax(encoder_pair):
    """``FastspeechEncoder(dtype=bfloat16)`` (its ``FFTBlocks`` included) vs
    the JAX encoder: float32 out, within 2e-2 of the peak; the parameters
    stay float32."""
    jenc, params, enc, tokens, extra = encoder_pair
    want = jax.jit(jenc.apply)(params, jnp.asarray(tokens), jnp.asarray(extra))
    with torch.no_grad():
        got = enc(T(tokens), T(extra))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert all(p.dtype == torch.float32 for p in enc.parameters())
    peak_close(got, want, MODULE_TOL, "encoder")


def _wavenet_pair(rng, cycle, dtype):
    jnet = JaxWaveNet(in_dims=16, hidden_size=32, residual_layers=4, residual_channels=128,
                      dilation_cycle_length=cycle, use_pallas=False,
                      dtype=None if dtype is None else jnp.bfloat16)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 32)).astype(np.float32)
    t = np.array([1, 3])
    params = perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(cond)))
    net = WaveNet(16, 32, 4, 128, cycle, dtype=dtype)
    net.load_state_dict(wavenet_state_dict(params["params"], 4, prefix=""))
    return jnet, params, net, x, t, cond


@pytest.mark.parametrize("cycle", [1, 2])
def test_wavenet_linen_bf16_matches_jax(cycle):
    """The port's WaveNet on the CPU (the linen route) with
    ``dtype=bfloat16`` vs ``WaveNet(dtype=bfloat16)`` of the JAX package:
    float32 out, within 2e-2 of the peak."""
    rng = np.random.default_rng(42)
    jnet, params, net, x, t, cond = _wavenet_pair(rng, cycle, BF16)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        got = net(T(x), T(t), T(cond))
    assert got.dtype == torch.float32
    peak_close(got, want, MODULE_TOL, f"wavenet cycle {cycle}")


# ---- the kernels' twins ----------------------------------------------------

def test_k1_bf16_twin_matches_pallas():
    """The card route composed on the CPU (float32 projections, the stack on
    bf16-stacked weights through ``residual_stack``, i.e. K1-bf16's plain
    twin) vs ``wavenet_apply_pallas`` with ``stack_wavenet_params(...,
    stream_dtype=bfloat16)`` in interpret mode: within 1e-3 of the output's
    peak; and within the JAX package's bound (atol 5e-3, rtol 2e-2) of the
    float32 linen module, on the JAX test's own module, inputs and weights
    (``tests/test_pallas_wavenet.py:setup``)."""
    rng = np.random.default_rng(3407)
    jnet = JaxWaveNet(in_dims=16, hidden_size=32, residual_layers=4, residual_channels=128,
                      dilation_cycle_length=1, use_pallas=False)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    t = np.array([1, 3])
    cond = rng.normal(size=(2, 16, 32)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    params = jax.tree.map(lambda a: a if a.ndim == 0 else a + 0.01 * np.random.default_rng(1).normal(
        size=a.shape).astype(np.float32), params)
    net = WaveNet(16, 32, 4, 128, 1)
    net.load_state_dict(wavenet_state_dict(params["params"], 4, prefix=""))
    jw = stack_wavenet_params(params, 4, stream_dtype=jnp.bfloat16)
    with torch.no_grad():
        w = net.stacked_weights(BF16)
    for name in ("dilated_w", "diff_w", "cond_w", "out_w"):
        assert getattr(w, name).dtype == BF16
        np.testing.assert_array_equal(f32(getattr(w, name)), f32(getattr(jw, name)))
    assert w.dilated_b.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        want = wavenet_apply_pallas(jw, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    with torch.no_grad():
        h = torch.relu(conv1x1(T(x), net.input_projection))
        step = net.mlp(net.diffusion_embedding(T(t)))
        h = residual_stack(h, T(cond), step, w)
        got = conv1x1(torch.relu(conv1x1(h, net.skip_projection)), net.output_projection)
    peak_close(got, want, K1_TOL, "K1-bf16 twin vs Pallas")
    linen = jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    np.testing.assert_allclose(f32(got), f32(linen), atol=5e-3, rtol=2e-2)


def test_k5_bf16_twins_match_pallas_kernels():
    """The bf16 save-forward and chain twins vs ``_fwd_save_single`` and
    ``_bwd_chain_single`` with bf16 weights and ``save_dtype=bfloat16`` (2
    layers, one tile: T=16, halo 3): skip, the bf16 saves and dy within
    1e-2 of each one's peak."""
    rng = np.random.default_rng(44)
    n_layers, c, h, t, tile, halo = 2, 128, 32, 16, 16, 3
    w = cast_stack(stacked(rng, n_layers, c, h), BF16)
    x0, cond, g = (rng.normal(size=s).astype(np.float32) for s in ((t, c), (t, h), (t, c)))
    step = rng.normal(size=(c,)).astype(np.float32)
    jw = bf16_jax_weights(cast_stack(w, torch.float32))
    with pltpu.force_tpu_interpret_mode():
        jskip, jxs, jzs = jwt._fwd_save_single(
            jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(step), *jw,
            tile=tile, halo=halo, save_dtype=jnp.bfloat16)
        jdy = jwt._bwd_chain_single(jzs, jnp.asarray(g), jw[0], jw[6], t=t, tile=tile,
                                    halo=halo, save_dtype=jnp.bfloat16)
    skip, xs, zs = residual_stack_save_plain(T(x0)[None], T(cond)[None], T(step)[None], w)
    assert xs.dtype == zs.dtype == BF16
    peak_close(skip[0], jskip, K5_TOL, "skip")
    peak_close(xs[:, 0], jwt._interior(jxs, t, tile, halo), K5_TOL, "xs")
    jzs_i = jwt._interior(jzs, t, tile, halo)
    peak_close(zs[:, 0], jzs_i, K5_TOL, "zs")
    # the chain on the JAX package's own saves
    _, dy, _ = residual_stack_chain_plain(T(f32(jzs_i)).to(BF16)[:, None], T(g)[None], w)
    assert dy.dtype == BF16
    peak_close(dy[:, 0], jwt._interior(jdy, t, tile, halo), K5_TOL, "dy")


def bf16_jax_weights(w):
    """The JAX kernels' weight arguments with the four matrices in bf16
    (``stack_wavenet_params(stream_dtype=bfloat16)``), biases float32."""
    return [a.astype(jnp.bfloat16) if i in (0, 2, 4, 6) else a
            for i, a in enumerate(jax_weights(w))]


def _fn_grads(ins, g, dtype=None):
    ins = [a.clone().requires_grad_() for a in ins]
    out = ResidualStackFn.apply(*ins, *(() if dtype is None else (dtype,)))
    return out.detach(), torch.autograd.grad(out, ins, g)


NAMES = ("x0", "cond", "step") + StackedWaveNet._fields


def test_k5_bf16_function_grads_match_the_pallas_route():
    """``ResidualStackFn`` with bf16 operands (the K5-bf16 twins and the
    bf16 weight gradients) vs the JAX custom VJP's Pallas route with
    bf16-stacked weights and bf16 saves (``residual_stack_train(...,
    train_impl="pallas")``, interpret mode, 2 layers, one tile): the output
    and all 11 gradients within 1e-2 of each one's peak, every gradient
    float32; and within the JAX package's bound (atol 0.02 x peak, rtol
    0.05) of the float32 gradients."""
    rng = np.random.default_rng(45)
    b, t, c, h, n_layers = 1, 16, 128, 32, 2
    w = stacked(rng, n_layers, c, h)
    ins = [T(rng.normal(size=s).astype(np.float32)) for s in ((b, t, c), (b, t, h), (b, c))] + list(w)
    g = T(rng.normal(size=(b, t, c)).astype(np.float32))
    out, grads = _fn_grads(ins, g, BF16)
    assert all(a.dtype == torch.float32 for a in grads)
    jins = [jnp.asarray(f32(a)) for a in ins[:3]] + bf16_jax_weights(w)

    def fn(*args):
        return jwt.residual_stack_train(*args, 16, 3, jnp.bfloat16, "pallas")

    with pltpu.force_tpu_interpret_mode():
        jout, vjp = jax.vjp(fn, *jins)
        jgrads = vjp(jnp.asarray(f32(g)))
    peak_close(out, jout, K5_TOL, "skip")
    _, f32_grads = _fn_grads(ins, g)
    for name, a, jg, ref in zip(NAMES, grads, jgrads, f32_grads):
        peak_close(a, np.asarray(jnp.asarray(jg, jnp.float32)).reshape(a.shape), K5_TOL, name)
        peak = float(ref.abs().max())
        np.testing.assert_allclose(f32(a), f32(ref), atol=0.02 * peak, rtol=0.05, err_msg=name)


def test_k5_bf16_function_grads_match_xla_stack():
    """The same Function at B=3, T=24, L=3 (sequence boundaries, more
    layers) vs ``jax.vjp`` of ``_xla_stack`` with bf16 weights, the JAX
    package's differentiable plain stack: the output and the 11 gradients
    within 1e-2 of each one's peak."""
    rng = np.random.default_rng(46)
    b, t, c, h, n_layers = 3, 24, 64, 32, 3
    w = stacked(rng, n_layers, c, h)
    ins = [T(rng.normal(size=s).astype(np.float32)) for s in ((b, t, c), (b, t, h), (b, c))] + list(w)
    g = T(rng.normal(size=(b, t, c)).astype(np.float32))
    out, grads = _fn_grads(ins, g, BF16)
    jout, vjp = jax.vjp(jwt._xla_stack, *[jnp.asarray(f32(a)) for a in ins[:3]],
                        *bf16_jax_weights(w))
    jgrads = vjp(jnp.asarray(f32(g)))
    peak_close(out, jout, K5_TOL, "skip")
    for name, a, jg in zip(NAMES, grads, jgrads):
        peak_close(a, np.asarray(jnp.asarray(jg, jnp.float32)).reshape(a.shape), K5_TOL, name)


# ---- training steps with bf16: true ----------------------------------------

def grad_errors(model, want) -> dict:
    """{parameter: (max |got - want| / peak |want|, relative L2 distance)},
    every gradient float32."""
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    out = {}
    for n, p in named.items():
        assert p.grad.dtype == torch.float32, n
        got, ref = f32(p.grad), f32(want[n])
        assert np.isfinite(got).all(), n
        peak = max(float(np.abs(ref).max()), 1e-12)
        l2 = float(np.linalg.norm(got - ref)) / max(float(np.linalg.norm(ref)), 1e-12)
        out[n] = (float(np.abs(got - ref).max()) / peak, l2)
    return out


def step_grads_hold(bf16_errs, f32_errs, limits):
    """The bf16 step's gradients within ``limits`` (of each peak at the
    worst element, relative L2); the float32 step on the same batch, held to
    the same bf16 reference, breaks one of the two (so a step that skipped
    the bf16 policy fails them). Returns the worst readings."""
    tol, tol_l2 = limits
    worst = {k: (max(e[0] for e in errs.values()), max(e[1] for e in errs.values()))
             for k, errs in (("bf16", bf16_errs), ("f32", f32_errs))}
    for n, (peak_err, l2) in bf16_errs.items():
        assert peak_err <= tol, f"{n}: {peak_err:.3e} of the peak > {tol}"
        assert l2 <= tol_l2, f"{n}: relative L2 {l2:.3e} > {tol_l2}"
    assert worst["f32"][0] > tol or worst["f32"][1] > tol_l2, worst
    return worst


def test_train_svs_bf16_step_matches_jax(tmp_path):
    """One ``train svs`` step with ``bf16: true``: the teacher's losses and
    every parameter's gradient (float32) vs ``jax.value_and_grad`` of the
    JAX teacher built with the same hparams, the losses within 2e-2 of their
    peak and the gradients as ``step_grads_hold`` holds them at
    ``TEACHER_STEP_LIMITS`` (the port's float32 step on the same batch fails
    there); the checkpoint after one AdamW step loads in the JAX package
    (params and optax state, float32) and a JAX-written one loads in the
    port."""
    _, params, inp = _jax_teacher()
    hp_m = dict(TEACHER_HP, bf16=True)
    jmodel = JaxTeacher(vocab_size=12, hparams=hp_m)
    batch, t, noise = _train_batch(inp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_type = jax_losses.parse_loss_spec(LOSS_SPEC)

    def denoise(m, cond, x0, t, noise):
        return m.diffusion._denoise(m.diffusion.q_sample(x0, t, noise), t, cond, train=True)

    def jloss(p):
        cond = jmodel.apply(p, jb["ph_seq"], jb["mel2ph"], jb["f0"], lang_seq=jb["lang_seq"],
                            spk_embed_id=jb["spk_id"], gender_embed_id=jb["gender_id"],
                            voicing=jb["voicing"], breath=jb["breath"],
                            method=JaxTeacher.forward_condition)
        x0 = jb["mel"][:, None]
        pred = jmodel.apply(p, cond, x0, jnp.asarray(t), jnp.asarray(noise), method=denoise)
        losses = jax_losses.spec_loss_prodiff(pred, x0, jb["mel2ph"] > 0, loss_type, name="mel")
        return sum(losses.values()), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    want = teacher_state_dict(jax.tree.map(np.asarray, jgrads), TEACHER_HP)
    errs = {}
    for bf16 in (True, False):
        hp = dict(TEACHER_HP, bf16=bf16, data_dir=str(tmp_path), task="svs", max_tokens=1000,
                  max_sentences=4, mel_loss=LOSS_SPEC, lr=1e-3, warmup_updates=10)
        model = ProDiffTeacher(12, hp)
        model.load_state_dict(teacher_state_dict(params, TEACHER_HP))
        model.eval()  # dropout off, as the JAX apply's default
        assert all(p.dtype == torch.float32 for p in model.parameters())
        losses = SVSTask(hp).compute_losses(model, host_tensors(batch, pin=False), t=T(t),
                                            noise=T(noise))
        sum(losses.values()).backward()
        errs[bf16] = grad_errors(model, want)
        if bf16:
            assert model.encoder.dtype == model.diffusion.denoise_fn.dtype == BF16
            assert set(losses) == set(jlosses)
            for k in losses:
                peak_close(losses[k], jlosses[k], MODULE_TOL, k)
            bf16_model, bf16_hp = model, hp
    step_grads_hold(errs[True], errs[False], TEACHER_STEP_LIMITS)
    model, hp = bf16_model, bf16_hp

    # the bf16-trained checkpoint, both ways
    opt = Optimizer(model.named_parameters(), hp,
                    carrier=(lambda sd: teacher_flax_params(sd, TEACHER_HP),
                             lambda tree: teacher_state_dict(tree, TEACHER_HP)))
    opt.step()
    payload = {"global_step": 1, "epoch": 0, "checkpoint_callback_best": float("inf"),
               "state_dict": teacher_flax_params(model.state_dict(), TEACHER_HP),
               "optimizer_state": opt.state_dict()}
    path = ckpt_utils.save_checkpoint(str(tmp_path / "port"), 1, payload)
    read = jax_ckpt.load_checkpoint_file(path)
    jparams = serialization.from_state_dict(params, read["state_dict"])
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(jparams))
    jopt = serialization.from_state_dict(build_optimizer(hp).init(params["params"]),
                                         read["optimizer_state"])
    assert int(jopt[0][0].count) == 1
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(jopt[0][0].mu))
    for k, v in teacher_state_dict(jax.tree.map(np.asarray, jparams), TEACHER_HP).items():
        torch.testing.assert_close(T(v), model.state_dict()[k], atol=0, rtol=0)
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 1, {"global_step": 1,
                                                                 "state_dict": jparams})
    back = ProDiffTeacher(12, hp_m)
    back.load_state_dict(teacher_state_dict(load_flax_checkpoint(jpath)["state_dict"], TEACHER_HP))
    for k, v in back.state_dict().items():
        assert v.dtype == model.state_dict()[k].dtype
        torch.testing.assert_close(v, model.state_dict()[k], atol=0, rtol=0)


def test_train_svs_rectified_bf16_step_matches_jax(tmp_path, jax_draws):
    """One ``train svs_rectified`` step with ``bf16: true``: the student
    (built by the task through ``resolve_train_bf16``) and the JAX task's
    ``compute_losses`` under ``jax.value_and_grad``: the losses within 2e-2
    of their peak, the gradients as ``step_grads_hold`` holds them at
    ``STUDENT_STEP_LIMITS`` (the port's float32 student on the same batch
    fails there)."""
    make_svs_dataset(str(tmp_path), task="svs_rectified", rectified=True, n_train=6, n_valid=2)
    hp = rect_hp(tmp_path, "prodiff", bf16=True)
    task = get_task_cls("svs_rectified")(hp)
    torch.manual_seed(3)
    model = task.build_model()
    assert model.denoise_fn.dtype == BF16
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    ds = task.train_iterator().dataset
    batch = ds.collater([ds[i] for i in range(3)])
    batch.pop("nsamples")
    t = np.array([1, 0, 1])
    b = batch["x_0"].shape[0]
    taken = jax_draws(t, np.zeros((b, 1, *batch["x_0"].shape[1:]), np.float32))
    jtask = JaxRectifiedTask(hp)
    jtask.build_model()
    params = rectified_flax_params(model.state_dict(), hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        losses = jtask.compute_losses(p, jb, jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    (jtotal, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    assert taken["t"] == 1
    want = rectified_state_dict(jax.tree.map(np.asarray, jgrads), hp)
    model.train()
    losses = task.compute_losses(model, host_tensors(batch, pin=False), t=T(t))
    total = sum(losses.values())
    total.backward()
    for k in losses:
        peak_close(losses[k], jlosses[k], MODULE_TOL, k)
    peak_close(total, jtotal, MODULE_TOL, "total")
    f32_task = get_task_cls("svs_rectified")(dict(hp, bf16=False))
    f32_model = f32_task.build_model()
    assert f32_model.denoise_fn.dtype is None
    f32_model.load_state_dict(model.state_dict())
    f32_model.train()
    sum(f32_task.compute_losses(f32_model, host_tensors(batch, pin=False), t=T(t)).values()).backward()
    step_grads_hold(grad_errors(model, want), grad_errors(f32_model, want), STUDENT_STEP_LIMITS)
