"""K5, the trainable WaveNet stack: the port vs the JAX package, on the CPU.

- The plain twins of the save-forward and the backward chain vs the Pallas
  ``_fwd_save_single`` / ``_bwd_chain_single`` in interpret mode, compared
  on the windows' interiors (tile 8, halo 5, float32 saves).
- The 11 gradients of ``ResidualStackFn`` (the plain route on the CPU) vs
  ``jax.vjp`` of ``_xla_stack`` and vs torch autograd through
  ``residual_stack_plain``; ``gradcheck`` of the Function in float64.
- The routing: K1's wrapper refuses an operand that requires grad, and the
  WaveNet's stacked weights are differentiable under grad mode.

Tolerance: atol 2e-4 / rtol 1e-3 for activations (float32 both sides, other
sum orders); gradients at 1e-4 of each one's peak (rtol 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from prodiff_tpu.ops.pallas import wavenet_train as jwt
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops.wavenet_stack import StackedWaveNet, residual_stack, residual_stack_plain
from prodiff_tpu_torch.ops.wavenet_train import (
    ResidualStackFn,
    differentiable_stack,
    residual_stack_chain_plain,
    residual_stack_save_plain,
)

ATOL, RTOL = 2e-4, 1e-3


def stacked(rng, n_layers, c, h, dtype=torch.float32, requires_grad=False):
    def r(*shape, scale):
        t = torch.tensor(rng.normal(size=shape) * scale, dtype=dtype)
        return t.requires_grad_(requires_grad)

    return StackedWaveNet(
        dilated_w=r(n_layers, 3, c, 2 * c, scale=(3 * c) ** -0.5),
        dilated_b=r(n_layers, 2 * c, scale=0.1),
        diff_w=r(n_layers, c, c, scale=c ** -0.5),
        diff_b=r(n_layers, c, scale=0.1),
        cond_w=r(n_layers, h, 2 * c, scale=h ** -0.5),
        cond_b=r(n_layers, 2 * c, scale=0.1),
        out_w=r(n_layers, c, 2 * c, scale=c ** -0.5),
        out_b=r(n_layers, 2 * c, scale=0.1),
    )


def jax_weights(w: StackedWaveNet):
    """The JAX kernels' argument order and layout (biases [L, 1, dim])."""
    a = [jnp.asarray(t.detach().numpy()) for t in w]
    return [a[0], a[1][:, None], a[2], a[3][:, None], a[4], a[5][:, None], a[6], a[7][:, None]]


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def grad_close(got, want, name):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4 * peak, rtol=1e-3, err_msg=name)


def test_plain_twins_match_pallas_kernels():
    """xs, zs and the chain's dy vs the Pallas save/chain kernels (L=3,
    C=128, H=32, T=16 over two tiles of 8 with halo 5)."""
    rng = np.random.default_rng(0)
    n_layers, c, h, t, tile, halo = 3, 128, 32, 16, 8, 5
    w = stacked(rng, n_layers, c, h)
    x0, cond, g = (rng.normal(size=s).astype(np.float32) for s in ((t, c), (t, h), (t, c)))
    step = rng.normal(size=(c,)).astype(np.float32)
    jw = jax_weights(w)
    with pltpu.force_tpu_interpret_mode():
        jskip, jxs, jzs = jwt._fwd_save_single(
            jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(step), *jw,
            tile=tile, halo=halo, save_dtype=jnp.float32)
        jdy = jwt._bwd_chain_single(jzs, jnp.asarray(g), jw[0], jw[6], t=t, tile=tile,
                                    halo=halo, save_dtype=jnp.float32)
    skip, xs, zs = residual_stack_save_plain(torch.from_numpy(x0)[None], torch.from_numpy(cond)[None],
                                             torch.from_numpy(step)[None], w)
    close(skip[0], jskip)
    close(xs[:, 0], jwt._interior(jxs, t, tile, halo))
    close(zs[:, 0], jwt._interior(jzs, t, tile, halo))
    _, dy, _ = residual_stack_chain_plain(zs, torch.from_numpy(g)[None], w)
    close(dy[:, 0], jwt._interior(jdy, t, tile, halo))


def test_function_grads_match_jax_and_autograd():
    """ResidualStackFn's 11 gradients (B=3 so the conv taps' sequence
    boundaries count) vs jax.vjp of the plain-XLA stack and vs torch
    autograd through the plain stack."""
    rng = np.random.default_rng(1)
    b, t, c, h, n_layers = 3, 16, 32, 16, 3
    w = stacked(rng, n_layers, c, h, requires_grad=True)
    x0, cond, g = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                   for s in ((b, t, c), (b, t, h), (b, t, c)))
    step = torch.tensor(rng.normal(size=(b, c)), dtype=torch.float32)
    ins = [a.requires_grad_() for a in (x0, cond, step)] + list(w)
    out = ResidualStackFn.apply(*ins)
    got = torch.autograd.grad(out, ins, g)
    ref = torch.autograd.grad(residual_stack_plain(ins[0], ins[1], ins[2], w), ins, g)
    jins = [jnp.asarray(a.detach().numpy()) for a in ins[:3]] + jax_weights(w)
    jout, vjp = jax.vjp(jwt._xla_stack, *jins)
    jgrads = vjp(jnp.asarray(g.numpy()))
    close(out.detach(), jout)
    names = ("x0", "cond", "step") + StackedWaveNet._fields
    for name, a, r, jg in zip(names, got, ref, jgrads):
        grad_close(a, r.detach(), f"{name} vs autograd")
        grad_close(a, np.asarray(jg).reshape(a.shape), f"{name} vs jax")


def test_function_gradcheck_float64():
    rng = np.random.default_rng(2)
    w = stacked(rng, 2, 3, 2, dtype=torch.float64, requires_grad=True)
    x0, cond, step = (torch.tensor(rng.normal(size=s), dtype=torch.float64, requires_grad=True)
                      for s in ((2, 4, 3), (2, 4, 2), (2, 3)))
    assert torch.autograd.gradcheck(ResidualStackFn.apply, (x0, cond, step, *w))


def test_k1_refuses_an_operand_that_requires_grad():
    """K1's wrapper has no backward: with grad mode on, a trainable operand
    raises instead of silently cutting the graph; without grad it runs."""
    rng = np.random.default_rng(3)
    w = stacked(rng, 2, 32, 32, requires_grad=True)
    x0, cond = torch.randn(1, 5, 32), torch.randn(1, 5, 32)
    step = torch.randn(1, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        residual_stack(x0, cond, step, w)
    with torch.no_grad():
        want = residual_stack(x0, cond, step, w)
    out = differentiable_stack(x0, cond, step, w)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "ResidualStackFnBackward"
    torch.testing.assert_close(out.detach(), want)
    with torch.no_grad():
        assert differentiable_stack(x0, cond, step, w).grad_fn is None


def test_wavenet_stacked_weights_follow_grad_mode():
    """Under grad mode the stack is rebuilt and carries the graph to every
    residual layer; under no_grad it is cached and rebuilt after a change."""
    torch.manual_seed(0)
    net = WaveNet(16, 32, residual_layers=3, residual_channels=32)
    w = net.stacked_weights()
    assert all(a.grad_fn is not None for a in w)
    (w.dilated_w.sum() + w.cond_w.sum()).backward()
    for layer in net.residual_layers:
        assert layer.dilated_conv.weight.grad is not None
        assert layer.conditioner_projection.weight.grad is not None
    with torch.no_grad():
        cached = net.stacked_weights()
        assert net.stacked_weights() is cached
        net.residual_layers[1].dilated_conv.weight.add_(1.0)
        fresh = net.stacked_weights()
    assert fresh is not cached and all(a.grad_fn is None for a in fresh)
    torch.testing.assert_close(fresh.dilated_w[1], cached.dilated_w[1] + 1.0)
