"""K7, a whole FastDiff LVC block in one launch, in the PyTorch port vs the
JAX package, on the CPU.

The plain twin of ``ops/ublock.py:ublock_block`` (the chain of the block's
layers, each layer's windows read in place from a hoisted stack) is held
against the Pallas ``ublock_block_packed`` in interpret mode, and the port's
FastDiff with ``MONO_BLOCK`` set against its layer route and against the JAX
``_packed_forward`` with ``_MONO_BLOCK`` set. Inputs are made with numpy from
a seed. Tolerances are the JAX package's own for the same functions
(``tests/test_fastdiff_packed.py::test_mono_block_forward_matches``: atol
2e-5 against the layer route, 7e-5 against linen), and 2e-5 for the block
itself; both sides are float32 and only the order of the sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prodiff_tpu.models.fastdiff as jax_fastdiff
import prodiff_tpu_torch.models.fastdiff as port_fastdiff
from prodiff_tpu.models.fastdiff import FastDiff as JaxFastDiff
from prodiff_tpu.models.fastdiff import fastdiff_step_kernels as jax_step_kernels
from prodiff_tpu.models.fastdiff import sampling_given_noise_schedule as jax_sampling
from prodiff_tpu.ops.packed import pack, unpack
from prodiff_tpu.ops.pallas.ublock import mono_block_supported as jax_mono_supported
from prodiff_tpu.ops.pallas.ublock import ublock_block_packed
from prodiff_tpu_torch.models.fastdiff import FastDiff, fastdiff_step_kernels, tap_major_state_dict
from prodiff_tpu_torch.models.fastdiff import sampling_given_noise_schedule
from prodiff_tpu_torch.ops.ublock import (
    MAX_SMEM,
    layer_plan,
    mono_block_supported,
    ublock_block,
    ublock_block_plain,
    ublock_layer,
)
from prodiff_tpu_torch.utils.convert import fastdiff_state_dict
from tests.test_torch_fastdiff import CFG, _python_scan, _schedule

RNG = np.random.default_rng(31)
C = 32
DILATIONS = [1, 3, 9, 27]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _block_inputs(b, n_win, hop, n_steps):
    t = n_win * hop
    x = RNG.normal(size=(b, t, C)).astype(np.float32)
    ad = RNG.normal(size=(b, t, C)).astype(np.float32)
    cks = RNG.normal(size=(4, 3, C, C)).astype(np.float32) * 0.2  # JAX WIO per layer
    cbs = RNG.normal(size=(4, C)).astype(np.float32) * 0.1
    km = RNG.normal(size=(n_steps, b, n_win, 4 * 3 * C, 2 * C)).astype(np.float32) * 0.1
    lb = RNG.normal(size=(n_steps, b, n_win, 4 * 2 * C)).astype(np.float32) * 0.1
    return x, ad, cks, cbs, km, lb


def _jax_block(x, ad, cks, cbs, km, lb, hop, step):
    kms = [jnp.asarray(km[step, :, :, i * 3 * C:(i + 1) * 3 * C]) for i in range(4)]
    lbs = [jnp.asarray(lb[step, :, :, i * 2 * C:(i + 1) * 2 * C]) for i in range(4)]
    out = ublock_block_packed(pack(jnp.asarray(x), 4), pack(jnp.asarray(ad), 4),
                              [jnp.asarray(k) for k in cks], [jnp.asarray(c) for c in cbs],
                              kms, lbs, DILATIONS, hop, interpret=True)
    return np.asarray(unpack(out, C))


@pytest.mark.parametrize("hop,n_win,n_steps,step", [
    (256, 16, 1, 0),   # block 2's hop (tests/test_pallas_ublock.py's shape)
    (64, 48, 1, 0),    # block 1's hop
    (256, 4, 3, 2),    # every JAX block's window buffer is clamped at both ends; step 2 of 3
    (64, 48, 3, 1),    # step 1 of a 3-step stack
])
def test_block_plain_matches_pallas(hop, n_win, n_steps, step):
    assert jax_mono_supported(n_win, hop, 4) and mono_block_supported(hop, DILATIONS)
    x, ad, cks, cbs, km, lb = _block_inputs(2, n_win, hop, n_steps)
    want = _jax_block(x, ad, cks, cbs, km, lb, hop, step)
    conv_ws = [_t(ck.transpose(2, 1, 0)) for ck in cks]  # WIO -> torch [Cout, Cin, 3]
    before = ublock_block.launches.count
    got = ublock_block(_t(x), _t(ad), conv_ws, [_t(c) for c in cbs], _t(km), _t(lb),
                       DILATIONS, hop, step)
    assert ublock_block.launches.count == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the twin is the chain of the layer twins, bit for bit
    chain = _t(x)
    for i, (w, d) in enumerate(zip(conv_ws, DILATIONS)):
        chain = ublock_layer(chain, _t(ad), w, _t(cbs[i]), _t(km), _t(lb), d, hop, step, i)
    torch.testing.assert_close(got, chain, rtol=0, atol=0)


def test_one_window_block_on_the_plain_twin():
    """A one-window sequence (both ends in the block the kernel runs) through
    the twin equals the layer-by-layer reference the JAX package's linen path
    computes for one layer at a time."""
    hop = 64
    x, ad, cks, cbs, km, lb = _block_inputs(1, 1, hop, 1)
    conv_ws = [_t(ck.transpose(2, 1, 0)) for ck in cks]
    got = ublock_block_plain(_t(x), _t(ad), conv_ws, [_t(c) for c in cbs], _t(km), _t(lb),
                             DILATIONS, hop, 0)
    want = _t(x)
    for i in range(4):
        want = ublock_layer(want, _t(ad), conv_ws[i], _t(cbs[i]), _t(km), _t(lb), DILATIONS[i],
                            hop, 0, i)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == (1, hop, C) and torch.isfinite(got).all()


def test_mono_gate_and_margins():
    """The gate admits the LJSpeech net's audio-rate blocks (hops 64, 256),
    not block 0 (hop 8); the kernel's shared memory per block (one 256-row
    unit: its windows, the conv weight, x + audio_down with the largest
    dilation's halo, y). With no halo recomputed, a hop of 512 and a fifth
    layer of dilation 81 fit; a halo past 227 KB or a ninth layer does not."""
    assert [mono_block_supported(h, DILATIONS) for h in (8, 16, 32, 64, 96, 256)] == \
        [False, False, False, True, True, True]
    assert mono_block_supported(512, DILATIONS)
    assert mono_block_supported(64, [1, 3, 9, 27, 81])
    assert not mono_block_supported(64, [1, 3, 9, 27, 243])  # 240,768 bytes
    assert not mono_block_supported(256, [1] * 9)
    assert layer_plan(256, 27)["smem"] == 110976  # two blocks an SM
    assert layer_plan(64, 27)["smem"] == 185472
    assert layer_plan(64, 243)["smem"] > MAX_SMEM
    # the JAX route's blocks at the LJSpeech config (T_mel = 512, P = 4)
    for hop in (64, 256):
        assert jax_mono_supported(512, hop, 4)


def test_block_wrapper_rejects_what_the_kernel_does_not_take():
    x, ad, cks, cbs, km, lb = _block_inputs(1, 2, 64, 1)
    args = (_t(x), _t(ad), [_t(ck.transpose(2, 1, 0)) for ck in cks], [_t(c) for c in cbs],
            _t(km), _t(lb), DILATIONS, 64, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ublock_block(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))


def _nets():
    jnet = JaxFastDiff(cond_channels=16, use_packed=False)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16 * 256, 1)),
                                jnp.zeros((1, 16, 16)), jnp.zeros((1, 1)))
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.05 if a.ndim == 1 else a,
        params)
    net = FastDiff.from_config(CFG).eval()
    net.load_state_dict(tap_major_state_dict(fastdiff_state_dict(params, CFG), CFG))
    return params, net


def test_mono_forward_matches_layer_route_and_jax(monkeypatch):
    """The port's forward with ``MONO_BLOCK`` vs its layer route (atol 2e-5)
    and vs the JAX ``_packed_forward`` with ``_MONO_BLOCK`` (atol 7e-5), at
    the shapes of ``tests/test_fastdiff_packed.py``'s mono test (B=2, L=16;
    the blocks at hops 64 and 256 take K7 in both packages)."""
    params, net = _nets()
    b, n_win = 2, 16
    t = n_win * 256
    audio = RNG.normal(size=(b, t, 1)).astype(np.float32)
    cond = RNG.normal(size=(b, n_win, 16)).astype(np.float32)
    steps = np.full((b, 1), 2.5, np.float32)
    calls = []
    monkeypatch.setattr(port_fastdiff, "ublock_block",
                        lambda *a: calls.append(a[7]) or ublock_block(*a))
    with torch.no_grad():
        layer = net(_t(audio), _t(cond), _t(steps)).numpy()
        monkeypatch.setattr(port_fastdiff, "MONO_BLOCK", True)
        mono = net(_t(audio), _t(cond), _t(steps)).numpy()
    assert calls == [64, 256]  # block 0 (hop 8) keeps the layer route
    monkeypatch.setattr(jax_fastdiff, "_MONO_BLOCK", True)
    want = np.asarray(JaxFastDiff(cond_channels=16, use_packed=True).apply(
        params, *(jnp.asarray(a) for a in (audio, cond, steps))))
    assert mono.shape == want.shape == (b, t, 1)
    np.testing.assert_allclose(mono, layer, atol=2e-5)
    np.testing.assert_allclose(mono, want, atol=7e-5)


def test_mono_hoisted_sampling_matches_jax(monkeypatch):
    """The hoisted 4-step sampler with ``MONO_BLOCK`` (K7 reading each step's
    windows in place) vs the JAX sampler with ``_MONO_BLOCK`` on its packed
    trunk, on injected noise; the JAX ``lax.scan`` runs as its Python loop,
    as in ``tests/test_torch_fastdiff.py``. Init params (zero biases), L=16."""
    jnet = JaxFastDiff(cond_channels=16, use_packed=True)
    n_win = 16
    t = n_win * 256
    params = jax.jit(JaxFastDiff(cond_channels=16, use_packed=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, t, 1)), jnp.zeros((1, n_win, 16)), jnp.zeros((1, 1)))
    net = FastDiff.from_config(CFG).eval()
    net.load_state_dict(tap_major_state_dict(fastdiff_state_dict(params, CFG), CFG))
    bi, ai, si, steps = _schedule()
    cond = RNG.normal(size=(1, n_win, 16)).astype(np.float32)
    init = RNG.normal(size=(1, t, 1)).astype(np.float32)
    step_n = RNG.normal(size=(len(steps), 1, t, 1)).astype(np.float32)
    monkeypatch.setattr(jax_fastdiff, "_MONO_BLOCK", True)
    monkeypatch.setattr(port_fastdiff, "MONO_BLOCK", True)
    kp_jax = jax_step_kernels(jnet, params, jnp.asarray(cond), jnp.asarray(steps, jnp.float32))
    monkeypatch.setattr(jax.lax, "scan", _python_scan)
    want = np.asarray(jax_sampling(
        jax.jit(lambda p, x, c, tt, k: jnet.apply(p, x, c, tt, kp_out=k)),
        params, jax.random.PRNGKey(1), t, jnp.asarray(cond), bi, ai, si, steps,
        init_noise=jnp.asarray(init), step_noises=jnp.asarray(step_n), kp_all=kp_jax,
    ))
    kp = fastdiff_step_kernels(net, _t(cond), _t(steps))
    got = sampling_given_noise_schedule(net, _t(cond), t, bi, ai, si, steps,
                                        init_noise=_t(init), step_noises=_t(step_n), kp_all=kp)
    assert got.shape == want.shape == (1, t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
