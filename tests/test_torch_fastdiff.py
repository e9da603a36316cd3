"""The FastDiff vocoder in the PyTorch port vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; weights
are the JAX params carried over by ``fastdiff_state_dict``; the diffusion
noise is injected into both. Where the JAX function reaches a Pallas kernel
(``ublock_layer_packed``, ``lvc_pallas``, the packed trunk) it runs in
interpret mode, as the JAX package's own tests run it. Tolerances are those
of the JAX package's tests of the same functions: the fused layer atol 3e-5
(``tests/test_pallas_ublock.py``), the LVC atol 2e-4 / rtol 1e-3
(``tests/test_pallas_lvc.py``), the forward atol 5e-5 and the hoisted 4-step
sampler atol 1e-4 (``tests/test_fastdiff_packed.py``). Both sides are
float32; only the order of the sums differs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from prodiff_tpu.models.fastdiff import FastDiff as JaxFastDiff
from prodiff_tpu.models.fastdiff import convert_fastdiff
from prodiff_tpu.models.fastdiff import fastdiff_step_kernels as jax_step_kernels
from prodiff_tpu.models.fastdiff import location_variable_convolution
from prodiff_tpu.models.fastdiff import prepare_inference_schedule as jax_schedule
from prodiff_tpu.models.fastdiff import sampling_given_noise_schedule as jax_sampling
from prodiff_tpu.ops.packed import pack, unpack
from prodiff_tpu.ops.pallas.ublock import ublock_layer_packed
from prodiff_tpu.vocoders.fastdiff import NOISE_SCHEDULES as JAX_SCHEDULES
from prodiff_tpu_torch.models.fastdiff import (
    FastDiff,
    compute_hyperparams_given_schedule,
    fastdiff_step_kernels,
    prepare_inference_schedule,
    sampling_given_noise_schedule,
    tap_major_state_dict,
)
from prodiff_tpu_torch.ops.lvc import (HOP_RULE, LAYER_HOP_RULE, lvc, lvc_matmul,
                                      on_kernels)
from prodiff_tpu_torch.ops.ublock import ublock_layer
from prodiff_tpu_torch.utils.convert import fastdiff_state_dict
from prodiff_tpu_torch.vocoders import get_vocoder_cls
from prodiff_tpu_torch.vocoders.fastdiff import NOISE_SCHEDULES
from tests.test_torch_convert import assert_trees_equal

RNG = np.random.default_rng(21)
# the JAX FastDiff defaults (FastDiff's LJSpeech shape) at 16 mel channels
CFG = {
    "audio_channels": 1, "inner_channels": 32, "cond_channels": 16,
    "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 4, "lvc_kernel_size": 3,
    "kpnet_hidden_channels": 64, "kpnet_conv_size": 3, "diffusion_step_embed_dim_in": 128,
    "diffusion_step_embed_dim_mid": 512, "diffusion_step_embed_dim_out": 512,
    "beta_0": 1e-6, "beta_T": 0.01, "T": 1000,
}
L, HOP = 4, 256


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _layer_inputs(b, t, n_win, scale_k=0.1):
    c = 32
    x = RNG.normal(size=(b, t, c)).astype(np.float32)
    ad = RNG.normal(size=(b, t, c)).astype(np.float32)
    ck = RNG.normal(size=(3, c, c)).astype(np.float32) * 0.2  # JAX WIO [3, Cin, Cout]
    cb = RNG.normal(size=(c,)).astype(np.float32) * 0.1
    km = RNG.normal(size=(b, n_win, 3 * c, 2 * c)).astype(np.float32) * scale_k
    lb = RNG.normal(size=(b, n_win, 2 * c)).astype(np.float32) * 0.1
    return x, ad, ck, cb, km, lb


def _jax_layer(x, ad, ck, cb, km, lb, dilation, hop, **kw):
    out = ublock_layer_packed(pack(jnp.asarray(x), 4), pack(jnp.asarray(ad), 4), jnp.asarray(ck),
                              jnp.asarray(cb), jnp.asarray(km), jnp.asarray(lb), dilation, hop,
                              interpret=True, **kw)
    return np.asarray(unpack(out, x.shape[-1]))


@pytest.mark.parametrize("hop,dilation,n_win", [
    (256, 1, 4),    # final-block scale
    (256, 27, 4),   # max dilation halo
    (64, 3, 8),     # middle block
    (8, 9, 32),     # first block: the dilation-9 halo spans windows
    (256, 9, 1),    # one window: both sequence ends in one window
])
def test_ublock_layer_matches_pallas(hop, dilation, n_win):
    x, ad, ck, cb, km, lb = _layer_inputs(2, n_win * hop, n_win)
    want = _jax_layer(x, ad, ck, cb, km, lb, dilation, hop)
    before = ublock_layer.launches.count
    got = ublock_layer(_t(x), _t(ad), _t(ck.transpose(2, 1, 0)), _t(cb), _t(km), _t(lb),
                       dilation, hop)
    assert ublock_layer.launches.count == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_ublock_layer_stepped_read_matches_pallas():
    """Step 2, layer 1 of a hoisted stack [3, B, L, 4*96, 64], read in place."""
    n, b, n_win, hop, c = 3, 2, 8, 64, 32
    x, ad, ck, cb, _, _ = _layer_inputs(b, n_win * hop, n_win)
    km = RNG.normal(size=(n, b, n_win, 4 * 3 * c, 2 * c)).astype(np.float32) * 0.1
    lb = RNG.normal(size=(n, b, n_win, 4 * 2 * c)).astype(np.float32) * 0.1
    want = _jax_layer(x, ad, ck, cb, km, lb[..., 2 * c: 4 * c], 3, hop, step_idx=2, layer_idx=1)
    got = ublock_layer(_t(x), _t(ad), _t(ck.transpose(2, 1, 0)), _t(cb), _t(km), _t(lb), 3, hop,
                       step_idx=2, layer_idx=1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


@pytest.mark.parametrize("hop,n_win", [(64, 8), (256, 4), (64, 6), (256, 1),
                                       (24, 7), (72, 30)])
def test_lvc_matches_pallas(hop, n_win):
    """Hops 24 and 72 lie outside K4's contract but inside lvc_pallas's (and
    K6's); at hop 72 and L = 30, lvc_pallas's windows a grid step shrink from
    28 to 15."""
    b, c = 2, 32
    x = RNG.normal(size=(b, n_win * hop, c)).astype(np.float32)
    km = RNG.normal(size=(b, n_win, 3 * c, 2 * c)).astype(np.float32) * 0.1
    lb = RNG.normal(size=(b, n_win, 2 * c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(location_variable_convolution(
            jnp.asarray(x), jnp.asarray(km), jnp.asarray(lb), hop, use_pallas=True))
    got = lvc(_t(x), _t(km), _t(lb), hop)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    # the same windows read in place as (step 1, layer 2) of a stack
    stack = np.zeros((2, b, n_win, 4 * 3 * c, 2 * c), np.float32)
    stack[1, :, :, 2 * 3 * c: 3 * 3 * c] = km
    bstack = np.zeros((2, b, n_win, 4 * 2 * c), np.float32)
    bstack[1, :, :, 2 * 2 * c: 3 * 2 * c] = lb
    stepped = lvc(_t(x), _t(stack), _t(bstack), hop, step_idx=1, layer_idx=2)
    torch.testing.assert_close(stepped, got, rtol=0, atol=0)


@functools.lru_cache(maxsize=2)
def _nets(perturb_biases=True):
    """JAX FastDiff params (seeded init; with ``perturb_biases`` no bias is
    zero) and the port's FastDiff carrying them, fused and unfused."""
    jnet = JaxFastDiff(cond_channels=16, use_packed=False)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, L * HOP, 1)),
                                jnp.zeros((1, L, 16)), jnp.zeros((1, 1)))
    if perturb_biases:
        rng = np.random.default_rng(5)
        params = jax.tree.map(
            lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.05 if a.ndim == 1 else a,
            params)
    sd = tap_major_state_dict(fastdiff_state_dict(params, CFG), CFG)
    nets = {}
    for fused in (True, False):
        nets[fused] = FastDiff.from_config(CFG, fused_layer=fused).eval()
        nets[fused].load_state_dict(sd)
    return params, nets


def test_weights_round_trip():
    """``fastdiff_state_dict`` inverts ``convert_fastdiff`` exactly, and every
    carried name is a parameter of the port's FastDiff."""
    params, nets = _nets()
    ref_sd = fastdiff_state_dict(params, CFG)
    back = convert_fastdiff({k: v.numpy() for k, v in ref_sd.items()}, CFG)
    assert_trees_equal(back, jax.device_get(params))
    assert set(ref_sd) == set(nets[True].state_dict())


def test_forward_matches_jax():
    """The port's forward (fused and unfused layer) vs the JAX linen path and
    the JAX packed trunk (fused Pallas layers, interpret mode)."""
    params, nets = _nets()
    audio = RNG.normal(size=(1, L * HOP, 1)).astype(np.float32)
    cond = RNG.normal(size=(1, L, 16)).astype(np.float32)
    steps = np.full((1, 1), 2.5, np.float32)
    ja = [jnp.asarray(a) for a in (audio, cond, steps)]
    want = np.asarray(JaxFastDiff(cond_channels=16, use_packed=False).apply(params, *ja))
    packed = np.asarray(JaxFastDiff(cond_channels=16, use_packed=True).apply(params, *ja))
    np.testing.assert_allclose(packed, want, atol=5e-5)
    with torch.no_grad():
        for net in nets.values():
            got = net(_t(audio), _t(cond), _t(steps)).numpy()
            assert got.shape == want.shape == (1, L * HOP, 1)
            np.testing.assert_allclose(got, want, atol=5e-5)
            np.testing.assert_allclose(got, packed, atol=5e-5)


@pytest.mark.parametrize("hop,fused,unfused", [
    (20, False, False), (50, False, False), (64, True, True), (256, True, True),
    (5, False, False), (8, True, True), (36, False, False), (68, True, False),
    (100, True, False), (200, True, True)])
def test_window_route_by_hop(hop, fused, unfused):
    """The window product's route follows from the hop and the layer alone:
    the unfused layer's K6 at every multiple of 8, the fused layer's K4 also
    at the multiples of 4 from hop 64 on (where the JAX packed route runs
    ``ublock_layer_packed``); ``torch.matmul`` at the others, where the JAX
    package computes its XLA einsum."""
    assert on_kernels(hop, True) == fused == LAYER_HOP_RULE[1](hop)
    assert on_kernels(hop, False) == unfused == HOP_RULE[1](hop)


def _carried(ratios, n_frames, seed):
    """JAX FastDiff params at ``ratios`` (seeded init, biases perturbed) and
    the port's state dict carrying them."""
    cfg = dict(CFG, upsample_ratios=list(ratios))
    jnet = JaxFastDiff(cond_channels=16, upsample_ratios=tuple(ratios), use_packed=False)
    hop = int(np.prod(ratios))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.zeros((1, n_frames * hop, 1)),
                                jnp.zeros((1, n_frames, 16)), jnp.zeros((1, 1)))
    rng = np.random.default_rng(seed + 5)
    params = jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.05 if a.ndim == 1 else a,
        params)
    audio = rng.normal(size=(2, n_frames * hop, 1)).astype(np.float32)
    cond = rng.normal(size=(2, n_frames, 16)).astype(np.float32)
    steps = np.array([[3.0], [40.0]], np.float32)
    return cfg, params, tap_major_state_dict(fastdiff_state_dict(params, cfg), cfg), \
        (audio, cond, steps)


def _port_forward(cfg, sd, inputs, fused):
    """The port's forward on the CPU and its ``lvc_matmul`` calls (the CPU
    twins of K4 and K6 count nothing)."""
    net = FastDiff.from_config(cfg, fused_layer=fused).eval()
    net.load_state_dict(sd)
    before = (lvc_matmul.launches.count, ublock_layer.launches.count, lvc.launches.count)
    with torch.no_grad():
        got = net(*(_t(a) for a in inputs)).numpy()
    after = (lvc_matmul.launches.count, ublock_layer.launches.count, lvc.launches.count)
    assert after[1:] == before[1:]
    return got, after[0] - before[0]


def test_forward_matches_jax_at_hops_off_the_kernels():
    """Upsample ratios [5, 5, 4] (hops 5, 25, 100: none a multiple of 8): the
    unfused layer takes the matmul product on every layer (12 calls a
    forward), the fused layer on blocks 0-1 (8; hop 100 is K4's), and both
    match the JAX linen model (odd ratios: the JAX packed route does not
    take them)."""
    n_frames = 4
    cfg, params, sd, inputs = _carried((5, 5, 4), n_frames, 3)
    jnet = JaxFastDiff(cond_channels=16, upsample_ratios=(5, 5, 4), use_packed=True)
    assert not jnet.packed_active(n_frames)
    want = np.asarray(jnet.apply(params, *(jnp.asarray(a) for a in inputs)))
    for fused, routed in ((True, 8), (False, 12)):
        got, n = _port_forward(cfg, sd, inputs, fused)
        assert n == routed
        assert got.shape == want.shape == (2, n_frames * 100, 1)
        np.testing.assert_allclose(got, want, atol=5e-5)


def test_forward_matches_jax_packed_route_at_hop_100():
    """Upsample ratios [10, 10, 2] (hops 10, 100, 200), T_mel = 8 (at hop 100
    ``ublock_layer_packed``'s blocks need 8 | T_mel): the JAX packed route
    runs hop 10 by its einsum and hops 100 and 200 by
    ``ublock_layer_packed`` (interpret mode here); the port's fused layer
    takes the matmul product at hop 10 only (4 calls), its unfused layer at
    hops 10 and 100 (8), and both match the packed and the linen model."""
    n_frames = 8
    cfg, params, sd, inputs = _carried((10, 10, 2), n_frames, 4)
    ja = [jnp.asarray(a) for a in inputs]
    packed_net = JaxFastDiff(cond_channels=16, upsample_ratios=(10, 10, 2), use_packed=True)
    assert packed_net.packed_active(n_frames)
    packed = np.asarray(packed_net.apply(params, *ja))
    linen = np.asarray(JaxFastDiff(cond_channels=16, upsample_ratios=(10, 10, 2),
                                   use_packed=False).apply(params, *ja))
    np.testing.assert_allclose(packed, linen, atol=5e-5)
    for fused, routed in ((True, 4), (False, 8)):
        got, n = _port_forward(cfg, sd, inputs, fused)
        assert n == routed
        assert got.shape == packed.shape == (2, n_frames * 200, 1)
        np.testing.assert_allclose(got, packed, atol=5e-5)


def _schedule():
    dh = compute_hyperparams_given_schedule(np.linspace(1e-6, 0.01, 1000))
    return prepare_inference_schedule(NOISE_SCHEDULES[4], dh["alpha"])


def test_schedule_matches_jax():
    from prodiff_tpu.models.fastdiff import compute_hyperparams_given_schedule as jax_hyper

    want = jax_schedule(JAX_SCHEDULES[4], jax_hyper(np.linspace(1e-6, 0.01, 1000))["alpha"])
    for g, w in zip(_schedule(), want):
        np.testing.assert_array_equal(g, w)
    for k in (3, 4, 6, 8, 200, 1000):
        np.testing.assert_array_equal(NOISE_SCHEDULES[k], JAX_SCHEDULES[k])


def _python_scan(body, carry, xs):
    """``lax.scan``'s reference semantics as a Python loop (no stacked ys)."""
    for j in range(len(xs[0])):
        carry, _ = body(carry, jax.tree.map(lambda a: a[j], xs))
    return carry, None


def test_hoisted_sampling_matches_jax(monkeypatch):
    """4-step sampling with hoisted KernelPredictor stacks vs the JAX sampler
    with ``kp_all`` on its packed trunk, on injected noise.

    The JAX sampler's ``lax.scan`` runs here as its Python-loop equivalent,
    each step one jitted forward. Compiled as one program, XLA fuses the whole
    4-step loop, and that moves the JAX result by 1.6e-4 (wav peak 45, these
    inputs) from the same body evaluated step by step; the port matches the
    step-by-step evaluation to ~2e-5. The params are the init's (zero biases),
    as in the JAX package's own test of this sampler."""
    params, nets = _nets(perturb_biases=False)
    bi, ai, si, steps = _schedule()
    t = L * HOP
    cond = RNG.normal(size=(1, L, 16)).astype(np.float32)
    init = RNG.normal(size=(1, t, 1)).astype(np.float32)
    step_n = RNG.normal(size=(len(steps), 1, t, 1)).astype(np.float32)

    jnet = JaxFastDiff(cond_channels=16, use_packed=True)
    kp_jax = jax_step_kernels(jnet, params, jnp.asarray(cond), jnp.asarray(steps, jnp.float32))
    monkeypatch.setattr(jax.lax, "scan", _python_scan)
    want = np.asarray(jax_sampling(
        jax.jit(lambda p, x, c, tt, k: jnet.apply(p, x, c, tt, kp_out=k)),
        params, jax.random.PRNGKey(1), t, jnp.asarray(cond), bi, ai, si, steps,
        init_noise=jnp.asarray(init), step_noises=jnp.asarray(step_n), kp_all=kp_jax,
    ))
    net = nets[True]
    kp = fastdiff_step_kernels(net, _t(cond), _t(steps))
    for (km, lb), (km_j, lb_j) in zip(kp, kp_jax):
        np.testing.assert_allclose(km.numpy(), np.asarray(km_j), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(lb.numpy(), np.concatenate(lb_j, axis=-1), atol=1e-4, rtol=1e-4)
    got = sampling_given_noise_schedule(net, _t(cond), t, bi, ai, si, steps,
                                        init_noise=_t(init), step_noises=_t(step_n), kp_all=kp)
    assert got.shape == want.shape == (1, t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _with_weight_norm(sd):
    """A reference-style checkpoint: every conv weight as ``weight_g`` /
    ``weight_v`` (v a multiple of w, g its norm per output channel)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            base = k[: -len(".weight")]
            out[f"{base}.weight_v"] = 3.0 * v
            out[f"{base}.weight_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        else:
            out[k] = v
    return out


def test_vocoder_directory_route(tmp_path):
    """``vocoder_ckpt`` directory: config.yaml + the newest of two torch
    checkpoints with weight norm; the render equals the sampler's on the same
    weights and injected noise."""
    params, nets = _nets()
    ref_sd = fastdiff_state_dict(params, CFG)
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.dump(CFG, f)
    stale = {k: torch.zeros_like(v) for k, v in ref_sd.items()}
    torch.save({"state_dict": {"model": _with_weight_norm(stale)}},
               tmp_path / "model_ckpt_steps_90.ckpt")
    torch.save({"state_dict": {"model": _with_weight_norm(ref_sd)}},
               tmp_path / "model_ckpt_steps_100.ckpt")
    voc = get_vocoder_cls("fastdiff")({"vocoder_ckpt": str(tmp_path)}, device="cpu")
    for k, v in nets[True].state_dict().items():
        torch.testing.assert_close(voc.model.state_dict()[k], v, atol=1e-6, rtol=1e-5)

    mel = RNG.normal(size=(L, 16)).astype(np.float32)
    init = RNG.normal(size=(1, L * HOP, 1)).astype(np.float32)
    step_n = RNG.normal(size=(4, 1, L * HOP, 1)).astype(np.float32)
    noise = dict(init_noise=_t(init), step_noises=_t(step_n))
    wav = voc.spec2wav(mel, **noise)
    assert wav.shape == (L * HOP,) and np.isfinite(wav).all()
    bi, ai, si, steps = _schedule()
    kp = fastdiff_step_kernels(voc.model, _t(mel)[None], _t(steps))
    want = sampling_given_noise_schedule(voc.model, _t(mel)[None], L * HOP, bi, ai, si, steps,
                                         kp_all=kp, **noise)
    np.testing.assert_array_equal(wav, want[0].numpy())
    # in memory, unfused layer: the same render on the unfolded weights
    unfused = get_vocoder_cls("fastdiff")({"fastdiff_packed": False}, state_dict=ref_sd,
                                          config=CFG, device="cpu")
    assert not unfused.model.fused_layer
    kp = fastdiff_step_kernels(nets[True], _t(mel)[None], _t(steps))
    want = sampling_given_noise_schedule(nets[True], _t(mel)[None], L * HOP, bi, ai, si, steps,
                                         kp_all=kp, **noise)
    np.testing.assert_allclose(unfused.spec2wav(mel, **noise), want[0].numpy(), atol=1e-5)
    # without injected noise, the noise comes from the generator alone
    a, b = (unfused.spec2wav(mel, torch.Generator().manual_seed(s)) for s in (3, 3))
    np.testing.assert_array_equal(a, b)


def test_chip_smoke_mirrors_the_fastdiff_cell():
    """``chip_smoke.py`` builds the FastDiff path from in-code settings: the
    teacher's must be ``__graft_entry__._flagship(n_mels=80)``'s and the
    vocoder's the JAX FastDiff defaults at 80 mel channels (``bench.py``'s
    FastDiff cell)."""
    import dataclasses

    import chip_smoke
    from __graft_entry__ import _flagship

    _, hp = _flagship(n_mels=80)
    for key, value in chip_smoke.FD_TEACHER_HPARAMS.items():
        assert hp[key] == value, key
    fields = {f.name: f.default for f in dataclasses.fields(JaxFastDiff)}
    for key, value in chip_smoke.FD_CONFIG.items():
        if key in fields:
            want = fields[key]
            assert (list(want) if isinstance(want, tuple) else want) == value, key
    assert chip_smoke.FD_CONFIG["cond_channels"] == 80
    for key in ("beta_0", "beta_T", "T"):  # the train schedule, linspace(1e-6, 0.01, 1000)
        assert chip_smoke.FD_CONFIG[key] == {"beta_0": 1e-6, "beta_T": 0.01, "T": 1000}[key]
