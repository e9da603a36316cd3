"""The serving vocoders' bf16 routes (``--precision fast``) in the PyTorch port
vs the JAX package, on the CPU.

On its accelerator the JAX package gives NSF-HiFiGAN's resblock stages bf16
tap stacks (``nsf_fused_res_dtype: auto``) and computes FastDiff's
KernelPredictor in bf16 on its packed route, so the fused LVC kernels read
bf16 window kernels. The port does the same in ``fast`` mode on the card
(``device.resblock_tap_dtype``, ``device.kernel_predictor_dtype``). Here the
resolvers and the copied stage gate are held against the JAX package's, and
the bf16 plain twins, which the wrappers run for CPU tensors, against the
Pallas kernels in interpret mode on the same bf16 operands. Inputs are made
with numpy from a seed; weights are carried by the port's converters.

Tolerances, each relative to the reference output's peak unless stated:
- the resblock stage, 5e-3 (measured: 1.9e-6 to 1.3e-5 at C <= 128, 2.1e-4
  at C = 256, where the streamed kernel's sums round a few conv inputs to
  the neighbouring bf16 value); the float32 twin misses the bf16 kernel by
  2.4e-3 to 3.7e-3, so each case also holds the bf16 twin 4 times closer;
- the whole generator, the JAX test's bound for bf16 tap stacks
  (``tests/test_nsf_packed.py::test_fused_resblock_kernel_bf16_close``:
  max |diff| < 0.05 and correlation > 0.999; measured 2.5e-4 and 0.999998 on
  a 0.12 peak). A bf16 chain is chaotic: a float32 difference of 1e-7 in a
  stage's input flips a few roundings, and after a few convs the two sides
  differ by the size of the bf16 rounding itself;
- the KernelPredictor, 2e-2 (``tests/test_torch_bf16.py:MODULE_TOL``; measured
  3.8e-3 to 6.5e-3: a bf16 conv rounds each sum once here and flax may
  round an intermediate of its own);
- the LVC layer and block with bf16 windows, the float32 tests' absolute
  tolerances (3e-5 and 2e-5): both sides widen the same bf16 values exactly;
- the fast-mode FastDiff forward against the parity forward and the JAX
  linen forward, 2e-2 (measured 5.9e-3 against each), and the hoisted 4-step
  sampler fast vs parity, 1.5e-2 of the wav's peak (measured 4.5e-3), which
  ``chip_smoke.py`` widens to 2e-2 for the card's fast FastDiff-4 at
  T_mel=512 (another machine's bf16 convs, 128 times the frames).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu.models import nsf_hifigan as jax_nsf
from prodiff_tpu.models.fastdiff import FastDiff as JaxFastDiff
from prodiff_tpu.models.fastdiff import KernelPredictor as JaxKernelPredictor
from prodiff_tpu.models.fastdiff import location_variable_convolution
from prodiff_tpu.ops import packed as pk
from prodiff_tpu.ops.pallas.resblock import (
    prepare_resblock_stage,
    resblock_group_packed,
    resblock_group_streamed,
)
from prodiff_tpu_torch import device as policy
from prodiff_tpu_torch.models import nsf_hifigan as port_nsf
from prodiff_tpu_torch.models.fastdiff import (
    FastDiff,
    fastdiff_step_kernels,
    sampling_given_noise_schedule,
)
from prodiff_tpu_torch.ops import lvc as lvc_ops
from prodiff_tpu_torch.ops.lvc import lvc, lvc_matmul
from prodiff_tpu_torch.ops.resblock import resblock_stage
from prodiff_tpu_torch.ops.ublock import (
    layer_plan,
    ublock_block,
    ublock_layer,
)
from prodiff_tpu_torch.utils.convert import nsf_hifigan_state_dict
from tests.test_torch_fastdiff import CFG, HOP, L, _jax_layer, _layer_inputs, _nets, _schedule, _t
from tests.test_torch_ublock_block import DILATIONS, _block_inputs, _jax_block
from tests.test_torch_vocoder import _flat

RNG = np.random.default_rng(41)
BF16 = torch.bfloat16
# the openvpi 44.1 kHz release (the base config's vocoder), a 128-channel
# NSF generator and a ResBlock2 one
BASE_H = {"num_mels": 128, "sampling_rate": 44100, "upsample_initial_channel": 512,
          "upsample_rates": [8, 8, 2, 2, 2], "upsample_kernel_sizes": [16, 16, 4, 4, 4],
          "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5]] * 3}
NARROW_H = {"num_mels": 16, "sampling_rate": 44100, "upsample_initial_channel": 128,
            "upsample_rates": [4, 4, 2], "upsample_kernel_sizes": [8, 8, 4], "resblock": "1",
            "resblock_kernel_sizes": [3, 7], "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]]}
RESBLOCK2_H = dict(BASE_H, resblock="2", resblock_dilation_sizes=[[1, 3]] * 3)


def peak_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


# ---- the policy ---------------------------------------------------------------


@pytest.mark.parametrize("value", ["auto", None, "", "float32", "off", "bfloat16"])
@pytest.mark.parametrize("packed", [None, True, False])
@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("dev", ["cpu", "cuda", "cuda:0"])
def test_resblock_tap_dtype_matches_jax_mapping(monkeypatch, value, packed, mode, dev):
    """``nsf_fused_res_dtype`` x ``nsf_packed`` as the JAX vocoder reads them
    (the runner captured as in ``tests/test_nsf_packed.py:527``), with fast
    mode on a CUDA device as the JAX package's accelerator: bf16 stacks
    exactly where the JAX packed route runs with bf16 stacks; an unknown
    value raises as the JAX dict lookup does."""
    from prodiff_tpu.vocoders.nsf_hifigan import NsfHifiGAN

    on_accel = mode == "fast" and dev.startswith("cuda")
    seen = {}

    class Capture:
        def __init__(self, gen, dtype=None, fused_res_dtype="auto"):
            seen["frd"] = fused_res_dtype
            self.prepare = lambda params: {}

    monkeypatch.setattr(jax_nsf, "PackedGeneratorRunner", Capture)
    hp = {"nsf_packed": packed, "nsf_fused_res_dtype": value}
    voc = NsfHifiGAN(hp, params={"params": {}}, config=BASE_H)
    policy.set_precision(mode)
    try:
        if value == "bfloat16":
            with pytest.raises(KeyError):
                voc._packed_runner
            with pytest.raises(KeyError):
                policy.resblock_tap_dtype(hp, dev)
            return
        voc._packed_runner
        frd = seen.pop("frd")
        frd = (jnp.bfloat16 if on_accel else None) if frd == "auto" else frd
        packed_active = on_accel if packed is None else packed
        want = BF16 if packed_active and frd == jnp.bfloat16 else torch.float32
        assert policy.resblock_tap_dtype(hp, dev) == want
    finally:
        policy.set_precision("parity")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("dev", ["cpu", "cuda", None])
def test_kernel_predictor_dtype(fused, mode, dev):
    """bf16 on the fused-layer route in fast mode on a CUDA device (the JAX
    packed route off interpret mode), float32 otherwise; the unfused route
    (the JAX linen route) always float32."""
    policy.set_precision(mode)
    try:
        want = BF16 if fused and mode == "fast" and dev == "cuda" else torch.float32
        assert policy.kernel_predictor_dtype(fused, dev) == want
    finally:
        policy.set_precision("parity")


def _jax_stage_kinds(h, t_mel):
    """Which stages the JAX packed trunk gives the bf16 fused (``resfused_i``)
    or streamed (``resstream_i``) kernel, from the prepared tree's shapes
    (``jax.eval_shape``: nothing is computed)."""
    gen = jax_nsf.Generator.from_config(h, use_packed=True)
    mel = jax.ShapeDtypeStruct((1, t_mel, h["num_mels"]), jnp.float32)
    f0 = jax.ShapeDtypeStruct((1, t_mel), jnp.float32)
    shapes = jax.eval_shape(lambda m, f: gen.init({"params": jax.random.PRNGKey(0),
                                                   "noise": jax.random.PRNGKey(1)}, m, f),
                            mel, f0)
    runner = jax_nsf.PackedGeneratorRunner(gen, fused_res_dtype=jnp.bfloat16)
    prepared = jax.eval_shape(runner.prepare, shapes)
    return tuple("stream" if f"resstream_{i}" in prepared
                 else "fuse" if f"resfused_{i}" in prepared else None
                 for i in range(len(h["upsample_rates"])))


@pytest.mark.parametrize("h,t_mel", [(BASE_H, 8), (BASE_H, 7), (NARROW_H, 8), (NARROW_H, 5),
                                     (RESBLOCK2_H, 8)])
def test_stage_gate_matches_jax(h, t_mel):
    """The copied gates against ``prodiff_tpu``'s: ``hifigan_stage_packs``,
    ``packed_trunk_supported`` at this length, and each stage's kernel with
    bf16 tap stacks, the VMEM cap included; then the Generator's per-stage
    tap dtypes. For the base config all five stages qualify (stage 0
    streamed, the others fused)."""
    rates, ksizes = h["upsample_rates"], h["upsample_kernel_sizes"]
    init_ch, n = h["upsample_initial_channel"], len(h["upsample_rates"])
    assert port_nsf.hifigan_stage_packs(init_ch, n) == jax_nsf.hifigan_stage_packs(init_ch, n)
    kw = dict(rates=rates, ksizes=ksizes, init_ch=init_ch, resblock=h["resblock"],
              res_ksizes=h["resblock_kernel_sizes"], has_source=True)
    supported = port_nsf.packed_trunk_supported(t_mel, **kw)
    assert supported == jax_nsf.packed_trunk_supported(t_mel, **kw)
    if h["resblock"] == "1":
        kinds = port_nsf.fused_stage_kinds(init_ch, n, h["resblock_kernel_sizes"],
                                           h["resblock_dilation_sizes"])
        assert kinds == _jax_stage_kinds(h, t_mel)
        gen = port_nsf.Generator.from_config(h, tap_dtype=BF16)
        want = tuple(BF16 if supported and k else torch.float32 for k in kinds)
        assert gen.stage_tap_dtypes(t_mel) == want
        assert port_nsf.Generator.from_config(h).stage_tap_dtypes(t_mel) == (torch.float32,) * n
    if h is BASE_H:
        assert kinds == ("stream", "fuse", "fuse", "fuse", "fuse")
    if h["resblock"] == "2":
        assert not supported


def test_fused_cap_leaves_a_stage_to_xla():
    """A 128-lane stage whose bf16 tap stacks exceed the JAX kernel's VMEM cap
    (9 MiB) stays on the XLA stage, float32, in both packages: at pack 1,
    five kernel-size-11 ResBlocks of dilations 1..5 are 550 taps (18 MB)."""
    ks, ds = [11] * 5, [[1, 2, 3, 4, 5]] * 5
    h = dict(NARROW_H, upsample_initial_channel=256, resblock_kernel_sizes=ks,
             resblock_dilation_sizes=ds)
    kinds = port_nsf.fused_stage_kinds(256, 3, ks, ds)
    assert kinds[0] is None and kinds == _jax_stage_kinds(h, 8)


# ---- the resblock stage (K2/K3-bf16) ------------------------------------------


def _stage_params(rng, c, ksizes, dsizes):
    """A stage's seeded JAX params (``_flat`` gives the port's layout)."""
    return [{f"{grp}_{li}": {"conv": {
        "kernel": rng.normal(size=(k, c, c)).astype(np.float32) * (3 * c) ** -0.5,
        "bias": rng.normal(size=(c,)).astype(np.float32) * 0.1}}
        for li in range(len(ds)) for grp in ("convs1", "convs2")}
        for k, ds in zip(ksizes, dsizes)]


@pytest.mark.parametrize("c,s", [(64, 37), (32, 48), (16, 37), (256, 37)])
def test_resblock_bf16_twin_matches_pallas(c, s):
    """``resblock_stage`` with bf16 taps (its twin, for CPU tensors) vs
    ``resblock_group_packed`` (C <= 128, packed [B, T/P, 128]) and
    ``resblock_group_streamed`` (C = 256) on ``prepare_resblock_stage(dtype=
    bfloat16)`` stacks in interpret mode; the float32 route lands 4 times
    further off."""
    ksizes, dsizes = [3, 7], [[1, 3], [1, 2]]
    rng = np.random.default_rng(c)
    stage = _stage_params(rng, c, ksizes, dsizes)
    p = 128 // c if c < 128 else 1
    w, b = prepare_resblock_stage(stage, ksizes, dsizes, p, dtype=jnp.bfloat16)
    x = rng.normal(size=(2, s * p, c)).astype(np.float32)
    if c < 128:
        want = pk.unpack(resblock_group_packed(pk.pack(jnp.asarray(x), p), w, b, ksizes, dsizes,
                                               p, rows_per_block=16, interpret=True), c)
    else:
        want = resblock_group_streamed(jnp.asarray(x), w, b, ksizes, dsizes, rows_per_block=16,
                                       interpret=True)
    w32, b32 = _flat(stage, ksizes, dsizes)
    before = resblock_stage.bf16_launches.count
    got = resblock_stage(torch.from_numpy(x), w32.to(BF16), b32, ksizes, dsizes)
    assert resblock_stage.bf16_launches.count == before  # CPU tensors launch nothing
    f32 = resblock_stage(torch.from_numpy(x), w32, b32, ksizes, dsizes)
    err, err32 = peak_err(got, want), peak_err(f32, want)
    assert got.dtype == torch.float32 and err < 5e-3, err
    assert err < err32 / 4, (err, err32)


@pytest.fixture(scope="module")
def narrow_generators():
    """The narrow NSF generator: JAX params (seeded init) and a seeded input;
    the port's Generator with bf16 and with float32 taps carrying them."""
    rng = np.random.default_rng(12)
    t_mel = 8
    jgen = jax_nsf.Generator.from_config(NARROW_H, use_packed=False)
    mel = rng.normal(size=(1, t_mel, 16)).astype(np.float32) - 3
    f0 = rng.uniform(80, 600, size=(1, t_mel)).astype(np.float32)
    params = jax.jit(jgen.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                jnp.asarray(mel), jnp.asarray(f0))
    gens = {}
    for dt in (BF16, torch.float32):
        gens[dt] = port_nsf.Generator.from_config(NARROW_H, tap_dtype=dt)
        gens[dt].load_state_dict(nsf_hifigan_state_dict(params, NARROW_H))
    return jgen, params, gens, mel, f0


def test_generator_bf16_matches_packed_runner(narrow_generators, monkeypatch):
    """The whole generator, deterministic, with bf16 taps on the CPU (each
    stage through ``resblock_stage``'s bf16 twin, the card's route, not the
    module loop) vs ``PackedGeneratorRunner(fused_res_dtype=bfloat16)`` (its
    fused kernels in interpret mode), within the JAX test's bound."""
    jgen, params, gens, mel, f0 = narrow_generators
    runner = jax_nsf.PackedGeneratorRunner(jgen, fused_res_dtype=jnp.bfloat16)
    want = np.asarray(runner(runner.prepare(params), jnp.asarray(mel), jnp.asarray(f0)))
    gen = gens[BF16]
    assert gen.stage_tap_dtypes(8) == (BF16,) * 3
    seen = []
    orig = port_nsf.resblock_stage
    monkeypatch.setattr(port_nsf, "resblock_stage",
                        lambda x, w, *a: seen.append(w.dtype) or orig(x, w, *a))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), torch.from_numpy(f0)).numpy()
    assert seen == [BF16] * 3
    assert got.shape == want.shape == (1, 8 * 32)
    assert np.abs(got - want).max() < 0.05
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    assert all(w.dtype == BF16 for w, _ in gen.stage_weights((BF16,) * 3))


def test_stage_weights_cache_keys_on_dtype(narrow_generators):
    """One stage-weight cache for float32 and bf16 stacks: asking for the other
    dtypes rebuilds it; the parameters stay float32."""
    *_, gens, _, _ = narrow_generators
    gen = gens[BF16]
    w16 = gen.stage_weights((BF16,) * 3)[1][0]
    w32 = gen.stage_weights()[1][0]
    assert w16.dtype == BF16 and w32.dtype == torch.float32
    torch.testing.assert_close(w16, w32.to(BF16), rtol=0, atol=0)
    assert all(p.dtype == torch.float32 for p in gen.parameters())


# ---- FastDiff (K4-bf16, K7-bf16 and the KernelPredictor) ----------------------


def _fast_net(fused=True):
    _, nets = _nets()
    net = FastDiff.from_config(CFG, fused_layer=fused, kp_dtype=BF16).eval()
    net.load_state_dict(nets[True].state_dict())
    return net


def test_kernel_predictor_bf16_matches_flax():
    """The port's KernelPredictor in bf16 vs flax's ``KernelPredictor(dtype=
    bfloat16, flat=True)`` on the carried weights: bf16 window kernels within
    2e-2 of their peak; the biases come back float32 from the block."""
    params, _ = _nets()
    net = _fast_net()
    cond = np.random.default_rng(1).normal(size=(2, L, 16)).astype(np.float32)
    for i, blk in enumerate(net.lvc_blocks):
        kp = JaxKernelPredictor(conv_in_channels=32, conv_out_channels=64, conv_layers=4,
                                conv_kernel_size=3, hidden_channels=64, conv_size=3, flat=True,
                                dtype=jnp.bfloat16)
        km_j, lb_j = kp.apply({"params": params["params"][f"lvc_blocks_{i}"]["kernel_predictor"]},
                              jnp.asarray(cond))
        with torch.no_grad():
            km, lb = blk.kernel_predictor(_t(cond))
        assert km.dtype == lb.dtype == BF16 and km_j.dtype == jnp.bfloat16
        assert peak_err(km.float(), np.asarray(km_j, np.float32)) < 2e-2
        assert peak_err(lb.float(), np.asarray(lb_j, np.float32)) < 2e-2
        with torch.no_grad():
            kms, lbs = blk.kernels(_t(cond), torch.zeros(1, 512))
        assert kms.dtype == BF16 and lbs.dtype == torch.float32


@pytest.mark.parametrize("hop,dilation,n_win", [(256, 27, 4), (64, 3, 8), (8, 9, 32)])
def test_ublock_layer_bf16_windows_match_pallas(hop, dilation, n_win):
    """K4's twin with bf16 windows vs ``ublock_layer_packed`` in interpret
    mode on the same bf16 windows (widened at its VMEM read)."""
    x, ad, ck, cb, km, lb = _layer_inputs(2, n_win * hop, n_win)
    km16 = torch.from_numpy(km).to(BF16)
    want = _jax_layer(x, ad, ck, cb, jnp.asarray(km16.float().numpy(), jnp.bfloat16), lb,
                      dilation, hop)
    before = ublock_layer.bf16_launches.count
    got = ublock_layer(_t(x), _t(ad), _t(ck.transpose(2, 1, 0)), _t(cb), km16, _t(lb),
                       dilation, hop)
    assert ublock_layer.bf16_launches.count == before
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_ublock_block_bf16_windows_match_pallas():
    """K7's twin with a bf16 stack vs ``ublock_block_packed`` in interpret
    mode on the same bf16 windows (step 1 of 2, hop 64)."""
    hop, n_win, step = 64, 16, 1
    x, ad, cks, cbs, km, lb = _block_inputs(1, n_win, hop, 2)
    km16 = torch.from_numpy(km).to(BF16)
    want = _jax_block(x, ad, cks, cbs, jnp.asarray(km16.float().numpy(), jnp.bfloat16), lb, hop,
                      step)
    got = ublock_block(_t(x), _t(ad), [_t(ck.transpose(2, 1, 0)) for ck in cks],
                       [_t(c) for c in cbs], km16, _t(lb), DILATIONS, hop, step)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_lvc_matmul_widens_bf16_windows():
    """The window product off the kernels takes bf16 windows and widens them,
    as XLA promotes the JAX package's mixed einsum
    (``location_variable_convolution`` with bf16 ``kmat``)."""
    hop, n_win, c = 20, 5, 32
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, n_win * hop, c)).astype(np.float32)
    km16 = torch.from_numpy(rng.normal(size=(2, n_win, 3 * c, 2 * c)).astype(np.float32)
                            * 0.1).to(BF16)
    lb = rng.normal(size=(2, n_win, 2 * c)).astype(np.float32)
    want = location_variable_convolution(jnp.asarray(x), jnp.asarray(km16.float().numpy(),
                                                                      jnp.bfloat16),
                                         jnp.asarray(lb), hop)
    assert want.dtype == jnp.float32
    before = lvc_matmul.launches.count
    got = lvc_matmul(_t(x), km16, _t(lb), hop)
    assert lvc_matmul.launches.count == before + 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


def test_fastdiff_forward_fast_dtypes():
    """One forward with the fast route's dtypes on the CPU twins (bf16
    KernelPredictors, bf16 windows into K4's twin) vs the port's parity
    forward and the JAX linen forward (both float32)."""
    params, nets = _nets()
    rng = np.random.default_rng(2)
    audio = rng.normal(size=(1, L * HOP, 1)).astype(np.float32)
    cond = rng.normal(size=(1, L, 16)).astype(np.float32)
    steps = np.full((1, 1), 2.5, np.float32)
    linen = np.asarray(JaxFastDiff(cond_channels=16, use_packed=False).apply(
        params, *(jnp.asarray(a) for a in (audio, cond, steps))))
    with torch.no_grad():
        fast = _fast_net()(_t(audio), _t(cond), _t(steps)).numpy()
        parity = nets[True](_t(audio), _t(cond), _t(steps)).numpy()
    assert fast.shape == linen.shape == (1, L * HOP, 1)
    assert 0 < peak_err(fast, parity) < 2e-2
    assert peak_err(fast, linen) < 2e-2


def test_hoisted_sampler_fast_vs_parity():
    """The hoisted 4-step sampler on injected noise, fast dtypes vs parity:
    the bf16 stacks move the wav by 4.5e-3 of its peak (bound 1.5e-2;
    ``chip_smoke.py`` holds the card's fast FastDiff-4 to 2e-2)."""
    _, nets = _nets()
    bi, ai, si, steps = _schedule()
    t = L * HOP
    rng = np.random.default_rng(3)
    cond = rng.normal(size=(1, L, 16)).astype(np.float32)
    init = rng.normal(size=(1, t, 1)).astype(np.float32)
    step_n = rng.normal(size=(len(steps), 1, t, 1)).astype(np.float32)
    wavs = {}
    for name, net in (("fast", _fast_net()), ("parity", nets[True])):
        kp = fastdiff_step_kernels(net, _t(cond), _t(steps))
        assert all(km.dtype == (BF16 if name == "fast" else torch.float32) for km, _ in kp)
        wavs[name] = sampling_given_noise_schedule(net, _t(cond), t, bi, ai, si, steps,
                                                   init_noise=_t(init), step_noises=_t(step_n),
                                                   kp_all=kp).numpy()
    assert 0 < peak_err(wavs["fast"], wavs["parity"]) < 1.5e-2


# ---- refusals -----------------------------------------------------------------


def test_wrappers_refuse_what_their_kernels_do_not_take():
    """Every wrapper refuses, on the CPU as on the card, a dtype its kernel
    does not take: the resblock stage float16 taps and non-float32
    activations or biases; K4 and K7 float16 windows and bf16 activations;
    K6 (``lvc``, and its operand check) bf16 windows, which the JAX package
    never gives ``lvc_pallas``. FastDiff's unfused route has no bf16
    KernelPredictor."""
    ksizes, dsizes = (3,), ((1,),)
    w, b = _flat(_stage_params(RNG, 16, ksizes, dsizes), ksizes, dsizes)
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="taps"):
        resblock_stage(x, w.half(), b, ksizes, dsizes)
    with pytest.raises(ValueError, match="x and biases"):
        resblock_stage(x.to(BF16), w.to(BF16), b, ksizes, dsizes)
    with pytest.raises(ValueError, match="x and biases"):
        resblock_stage(x, w.to(BF16), b.to(BF16), ksizes, dsizes)

    xs, ad, ck, cb, km, lb = (_t(a) for a in _layer_inputs(1, 2 * 64, 2))
    cw = ck.permute(2, 1, 0).contiguous()
    with pytest.raises(ValueError, match="window kernels"):
        ublock_layer(xs, ad, cw, cb, km.half(), lb, 1, 64)
    with pytest.raises(ValueError, match="window kernels"):
        ublock_block(xs, ad, [cw], [cb], km[None].half(), lb[None], [1], 64, 0)
    with pytest.raises(ValueError, match="float32 window kernels"):
        lvc(xs, km.to(BF16), lb, 64)
    with pytest.raises(ValueError, match="window kernels"):
        lvc_ops.check_kernel_operands("lvc", lvc_ops.HOP_RULE, xs, km.to(BF16), lb, 64, None, 0)
    with pytest.raises(ValueError, match="but the window kernels"):
        lvc_ops.check_kernel_operands("ublock_layer", lvc_ops.LAYER_HOP_RULE, xs.to(BF16),
                                      km.to(BF16), lb, 64, None, 0,
                                      window_dtypes=(torch.float32, BF16))
    _, ops = lvc_ops.check_kernel_operands("ublock_layer", lvc_ops.LAYER_HOP_RULE, xs,
                                           km.to(BF16), lb, 64, None, 0,
                                           window_dtypes=(torch.float32, BF16))
    assert ops[1].dtype == BF16
    with pytest.raises(ValueError, match="fused-layer route only"):
        FastDiff.from_config(CFG, fused_layer=False, kp_dtype=BF16)


@pytest.mark.parametrize("hop,d", [(8, 9), (64, 27), (256, 27), (100, 3)])
def test_layer_plan_bf16_windows(hop, d):
    """The bf16 builds keep the float plan's units (rows, windows a unit
    touches) and stage their windows as bf16 in every plan, half the bytes
    (``csrc/lvc_tiles.cuh:kw_floats``; below hop 64 the float build streams
    them instead), and hold y for the tensor cores as three bf16 terms
    [3][4][R + 2][8] in the float plan's yT [32][R + 8] floats' place."""
    p32, p16 = layer_plan(hop, d), layer_plan(hop, d, BF16)
    assert (p16["rows"], p16["windows"]) == (p32["rows"], p32["windows"])
    assert (p16["streams"], p16["product"], p16["terms"]) == (False, "mma", 3)
    rows, staged32 = p32["rows"], (p32["windows"] if not p32["streams"] else 0)
    window32, window16 = 96 * 64 * 4 + 64 * 4, 96 * 64 * 2 + 64 * 4
    assert p32["smem"] - p16["smem"] == (staged32 * window32 - p16["windows"] * window16
                                         + 32 * (rows + 8) * 4 - 3 * (rows + 2) * 32 * 2)
