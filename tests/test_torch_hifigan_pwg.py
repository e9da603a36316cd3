"""HiFi-GAN and Parallel WaveGAN in the PyTorch port vs the JAX package, on the CPU.

The generators (``models/hifigan.py``, ``models/pwg.py``) against the JAX
linen modules on the same weights (the port's seeded weights carried by the
JAX converters ``convert_hifigan``/``convert_pwg``, and back by the port's
``hifigan_state_dict``/``pwg_state_dict``), NSF-HiFiGAN with ResBlock2, the
vocoders (``vocoders/hifigan.py``) from the three checkpoint layouts they
resolve, ``denoise``, ``f0_to_coarse``, ``vocode wav2wav --device cpu``
against the JAX pipeline of ``main.py vocode wav2wav``, and the resblock
stage at C = 8 (the last stage of a HiFiGAN that starts at 128 channels)
against the Pallas ``resblock_group_packed`` at pack 16 in interpret mode.
Inputs are made with numpy from a seed; the random draws (HiFi-GAN's source
phases and noise, PWG's ``z``) are injected into both packages.

Tolerances (the float32 port tests' own unless stated):
- generators and vocoders: atol 2e-5 + rtol 1e-3 on the wav (the JAX
  package's own parity test against torch, ``tests/test_hifigan_pwg.py``);
- the sine source: 5e-5 absolute on a 0.1 amplitude (the JAX phase sum is
  float32 in chunks of 128, the port's float64: measured 1.5e-5 at 1,280
  samples);
- ``mod1_cumsum``: the port within 1e-6 of a float64 sum on the circle,
  the JAX function within its own test's 5e-3;
- the C = 8 stage: float32 1e-5 absolute against the Pallas kernel; with
  bf16 taps 5e-3 of the peak and 4 times closer than the float32 route
  (``tests/test_torch_bf16_vocoders.py``'s bounds); the bf16 generator the
  JAX bound for bf16 tap stacks (max |diff| < 0.05, correlation > 0.999);
- ``denoise``: 1e-5 absolute + 2e-3 relative (float32 FFTs on both sides;
  at the JAX defaults a 512-sample window in 2,048-sample frames at hop 512
  leaves samples where the summed squared window nears 0, and both divide
  their FFT noise by it: up to 1.1e-3 relative there, 2.4e-7 absolute
  elsewhere);
- ``f0_to_coarse``: exact;
- written wavs: 1e-4 of the peak plus one 16-bit step
  (``tests/test_torch_vocode.py:_assert_wavs_close``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prodiff_tpu.models import hifigan as jax_hifigan
from prodiff_tpu.models import nsf_hifigan as jax_nsf
from prodiff_tpu.models.pwg import ParallelWaveGANGenerator as JaxPWG
from prodiff_tpu.models.pwg import convert_pwg
from prodiff_tpu.ops import packed as pk
from prodiff_tpu.ops.pallas.resblock import prepare_resblock_stage, resblock_group_packed
from prodiff_tpu.utils.pitch_utils import f0_to_coarse as jax_f0_to_coarse
from prodiff_tpu.utils.torch_convert import convert_nsf_hifigan
from prodiff_tpu.vocoders import get_vocoder_cls as jax_get_vocoder_cls
from prodiff_tpu.vocoders.hifigan import denoise as jax_denoise
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.models import hifigan as port_hifigan
from prodiff_tpu_torch.models import nsf_hifigan as port_nsf
from prodiff_tpu_torch.models.pwg import ParallelWaveGANGenerator
from prodiff_tpu_torch.ops.resblock import channels_supported, resblock_stage
from prodiff_tpu_torch.utils.convert import (
    hifigan_state_dict,
    nsf_hifigan_state_dict,
    pwg_state_dict,
)
from prodiff_tpu_torch.utils.pitch_utils import f0_to_coarse
from prodiff_tpu_torch.vocoders import get_vocoder_cls
from prodiff_tpu_torch.vocoders.hifigan import PWG, HifiGAN, denoise
from tests.test_torch_bf16_vocoders import _stage_params, peak_err
from tests.test_torch_vocode import _assert_wavs_close, _jax_wav2wav, _write_inputs
from tests.test_torch_vocoder import _flat

ATOL, RTOL = 2e-5, 1e-3
BF16 = torch.bfloat16
# tests/test_hifigan_pwg.py's small HiFi-GAN: 3 stages from 32 channels (16, 8, 4)
H = {"upsample_rates": [4, 4, 2], "upsample_kernel_sizes": [8, 8, 4],
     "upsample_initial_channel": 32, "resblock": "1", "resblock_kernel_sizes": [3, 7],
     "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]], "use_pitch_embed": False,
     "audio_sample_rate": 22050}
# from 64 channels: stages 32, 16 and 8, packs 4, 8 and 16 in the JAX packed trunk
H_C8 = dict(H, upsample_initial_channel=64)
H_PITCH = dict(H, use_pitch_embed=True)
# HiFi-GAN V3's ResBlock2 (config_v3.json's kernels and dilations)
H_RB2 = dict(H, resblock="2", resblock_kernel_sizes=[3, 5, 7],
             resblock_dilation_sizes=[[1, 2], [2, 6], [3, 12]])
PWG_CFG = {
    "hop_size": 32,
    "generator_params": {
        "layers": 6, "stacks": 2, "residual_channels": 8, "gate_channels": 16,
        "skip_channels": 8, "aux_channels": 12, "aux_context_window": 2,
        "upsample_params": {"upsample_scales": [4, 4, 2]}, "use_pitch_embed": False,
        "kernel_size": 3, "dropout": 0.0,
    },
}
PWG_PITCH_CFG = {"hop_size": 32,
                 "generator_params": dict(PWG_CFG["generator_params"], use_pitch_embed=True)}
# 80 mels at 22.05 kHz, hop 32 (the small generators' upsampling)
AUDIO = {"audio_sample_rate": 22050, "audio_num_mel_bins": 80, "fft_size": 512,
         "win_size": 512, "hop_size": 32, "fmin": 80, "fmax": 7600}


def _fan_in_init(model: torch.nn.Module, seed: int, out_scale: float = 1.0) -> None:
    """Seeded weights at 0.5 / sqrt(fan in) and biases at 0.1, so that a
    random generator's wav follows its input; the last conv scaled by
    ``out_scale``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1 and "embed" not in name:
                std = 0.5 / p[0].numel() ** 0.5
            else:
                std = 0.1 if p.dim() == 1 else 1.0
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)) * std))
        if out_scale != 1.0:
            last = model.conv_post if hasattr(model, "conv_post") else model.last_conv_layers[3]
            last.weight.mul_(out_scale)


def _np_sd(model: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _hifigan(h, seed=0, tap_dtype=torch.float32, out_scale=1.0):
    gen = port_hifigan.HifiGanGenerator.from_config(h, tap_dtype=tap_dtype).eval()
    _fan_in_init(gen, seed, out_scale)
    return gen


def _inject(monkeypatch, name, value):
    """``jax.random.<name>`` returns ``value`` where asked for its shape (flax
    also evaluates the param initializers, at other shapes)."""
    draw = getattr(jax.random, name)

    def injected(key, shape=(), *a, **k):
        if tuple(shape) == value.shape:
            return jnp.asarray(value)
        return draw(key, shape, *a, **k)

    monkeypatch.setattr(jax.random, name, injected)


def _jax_draws(monkeypatch, rand_ini, noise):
    """The JAX source's two draws, the initial phases and the noise, injected."""
    _inject(monkeypatch, "uniform", rand_ini)
    _inject(monkeypatch, "normal", noise)


def _draws(rng, b, t, dim=9):
    return (rng.uniform(size=(b, dim)).astype(np.float32),
            rng.normal(size=(b, t, dim)).astype(np.float32))


# ---- helpers: f0_to_coarse, mod1_cumsum, the sine source --------------------


def test_f0_to_coarse_matches_jax():
    """Bins 1..255 with 0 Hz, the range ends and beyond them, exactly."""
    rng = np.random.default_rng(0)
    f0 = np.concatenate([rng.uniform(30, 1300, 500), [0.0, 50.0, 1100.0, 1e4]])
    got, want = f0_to_coarse(f0.copy()), jax_f0_to_coarse(f0.copy())
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.min() == 1 and got.max() == 255


def test_mod1_cumsum_matches_jax():
    """200,000 samples of increments up to 0.05, 3 harmonics: both on the
    circle against a float64 sum."""
    rad = np.random.default_rng(1).uniform(0, 0.05, (1, 200000, 3)).astype(np.float32)
    truth = np.cumsum(rad.astype(np.float64), axis=1) % 1.0
    got = port_hifigan.mod1_cumsum(torch.from_numpy(rad)).numpy()
    want = np.asarray(jax_hifigan.mod1_cumsum(jnp.asarray(rad)))

    def circle(a, b):
        return float(np.abs(np.exp(2j * np.pi * a) - np.exp(2j * np.pi * b)).max())

    assert got.shape == want.shape == rad.shape
    assert circle(got, truth) < 1e-6
    assert circle(want, truth) < 5e-3
    assert circle(got, want) < 5e-3


def test_sine_gen_samplewise_matches_jax(monkeypatch):
    """The sample-rate source on injected initial phases and noise: voiced
    and unvoiced samples, B = 2."""
    rng = np.random.default_rng(2)
    f0_up = np.repeat(rng.uniform(80, 600, (2, 40)), 32, axis=1).astype(np.float32)
    f0_up[:, 300:500] = 0.0
    rand_ini, noise = _draws(rng, 2, f0_up.shape[1])
    _jax_draws(monkeypatch, rand_ini, noise)
    want = np.asarray(jax_hifigan.sine_gen_samplewise(jnp.asarray(f0_up), 22050, 8,
                                                      jax.random.PRNGKey(0)))
    got = port_hifigan.sine_gen_samplewise(
        torch.from_numpy(f0_up), 22050, 8, (torch.from_numpy(rand_ini), torch.from_numpy(noise)))
    assert got.shape == want.shape == (2, 1280, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


# ---- the generators -----------------------------------------------------------


@pytest.mark.parametrize("h", [H, H_C8, H_RB2], ids=["resblock1", "c8", "resblock2"])
def test_hifigan_generator_matches_jax(h):
    """Without the pitch embed: ResBlock1 from 32 and from 64 channels (a
    C = 8 stage) and ResBlock2; the JAX weights are the port's, carried by
    ``convert_hifigan``, and ``hifigan_state_dict`` carries them back exactly."""
    gen = _hifigan(h, seed=3)
    params = jax_hifigan.convert_hifigan(_np_sd(gen), h)
    back = hifigan_state_dict(params, h)
    assert back.keys() == gen.state_dict().keys()
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    mel = np.random.default_rng(4).normal(size=(1, 10, 80)).astype(np.float32)
    jgen = jax_hifigan.HifiGanGenerator.from_config(h)
    want = np.asarray(jgen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(mel)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 10 * 32)
    assert np.abs(want).max() > 0.02
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_hifigan_generator_pitch_embed_matches_jax(monkeypatch):
    """``use_pitch_embed``: f0 nearest-upsampled, the sample-rate source on
    injected draws, the noise convs; without f0 the source stays off in both."""
    gen = _hifigan(H_PITCH, seed=5)
    params = jax.tree.map(jnp.asarray, jax_hifigan.convert_hifigan(_np_sd(gen), H_PITCH))
    back = hifigan_state_dict(params, H_PITCH)
    assert "m_source.l_linear.weight" in back and "noise_convs.2.weight" in back
    rng = np.random.default_rng(6)
    mel = rng.normal(size=(1, 12, 80)).astype(np.float32)
    f0 = rng.uniform(100, 400, (1, 12)).astype(np.float32)
    f0[0, 4:6] = 0.0
    rand_ini, noise = _draws(rng, 1, 12 * 32)
    jgen = jax_hifigan.HifiGanGenerator.from_config(H_PITCH)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), torch.from_numpy(f0),
                  draws=(torch.from_numpy(rand_ini), torch.from_numpy(noise))).numpy()
        got_nof0 = gen(torch.from_numpy(mel)).numpy()
    want_nof0 = np.asarray(jgen.apply(params, jnp.asarray(mel)))
    _jax_draws(monkeypatch, rand_ini, noise)
    want = np.asarray(jgen.apply(params, jnp.asarray(mel), jnp.asarray(f0),
                                 rngs={"noise": jax.random.PRNGKey(0)}))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_nof0, want_nof0, atol=ATOL, rtol=RTOL)
    assert np.abs(got - got_nof0).max() > 1e-3  # the source reaches the wav


def test_hifigan_generator_draws_from_the_generator():
    """Without injected draws the source draws from the given generator
    (default seed 0): one seed renders one wav, another seed another."""
    gen = _hifigan(H_PITCH, seed=7)
    mel, f0 = torch.randn(1, 6, 80), torch.full((1, 6), 220.0)
    with torch.no_grad():
        a = gen(mel, f0)
        b = gen(mel, f0, generator=torch.Generator().manual_seed(0))
        c = gen(mel, f0, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-6


def test_nsf_generator_resblock2_matches_jax():
    """NSF-HiFiGAN with ResBlock2 (V3's kernels and dilations, deterministic
    source) vs the JAX linen Generator; both carriers; its stages run the
    plain modules, never ``resblock_stage``."""
    h = {"num_mels": 16, "sampling_rate": 44100, "upsample_initial_channel": 32,
         "upsample_rates": [4, 4, 2], "upsample_kernel_sizes": [8, 8, 4], "resblock": "2",
         "resblock_kernel_sizes": [3, 5, 7], "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
    gen = port_nsf.Generator.from_config(h).eval()
    _fan_in_init(gen, 8)
    params = convert_nsf_hifigan(_np_sd(gen), h)
    back = nsf_hifigan_state_dict(params, h)
    assert back.keys() == gen.state_dict().keys() and "resblocks.8.convs.1.weight" in back
    rng = np.random.default_rng(9)
    mel = rng.normal(size=(1, 8, 16)).astype(np.float32)
    f0 = rng.uniform(100, 400, (1, 8)).astype(np.float32)
    jgen = jax_nsf.Generator.from_config(h, use_packed=False)
    want = np.asarray(jgen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(mel),
                                 jnp.asarray(f0), deterministic=True))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), torch.from_numpy(f0)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert gen.stage_tap_dtypes(8) == (torch.float32,) * 3
    with pytest.raises(ValueError, match="only ResBlock1"):
        gen.stage_weights()


@pytest.mark.parametrize("cfg", [PWG_CFG, PWG_PITCH_CFG], ids=["plain", "pitch_embed"])
def test_pwg_generator_matches_jax(cfg):
    """On an injected ``z``; with the pitch embed, coarse pitch ids of an f0
    curve edge-padded as the vocoder pads them; both carriers."""
    gp = cfg["generator_params"]
    gen = ParallelWaveGANGenerator.from_config(cfg).eval()
    _fan_in_init(gen, 10)
    params = convert_pwg(_np_sd(gen), cfg)
    back = pwg_state_dict(params, cfg)
    assert back.keys() == gen.state_dict().keys()
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    rng = np.random.default_rng(11)
    t_mel = 5
    c = np.pad(rng.normal(size=(t_mel, 12)).astype(np.float32), ((2, 2), (0, 0)), "edge")
    z = rng.normal(size=(1, t_mel * 32, 1)).astype(np.float32)
    pitch = None
    if gp["use_pitch_embed"]:
        pitch = np.pad(f0_to_coarse(rng.uniform(80, 800, t_mel)), (2, 2), "edge")[None]
    jgen = JaxPWG(layers=6, stacks=2, residual_channels=8, gate_channels=16, skip_channels=8,
                  aux_channels=12, aux_context_window=2, upsample_scales=(4, 4, 2),
                  use_pitch_embed=gp["use_pitch_embed"])
    want = np.asarray(jgen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(z),
                                 jnp.asarray(c)[None],
                                 None if pitch is None else jnp.asarray(pitch)))
    with torch.no_grad():
        got = gen(torch.from_numpy(z), torch.from_numpy(c)[None],
                  None if pitch is None else torch.from_numpy(pitch)).numpy()
    assert got.shape == want.shape == (1, t_mel * 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ---- the resblock stage at C = 8 (K2 at pack 16) and the bf16 generator --------


def test_resblock_stage_c8_matches_pallas_pack16():
    """The plain twin at C = 8 vs ``resblock_group_packed`` at pack 16 (16
    frames of 8 channels in 128 lanes) in interpret mode: float32 taps, and
    bf16 tap stacks through the bf16 twin (4 times closer than float32)."""
    c, p, s = 8, 16, 21
    ksizes, dsizes = [3, 7, 11], [[1, 3, 5]] * 3
    assert channels_supported(c)
    rng = np.random.default_rng(12)
    stage = _stage_params(rng, c, ksizes, dsizes)
    x = rng.normal(size=(2, s * p, c)).astype(np.float32)
    w32, b32 = _flat(stage, ksizes, dsizes)

    def pallas(dtype):
        w, b = prepare_resblock_stage(stage, ksizes, dsizes, p, dtype=dtype)
        return np.asarray(pk.unpack(resblock_group_packed(
            pk.pack(jnp.asarray(x), p), w, b, ksizes, dsizes, p, rows_per_block=16,
            interpret=True), c))

    f32 = resblock_stage(torch.from_numpy(x), w32, b32, ksizes, dsizes).numpy()
    np.testing.assert_allclose(f32, pallas(jnp.float32), atol=1e-5)
    want16 = pallas(jnp.bfloat16)
    got16 = resblock_stage(torch.from_numpy(x), w32.to(BF16), b32, ksizes, dsizes).numpy()
    err, err32 = peak_err(got16, want16), peak_err(f32, want16)
    assert err < 5e-3 and err < err32 / 4, (err, err32)


def test_hifigan_bf16_matches_packed_runner(monkeypatch):
    """From 64 channels (stages 32, 16, 8): the port with bf16 taps (each
    stage through the bf16 twin, the card's route) vs
    ``PackedHifiGanRunner(fused_res_dtype=bfloat16)`` (its fused kernels at
    packs 4, 8, 16 in interpret mode), within the JAX bound for bf16 tap
    stacks; the stage gate is the JAX one at this length."""
    gen = _hifigan(H_C8, seed=13, tap_dtype=BF16)
    params = jax.tree.map(jnp.asarray, jax_hifigan.convert_hifigan(_np_sd(gen), H_C8))
    jgen = jax_hifigan.HifiGanGenerator.from_config(H_C8, use_packed=True)
    assert jgen._packed_supported(8) and gen._packed_supported(8)
    assert gen.stage_tap_dtypes(8) == (BF16,) * 3
    mel = np.random.default_rng(14).normal(size=(1, 8, 80)).astype(np.float32)
    runner = jax_hifigan.PackedHifiGanRunner(jgen, fused_res_dtype=jnp.bfloat16)
    prepared = runner.prepare(params)
    assert all(f"resfused_{i}" in prepared for i in range(3))
    want = np.asarray(runner(prepared, jnp.asarray(mel)))
    seen = []
    orig = port_nsf.resblock_stage
    monkeypatch.setattr(port_nsf, "resblock_stage",
                        lambda x, w, *a: seen.append((x.shape[-1], w.dtype)) or orig(x, w, *a))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert seen == [(32, BF16), (16, BF16), (8, BF16)]
    assert got.shape == want.shape == (1, 256)
    assert np.abs(got - want).max() < 0.05
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_hifigan_tap_dtype_follows_hifigan_packed():
    """bf16 stacks only in ``fast`` mode on a CUDA device with
    ``hifigan_packed`` unset or true (the JAX runner's auto dtype on its
    accelerator); a ResBlock2 or gate-refused generator stays float32."""
    from prodiff_tpu_torch import device as policy

    try:
        for mode in ("parity", "fast"):
            policy.set_precision(mode)
            for packed in (None, True, False):
                hp = {} if packed is None else {"hifigan_packed": packed}
                for dev in ("cpu", "cuda"):
                    want = BF16 if (mode == "fast" and dev == "cuda" and packed is not False) \
                        else torch.float32
                    assert policy.hifigan_tap_dtype(hp, dev) == want
    finally:
        policy.set_precision("parity")
    assert _hifigan(H_RB2, tap_dtype=BF16).stage_tap_dtypes(8) == (torch.float32,) * 3


# ---- the vocoders and their checkpoints ----------------------------------------


def _weight_norm_split(sd: dict) -> dict:
    """Each conv weight as ``weight_g``/``weight_v`` (g the norm over every
    dim but the output channel's), as a checkpoint saved under weight norm."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 3:
            base = k[: -len(".weight")]
            out[base + ".weight_g"] = v.norm(dim=(1, 2), keepdim=True)
            out[base + ".weight_v"] = v
        else:
            out[k] = v
    return out


def _write_hifigan(tmp_path, layout, h, seed=15):
    """A seeded HiFi-GAN in ``layout``: ``framework`` (config.yaml + the
    newest of two model_ckpt_steps_*.ckpt, the generator under ``model_gen.``
    beside a discriminator) or ``release`` (config.json + generator_v1)."""
    gen = _hifigan(h, seed=seed, out_scale=0.3)
    sd = _weight_norm_split(gen.state_dict())
    d = tmp_path / f"hifigan_{layout}"
    d.mkdir()
    if layout == "framework":
        with open(d / "config.yaml", "w") as f:
            yaml.dump(dict(h, **AUDIO), f)
        stale = {f"model_gen.{k}": torch.zeros_like(v) for k, v in sd.items()}
        torch.save({"state_dict": stale}, d / "model_ckpt_steps_9.ckpt")
        full = {f"model_gen.{k}": v for k, v in sd.items()}
        full["model_disc.conv.weight"] = torch.ones(2, 1, 3)
        torch.save({"state_dict": full}, d / "model_ckpt_steps_10.ckpt")
    else:
        with open(d / "config.json", "w") as f:
            json.dump(h, f)
        torch.save({"generator": sd}, d / "generator_v1")
    return gen, str(d)


def _write_pwg(tmp_path, cfg, seed=16):
    """A seeded PWG as the upstream recipe saves it: config.yaml + the newest
    of two checkpoint-*steps.pkl (``{"model": {"generator", "discriminator"}}``)."""
    gen = ParallelWaveGANGenerator.from_config(cfg).eval()
    _fan_in_init(gen, seed, out_scale=0.2)
    d = tmp_path / "pwg"
    d.mkdir()
    with open(d / "config.yaml", "w") as f:
        yaml.dump(dict(cfg, **AUDIO), f)
    sd = _weight_norm_split(gen.state_dict())
    for steps, weights in ((2000, {k: torch.zeros_like(v) for k, v in sd.items()}),
                           (40000, sd)):
        torch.save({"model": {"generator": weights, "discriminator": {"w": torch.ones(3)}},
                    "steps": steps}, d / f"checkpoint-{steps}steps.pkl")
    return gen, str(d)


@pytest.mark.parametrize("layout", ["framework", "release"])
def test_hifigan_vocoder_layouts_match_jax(tmp_path, layout, monkeypatch):
    """The wrapper reads both HiFi-GAN layouts (weight norm folded, the
    newest step, ``model_gen.`` stripped, the discriminator left out) into
    the generator's weights, and ``spec2wav`` with ``use_nsf`` and injected
    draws equals the JAX vocoder's; without ``use_nsf`` the f0 is ignored."""
    gen, d = _write_hifigan(tmp_path, layout, H_PITCH)
    hp = {"vocoder_ckpt": d, "use_nsf": True}
    voc = get_vocoder_cls("hifigan")(hp, device="cpu")
    assert isinstance(voc, HifiGAN)
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(voc.model.state_dict()[k], v, atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(17)
    mel = rng.normal(size=(9, 80)).astype(np.float32)
    f0 = rng.uniform(100, 400, 9).astype(np.float32)
    rand_ini, noise = _draws(rng, 1, 9 * 32)
    got = voc.spec2wav(mel, f0=f0, draws=(torch.from_numpy(rand_ini), torch.from_numpy(noise)))
    no_nsf = HifiGAN({"vocoder_ckpt": d}, device="cpu")
    got_plain = no_nsf.spec2wav(mel, f0=f0)
    jvoc = jax_get_vocoder_cls("hifigan")(hp)
    want_plain = jax_get_vocoder_cls("hifigan")({"vocoder_ckpt": d}).spec2wav(mel, f0=f0)
    _jax_draws(monkeypatch, rand_ini, noise)
    want = jvoc.spec2wav(mel, f0=f0)
    assert got.shape == want.shape == (9 * 32,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_plain, want_plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got_plain, no_nsf.spec2wav(mel))


def test_pwg_vocoder_layout_matches_jax(tmp_path, monkeypatch):
    """``checkpoint-*steps.pkl``: the newest one's generator, weight norm
    folded; ``spec2wav`` on an injected ``z`` (and from a seeded generator)
    with the pitch embed vs the JAX vocoder on the same ``z``."""
    gen, d = _write_pwg(tmp_path, PWG_PITCH_CFG)
    voc = get_vocoder_cls("pwg")({"vocoder_ckpt": d}, device="cpu")
    assert isinstance(voc, PWG)
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(voc.model.state_dict()[k], v, atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(18)
    mel = rng.normal(size=(7, 12)).astype(np.float32)
    f0 = rng.uniform(100, 400, 7).astype(np.float32)
    z = rng.normal(size=(1, 7 * 32, 1)).astype(np.float32)
    got = voc.spec2wav(mel, f0=f0, z=torch.from_numpy(z))
    seeded = voc.spec2wav(mel, f0=f0, generator=torch.Generator().manual_seed(3))
    z3 = torch.randn((1, 7 * 32, 1), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(seeded, voc.spec2wav(mel, f0=f0, z=z3))
    _inject(monkeypatch, "normal", z)
    want = jax_get_vocoder_cls("pwg")({"vocoder_ckpt": d}).spec2wav(mel, f0=f0)
    assert got.shape == want.shape == (7 * 32,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_vocoder_checkpoint_errors(tmp_path):
    """A PWG directory without a checkpoint and a checkpoint that lacks a
    generator key raise."""
    d = tmp_path / "empty"
    d.mkdir()
    (d / "config.yaml").write_text(yaml.dump(PWG_CFG))
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        PWG({"vocoder_ckpt": str(d)}, device="cpu")
    sd = ParallelWaveGANGenerator.from_config(PWG_CFG).state_dict()
    del sd["first_conv.weight"]
    with pytest.raises(KeyError, match="first_conv.weight"):
        PWG({}, state_dict=sd, config=PWG_CFG, device="cpu")


def test_denoise_matches_jax():
    """Spectral subtraction at the JAX defaults and at a 1024-sample window."""
    wav = np.random.default_rng(19).normal(size=6000).astype(np.float32) * 0.3
    for kw in ({}, {"v": 0.05, "fft_size": 1024, "hop_size": 256, "win_size": 1024}):
        got = denoise(torch.from_numpy(wav), **kw).numpy()
        want = jax_denoise(wav, **kw)
        assert got.shape == want.shape == wav.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=2e-3)


def test_hifigan_denoise_hparam():
    """``vocoder_denoise_c`` > 0 runs ``denoise`` on the render."""
    gen = _hifigan(H, seed=20, out_scale=0.3)
    h = dict(H, **AUDIO)
    hp = {"vocoder_denoise_c": 0.01, "fft_size": 512, "hop_size": 32, "win_size": 512}
    mel = np.random.default_rng(21).normal(size=(40, 80)).astype(np.float32)
    raw = HifiGAN({}, state_dict=gen.state_dict(), config=h, device="cpu").spec2wav(mel)
    den = HifiGAN(hp, state_dict=gen.state_dict(), config=h, device="cpu").spec2wav(mel)
    want = denoise(torch.from_numpy(raw), 0.01, 512, 32, 512).numpy()
    np.testing.assert_allclose(den, want, atol=1e-6)
    assert np.abs(den - raw).max() > 1e-4


# ---- vocode wav2wav -------------------------------------------------------------


def test_vocode_cli_hifigan_matches_jax(tmp_path, monkeypatch):
    """``vocode wav2wav`` on a directory of two wavs through HiFi-GAN with its
    NSF source (``use_nsf``, the release layout, ACF pitch, keyshift +2) vs
    the JAX pipeline, the same draws injected into both renders."""
    _, d = _write_hifigan(tmp_path, "release", H_PITCH)
    hp = dict(AUDIO, vocoder="hifigan", vocoder_ckpt=d, use_nsf=True, pitch_extractor="acf")
    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.dump(hp))
    in_dir = _write_inputs(tmp_path, 22050, 0.3, ["a", "b"])
    draws = {}

    def fixed(n):
        if n not in draws:
            draws[n] = _draws(np.random.default_rng(22 + n), 1, n * 32)
        return draws[n]

    render = HifiGAN.spec2wav
    monkeypatch.setattr(HifiGAN, "spec2wav", lambda self, mel, **kw: render(
        self, mel, draws=tuple(map(torch.from_numpy, fixed(len(mel)))), **kw))
    out = tmp_path / "out"
    port_cli(["vocode", "wav2wav", str(in_dir), "--config", str(cfg), "--keyshift", "2",
              "--output_dir", str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["a.wav", "b.wav"]

    def jax_render(v, mel, f0):
        rand_ini, noise = fixed(len(mel))
        with monkeypatch.context() as m:
            _jax_draws(m, rand_ini, noise)
            return v.spec2wav(mel, f0=f0)

    for name in ("a", "b"):
        want_path = str(tmp_path / f"jax_{name}.wav")
        mel = _jax_wav2wav(str(cfg), str(in_dir / f"{name}.wav"), 2, want_path, jax_render)
        _assert_wavs_close(str(out / f"{name}.wav"), want_path, len(mel) * 32)


def test_vocode_cli_pwg_matches_jax(tmp_path, monkeypatch):
    """``vocode wav2wav`` on one wav through PWG (the ``checkpoint-*steps.pkl``
    layout, ACF pitch, no pitch embed) vs the JAX pipeline on the same ``z``."""
    cfg_pwg = {"hop_size": 32, "generator_params": dict(PWG_CFG["generator_params"],
                                                        aux_channels=80)}
    _, d = _write_pwg(tmp_path, cfg_pwg)
    hp = dict(AUDIO, vocoder="pwg", vocoder_ckpt=d, pitch_extractor="acf")
    cfg = tmp_path / "vocoder.yaml"
    cfg.write_text(yaml.dump(hp))
    in_dir = _write_inputs(tmp_path, 22050, 0.25, ["a"])
    zs = {}

    def fixed(n):
        if n not in zs:
            zs[n] = np.random.default_rng(23).normal(size=(1, n * 32, 1)).astype(np.float32)
        return zs[n]

    render = PWG.spec2wav
    monkeypatch.setattr(PWG, "spec2wav", lambda self, mel, **kw: render(
        self, mel, z=torch.from_numpy(fixed(len(mel))), **kw))
    out = tmp_path / "out"
    port_cli(["vocode", "wav2wav", str(in_dir / "a.wav"), "--config", str(cfg),
              "--output_dir", str(out), "--device", "cpu"])

    def jax_render(v, mel, f0):
        with monkeypatch.context() as m:
            _inject(m, "normal", fixed(len(mel)))
            return v.spec2wav(mel, f0=f0)

    want_path = str(tmp_path / "jax_a.wav")
    mel = _jax_wav2wav(str(cfg), str(in_dir / "a.wav"), 0, want_path, jax_render)
    _assert_wavs_close(str(out / "a.wav"), want_path, len(mel) * 32)


def test_registry_has_every_jax_vocoder():
    """The port's registry names every vocoder of the JAX registry."""
    from prodiff_tpu.vocoders import VOCODERS as JAX_VOCODERS
    from prodiff_tpu_torch.vocoders import VOCODERS

    get_vocoder_cls("nsfhifigan")
    jax_get_vocoder_cls("nsfhifigan")
    assert {k.lower() for k in JAX_VOCODERS} == set(VOCODERS)
    with pytest.raises(ValueError, match="not found"):
        get_vocoder_cls("wavegrad")


def test_chip_smoke_mirrors_the_other_vocoder_cells():
    """``chip_smoke.py``'s other-vocoders phase: HiFi-GAN V1/V2/V3 as the
    published config_v1/v2/v3.json, PWG as the JAX module's defaults
    (parallel_wavegan.v1), each upsampling to the LJSpeech hop of its audio
    settings; the launches it expects (18 a ResBlock1 stage, or 9 with bf16
    taps at C >= 16, a launch a fused unit; 18 more on the C = 8 counter for
    V2's last stage; none for ResBlock2 or PWG) and the stage shapes it times
    at T_mel = 512."""
    from prodiff_tpu_torch.ops.resblock import stage_launches
    import chip_smoke as cs

    v1 = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
          "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 512,
          "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    v3 = {"resblock": "2", "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
          "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 5, 7],
          "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]]}
    for got, want in ((cs.HIFIGAN_V1, v1), (cs.HIFIGAN_V2, dict(v1, upsample_initial_channel=128)),
                      (cs.HIFIGAN_V3, v3)):
        assert {k: got[k] for k in want} == want
    jp, gp = JaxPWG(), cs.PWG_V1["generator_params"]
    for key in ("layers", "stacks", "residual_channels", "gate_channels", "skip_channels",
                "aux_channels", "aux_context_window", "kernel_size"):
        assert gp[key] == getattr(jp, key), key
    assert tuple(gp["upsample_params"]["upsample_scales"]) == tuple(jp.upsample_scales)
    hop = cs.VOCODE_FD_AUDIO["hop_size"]
    assert cs.VOCODE_FD_AUDIO["audio_num_mel_bins"] == gp["aux_channels"] == 80
    assert cs.PWG_V1["hop_size"] == hop == int(np.prod(gp["upsample_params"]["upsample_scales"]))
    assert cs.OTHER_SAMPLES == 6 * cs.VOCODE_FD_AUDIO["audio_sample_rate"]
    for name, cfg, kind, _, mode, n_res, n_c8 in cs.OTHER_CELLS:
        if kind == "pwg":
            assert (n_res, n_c8) == (0, 0)
            continue
        rates, c0 = cfg["upsample_rates"], cfg["upsample_initial_channel"]
        assert int(np.prod(rates)) == hop
        widths = [c0 // 2 ** (i + 1) for i in range(len(rates))]
        taps = torch.bfloat16 if mode == "fast" else torch.float32
        ks, ds = cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]
        assert n_res == (sum(stage_launches(c, taps, ks, ds) for c in widths)
                         if cfg["resblock"] == "1" else 0), name
        assert n_c8 == (widths.count(8) if cfg["resblock"] == "1" else 0), name  # a launch a stage
    for model, cfg in (("V1", cs.HIFIGAN_V1), ("V2", cs.HIFIGAN_V2)):
        rates, c0 = cfg["upsample_rates"], cfg["upsample_initial_channel"]
        want = tuple((c0 // 2 ** (i + 1), 512 * int(np.prod(rates[:i + 1])))
                     for i in range(len(rates)))
        assert cs.HIFIGAN_STAGES[model] == want
