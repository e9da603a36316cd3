"""NSF-HiFiGAN in the PyTorch port vs the JAX package, on the CPU.

Covers the harmonic sine source, the ResBlock1 stage (the plain twin of the
``resblock_stage`` kernel vs the Pallas ``resblock_group_packed`` /
``resblock_group_streamed`` in interpret mode) and the whole generator,
deterministic, at the tiny ``VOCODER_H`` size of ``tests/test_cli_e2e.py``.
Weights are the JAX params carried over by ``nsf_hifigan_state_dict``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu.models.nsf_hifigan import Generator as JaxGenerator
from prodiff_tpu.models.nsf_hifigan import sine_gen
from prodiff_tpu_torch.models.nsf_hifigan import Generator, sine_source
from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain
from prodiff_tpu_torch.utils.convert import nsf_hifigan_state_dict

VOCODER_H = {
    "num_mels": 16,
    "sampling_rate": 44100,
    "upsample_initial_channel": 32,
    "upsample_rates": [4, 4, 2],
    "upsample_kernel_sizes": [8, 8, 4],
    "resblock": "1",
    "resblock_kernel_sizes": [3, 7],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
}
RNG = np.random.default_rng(11)


def _f0(b, t):
    f0 = RNG.uniform(80, 600, size=(b, t)).astype(np.float32)
    f0[:, : t // 4] = 0.0  # unvoiced head exercises the uv gate
    return f0


def test_sine_source_matches_jax():
    """Deterministic source over 600 frames at upp=512. The phase carry is
    float64 here and a float32 scan in JAX; after 600 frames the carries
    differ by ~1e-5 cycles, so the 0.1-amplitude sines agree to 1e-4."""
    f0 = _f0(2, 600)
    want = sine_gen(jnp.asarray(f0), 512, 44100, 8, None)
    got = sine_source(torch.from_numpy(f0), 512, 44100, 8)
    assert got.shape == want.shape == (2, 600 * 512, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _stage_params(c, ksizes, dsizes, scale=0.05):
    stage = []
    for k, ds in zip(ksizes, dsizes):
        rb = {}
        for li in range(len(ds)):
            for grp in ("convs1", "convs2"):
                rb[f"{grp}_{li}"] = {"conv": {
                    "kernel": RNG.normal(size=(k, c, c)).astype(np.float32) * scale,
                    "bias": RNG.normal(size=(c,)).astype(np.float32) * 0.1,
                }}
        stage.append(rb)
    return stage


def _flat(stage, ksizes, dsizes):
    """A stage's JAX params in the port's ``resblock_stage`` layout."""
    ws, bs = [], []
    for rb, ds in zip(stage, dsizes):
        for li in range(len(ds)):
            for grp in ("convs1", "convs2"):
                ws.append(rb[f"{grp}_{li}"]["conv"]["kernel"].ravel())
                bs.append(rb[f"{grp}_{li}"]["conv"]["bias"])
    return torch.from_numpy(np.concatenate(ws)), torch.from_numpy(np.stack(bs))


@pytest.mark.parametrize("c,s", [(64, 37), (32, 48), (16, 37)])
def test_resblock_plain_matches_pallas_packed(c, s):
    """The C <= 128 stages: K2 (``resblock_group_packed``) on the packed
    [B, T/P, 128] layout, unpacked and held against the port's [B, T, C]."""
    from prodiff_tpu.ops import packed as pk
    from prodiff_tpu.ops.pallas.resblock import prepare_resblock_stage, resblock_group_packed

    p = 128 // c
    ksizes, dsizes = [3, 5], [[1, 3], [1, 2]]
    stage = _stage_params(c, ksizes, dsizes, scale=0.1)
    w, b = prepare_resblock_stage(stage, ksizes, dsizes, p, dtype=jnp.float32)
    x = RNG.normal(size=(2, s * p, c)).astype(np.float32)
    want = pk.unpack(resblock_group_packed(pk.pack(jnp.asarray(x), p), w, b, ksizes, dsizes, p,
                                           rows_per_block=16, interpret=True), c)
    got = resblock_stage(torch.from_numpy(x), *_flat(stage, ksizes, dsizes), ksizes, dsizes)
    assert got.shape == (2, s * p, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


def test_resblock_plain_matches_pallas_streamed():
    """The C = 256 stage: K3 (``resblock_group_streamed``), odd length."""
    from prodiff_tpu.ops.pallas.resblock import prepare_resblock_stage, resblock_group_streamed

    c, ksizes, dsizes = 256, [3, 5], [[1, 3], [1, 2]]
    stage = _stage_params(c, ksizes, dsizes)
    w, b = prepare_resblock_stage(stage, ksizes, dsizes, 1, dtype=jnp.float32)
    x = RNG.normal(size=(2, 37, c)).astype(np.float32)
    want = resblock_group_streamed(jnp.asarray(x), w, b, ksizes, dsizes,
                                   rows_per_block=16, interpret=True)
    got = resblock_stage_plain(torch.from_numpy(x), *_flat(stage, ksizes, dsizes), ksizes, dsizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


@functools.lru_cache(maxsize=1)
def _jax_generator(t_mel=24, b=2):
    """The JAX generator, its params and a seeded input (built once per process:
    the flax init costs seconds)."""
    rng = np.random.default_rng(12)
    jgen = JaxGenerator.from_config(VOCODER_H, use_packed=False)
    mel = rng.normal(size=(b, t_mel, VOCODER_H["num_mels"])).astype(np.float32) - 3
    f0 = rng.uniform(80, 600, size=(b, t_mel)).astype(np.float32)
    f0[:, : t_mel // 4] = 0.0
    params = jax.jit(jgen.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                jnp.asarray(mel), jnp.asarray(f0))
    return jgen, params, mel, f0


def generator_pair():
    """(JAX generator, its params, port Generator carrying them, mel, f0)."""
    jgen, params, mel, f0 = _jax_generator()
    gen = Generator.from_config(VOCODER_H)
    gen.load_state_dict(nsf_hifigan_state_dict(params, VOCODER_H))
    return jgen, params, gen, mel, f0


def test_generator_matches_linen():
    """Deterministic render (zero-phase, noise-free source)."""
    jgen, params, gen, mel, f0 = generator_pair()
    want = jgen.apply(params, jnp.asarray(mel), jnp.asarray(f0), deterministic=True)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), torch.from_numpy(f0))
    assert got.shape == want.shape == (2, 24 * 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_weights_feed_resblock_stage(stage):
    """The Generator's CUDA route per stage: ``resblock_stage`` on
    ``stage_weights()`` (its plain twin for CPU tensors) equals the mean of
    the stage's ResBlock1 modules on the carried weights."""
    *_, gen, _, _ = generator_pair()
    n = len(gen.resblock_kernel_sizes)
    c = gen.ups[stage].out_channels
    x = torch.from_numpy(RNG.normal(size=(2, 45, c)).astype(np.float32))
    w, b = gen.stage_weights()[stage]
    before = resblock_stage.launches.count
    with torch.no_grad():
        got = resblock_stage(x, w, b, gen.resblock_kernel_sizes, gen.resblock_dilation_sizes)
        blocks = gen.resblocks[stage * n: (stage + 1) * n]
        want = sum(rb(x.transpose(1, 2)) for rb in blocks).transpose(1, 2) / n
    assert resblock_stage.launches.count == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=1e-3)


def test_generator_noise_comes_from_the_generator():
    """With a torch.Generator the source draws phases/noise from it alone."""
    *_, gen, mel, f0 = generator_pair()
    run = lambda seed: gen(torch.from_numpy(mel), torch.from_numpy(f0),  # noqa: E731
                           torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
