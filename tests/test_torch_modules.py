"""PyTorch port vs the JAX package, module by module, on the CPU.

Inputs are made with numpy from a seed and handed to both; weights are the
JAX params carried into the port by ``prodiff_tpu_torch/utils/convert.py``.
Where the JAX function reaches a Pallas kernel it runs in interpret mode, as
the JAX package's own tests run it. Module-level tolerance: atol 2e-4 /
rtol 1e-3, as in the JAX package's tests (float32 on both sides; the sums run
in another order).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu.models.encoder import FastspeechEncoder as JaxEncoder
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.models.wavenet import WaveNet as JaxWaveNet
from prodiff_tpu.ops import seq as jax_seq
from prodiff_tpu_torch import device
from prodiff_tpu_torch.models.encoder import FastspeechEncoder
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops import seq
from prodiff_tpu_torch.ops.wavenet_stack import residual_stack, residual_stack_plain
from prodiff_tpu_torch.utils.convert import (
    encoder_state_dict,
    teacher_state_dict,
    wavenet_state_dict,
)

ATOL, RTOL = 2e-4, 1e-3

TEACHER_HP = {
    "audio_num_mel_bins": 16,
    "hidden_size": 32,
    "enc_layers": 2,
    "enc_ffn_kernel_size": 9,
    "dropout": 0.1,
    "num_heads": 2,
    "use_dur_embed": True,
    "use_spk_id": True,
    "num_spk": 3,
    "use_gender_id": True,
    "use_lang_id": True,
    "languages": {"zh": 1, "en": 2},
    "use_voicing_embed": True,
    "use_breath_embed": True,
    "residual_layers": 4,
    "residual_channels": 32,
    "dilation_cycle_length": 1,
    "diff_type": "prodiff",
    "timesteps": 4,
    "timescale": 1000,
    "schedule_type": "vpsde",
    "max_beta": 40,
}


def perturb(params, seed=1, scale=0.05):
    """Add seeded noise to every leaf (the JAX init zeroes the WaveNet's
    output projection, which would make any comparison trivial)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: a + scale * rng.normal(size=a.shape).astype(np.float32), params
    )


def to_np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


def text_batch(rng, b=2, t_txt=7, t_mel=20, vocab=12):
    tokens = rng.integers(1, vocab, size=(b, t_txt))
    tokens[1, 5:] = 0
    dur = rng.integers(1, 4, size=(b, t_txt)) * (tokens > 0)
    mel2ph = np.zeros((b, t_mel), np.int64)
    for r in range(b):
        m = np.repeat(np.arange(1, t_txt + 1), dur[r])[:t_mel]
        mel2ph[r, : len(m)] = m
    return tokens.astype(np.int64), mel2ph


def test_precision_policy_pins_tf32_off():
    device.set_precision(device.PARITY)
    assert device.precision() == "parity"
    assert device.compute_dtype() == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(NotImplementedError, match="bf16"):
        device.set_precision("bf16")


def test_seq_ops_match_jax():
    rng = np.random.default_rng(0)
    _, mel2ph = text_batch(rng)
    enc = rng.normal(size=(2, 7, 8)).astype(np.float32)
    close(seq.mel2ph_to_dur(torch.from_numpy(mel2ph), 7),
          jax_seq.mel2ph_to_dur(jnp.asarray(mel2ph), 7), atol=0, rtol=0)
    got = seq.regulate_hidden(torch.from_numpy(enc), torch.from_numpy(mel2ph))
    close(got, jax_seq.regulate_hidden(jnp.asarray(enc), jnp.asarray(mel2ph)), atol=0, rtol=0)
    assert not to_np(got)[mel2ph == 0].any()  # mel2ph == 0 frames gather zeros


def test_encoder_matches_jax():
    rng = np.random.default_rng(1)
    tokens, _ = text_batch(rng)
    extra = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jenc = JaxEncoder(vocab_size=12, hidden_size=32, num_layers=2)
    params = perturb(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(extra)))
    want = jax.jit(jenc.apply)(params, jnp.asarray(tokens), jnp.asarray(extra))
    enc = FastspeechEncoder(12, 32, 2)
    enc.load_state_dict(encoder_state_dict(params["params"], 2, prefix=""))
    got = enc(torch.from_numpy(tokens), torch.from_numpy(extra))
    close(got, want)


def wavenet_pair(rng, c=128, dilation_cycle_length=1, n_layers=4):
    jnet = JaxWaveNet(in_dims=16, hidden_size=32, residual_layers=n_layers,
                      residual_channels=c, dilation_cycle_length=dilation_cycle_length,
                      use_pallas=False)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 32)).astype(np.float32)
    t = np.array([1, 3])
    params = perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                        jnp.asarray(cond)))
    net = WaveNet(16, 32, n_layers, c, dilation_cycle_length)
    net.load_state_dict(wavenet_state_dict(params["params"], n_layers, prefix=""))
    return jnet, params, net, x, t, cond


@pytest.mark.parametrize("dilation_cycle_length", [1, 2])
def test_wavenet_plain_matches_linen(dilation_cycle_length):
    rng = np.random.default_rng(2)
    jnet, params, net, x, t, cond = wavenet_pair(rng, 64, dilation_cycle_length)
    want = jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    close(got, want)


def test_kernel_route_matches_pallas_wavenet():
    """The module's CUDA route, composed on the CPU as ``WaveNet.forward``
    composes it (stacked weights -> ``residual_stack``, which for CPU tensors
    is the kernel's plain twin), vs ``wavenet_apply_pallas``."""
    from jax.experimental.pallas import tpu as pltpu

    from prodiff_tpu.ops.pallas.wavenet import stack_wavenet_params, wavenet_apply_pallas
    from prodiff_tpu_torch.models.wavenet import conv1x1

    rng = np.random.default_rng(3)
    _, params, net, x, t, cond = wavenet_pair(rng)
    jw = stack_wavenet_params(params, 4)
    w = net.stacked_weights()
    close(w.dilated_w, jw.dilated_w, atol=0, rtol=0)
    close(w.cond_w, jw.cond_w, atol=0, rtol=0)
    close(w.out_w, jw.out_w, atol=0, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        want = wavenet_apply_pallas(jw, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    before = residual_stack.launches.count
    with torch.no_grad():
        h = torch.relu(conv1x1(torch.from_numpy(x), net.input_projection))
        step = net.mlp(net.diffusion_embedding(torch.from_numpy(t)))
        h = residual_stack(h, torch.from_numpy(cond), step, w)
        got = conv1x1(torch.relu(conv1x1(h, net.skip_projection)), net.output_projection)
    assert residual_stack.launches.count == before  # CPU tensors launch nothing
    close(got, want)
    close(net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)), want)


@pytest.mark.parametrize("t_len,tiled", [(16, False), (16, True)])
def test_residual_stack_plain_matches_pallas_kernels(t_len, tiled):
    """K1's plain twin vs ``fused_residual_stack`` and, at T > tile, vs
    ``fused_residual_stack_tiled`` (the Hopper entry serves both)."""
    from jax.experimental.pallas import tpu as pltpu

    from prodiff_tpu.ops.pallas.wavenet import (
        fused_residual_stack,
        fused_residual_stack_tiled,
        stack_wavenet_params,
    )

    rng = np.random.default_rng(4)
    _, params, net, *_ = wavenet_pair(rng)
    jw = stack_wavenet_params(params, 4)
    x0 = rng.normal(size=(t_len, 128)).astype(np.float32)
    cond = rng.normal(size=(t_len, 32)).astype(np.float32)
    step = rng.normal(size=(1, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if tiled:
            want = fused_residual_stack_tiled(jnp.asarray(x0), jnp.asarray(cond),
                                              jnp.asarray(step), jw, tile=8, halo=4)
        else:
            want = fused_residual_stack(jnp.asarray(x0), jnp.asarray(cond), jnp.asarray(step), jw)
    got = residual_stack_plain(torch.from_numpy(x0)[None], torch.from_numpy(cond)[None],
                               torch.from_numpy(step), net.stacked_weights())
    close(got[0], want)


@functools.lru_cache(maxsize=1)
def _jax_teacher(seed=5, vocab=12):
    """The JAX teacher, perturbed params and seeded inputs (built once per
    process: the flax init costs seconds)."""
    hp = TEACHER_HP
    rng = np.random.default_rng(seed)
    tokens, mel2ph = text_batch(rng, vocab=vocab)
    b, t_mel = mel2ph.shape
    inputs = {
        "tokens": tokens,
        "mel2ph": mel2ph,
        "f0": rng.uniform(100, 500, size=(b, t_mel)).astype(np.float32),
        "lang": (tokens > 0).astype(np.int64),
        "spk_mix": rng.normal(size=(b, 1, 32)).astype(np.float32),
        "gender_mix": rng.normal(size=(b, 1, 32)).astype(np.float32),
        "voicing": np.full((b, t_mel), -10.0, np.float32),
        "breath": rng.uniform(-60, -20, size=(b, t_mel)).astype(np.float32),
        "init_noise": rng.uniform(size=(b, 1, t_mel, 16)).astype(np.float32),
        "step_noises": rng.normal(size=(4, b, 1, t_mel, 16)).astype(np.float32),
    }
    jmodel = JaxTeacher(vocab_size=vocab, hparams=hp)
    ji = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jax.jit(functools.partial(jmodel.init, infer=True))(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
        ji["tokens"], ji["mel2ph"], ji["f0"], lang_seq=ji["lang"],
        spk_embed_id=jnp.zeros((b,), jnp.int32), gender_embed_id=jnp.zeros((b,), jnp.int32),
        voicing=ji["voicing"], breath=ji["breath"],
    )
    return jmodel, perturb(params), inputs


def teacher_pair():
    """(JAX teacher, its params, port teacher carrying them, numpy inputs)."""
    jmodel, params, inputs = _jax_teacher()
    model = ProDiffTeacher(12, TEACHER_HP)
    model.load_state_dict(teacher_state_dict(params, TEACHER_HP))
    return jmodel, params, model, inputs


def test_teacher_4step_infer_matches_jax():
    """4-step sampling with injected noise, held at the module tolerance: four
    chained denoiser passes do not grow the float32 ordering differences
    (measured ~5e-7 on a mel of scale 1)."""
    jmodel, params, model, inp = teacher_pair()
    ji = {k: jnp.asarray(v) for k, v in inp.items()}
    want = jax.jit(functools.partial(jmodel.apply, infer=True, infer_step=4))(
        params, ji["tokens"], ji["mel2ph"], ji["f0"], lang_seq=ji["lang"],
        spk_mix_embed=ji["spk_mix"], gender_mix_embed=ji["gender_mix"],
        voicing=ji["voicing"], breath=ji["breath"],
        init_noise=ji["init_noise"], step_noises=ji["step_noises"],
    )
    ti = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = model.infer(
        ti["tokens"], ti["mel2ph"], ti["f0"], infer_step=4,
        init_noise=ti["init_noise"], step_noises=ti["step_noises"],
        lang_seq=ti["lang"], spk_mix_embed=ti["spk_mix"],
        gender_mix_embed=ti["gender_mix"], voicing=ti["voicing"], breath=ti["breath"],
    )
    assert got.shape == (2, 20, 16)
    close(got, want)


def test_teacher_condition_matches_jax():
    jmodel, params, model, inp = teacher_pair()
    ji = {k: jnp.asarray(v) for k, v in inp.items()}
    spk = jnp.asarray([0, 2])
    want = jmodel.apply(
        params, ji["tokens"], ji["mel2ph"], ji["f0"], lang_seq=ji["lang"],
        spk_embed_id=spk, gender_embed_id=jnp.asarray([1, 0]),
        voicing=ji["voicing"], breath=ji["breath"], method=JaxTeacher.forward_condition,
    )
    ti = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = model.forward_condition(
        ti["tokens"], ti["mel2ph"], ti["f0"], lang_seq=ti["lang"],
        spk_embed_id=torch.tensor([0, 2]), gender_embed_id=torch.tensor([1, 0]),
        voicing=ti["voicing"], breath=ti["breath"],
    )
    close(got, want)
    assert not to_np(got)[inp["mel2ph"] == 0].any()


def test_port_imports_no_jax():
    """Importing the port and every submodule leaves jax/flax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import prodiff_tpu_torch\n"
        "for m in pkgutil.walk_packages(prodiff_tpu_torch.__path__, 'prodiff_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=repo_root)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
