"""The variance stack for serving: the PyTorch port vs the JAX package, on the CPU.

Modules (the note encoder, the duration, pitch and variance predictors, the
rectified flow, the multi-variance diffusion and a ``diff_type: reflow``
teacher) run on the same seeded numpy inputs with the JAX params carried
into the port by ``utils/convert.py``; the inferers, the handler's
``pred_*`` routes and the web's prediction routes read one experiment
directory whose checkpoints the JAX package wrote. The samplers' noise is
injected on both sides: the JAX modules' draws are replaced through their
``init_noise``/``step_noises`` arguments (a test-only wrapper of their
``__call__``), the port's are passed in. Tolerance: atol 2e-4 / rtol 1e-3,
as the earlier slices' (float32 on both sides); the host helpers are held
exactly.
"""

import functools
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prodiff_tpu.binarize.pitch_predictor import base_pitch_curve as jax_base_pitch_curve
from prodiff_tpu.config import load_base_config
from prodiff_tpu.infer import inferers as jax_inferers
from prodiff_tpu.infer.handler import SVSInferHandler as JaxHandler
from prodiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from prodiff_tpu.models.duration import DurPredictor as JaxDurPredictor
from prodiff_tpu.models.encoder import NoteEncoder as JaxNoteEncoder
from prodiff_tpu.models.pitch_predictor import PitchPredictor as JaxPitchPredictor
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.models.reflow import RectifiedFlow as JaxFlow
from prodiff_tpu.models.vari_predictor import VariPredictor as JaxVariPredictor
from prodiff_tpu.models.wavenet import WaveNet as JaxWaveNet
from prodiff_tpu.ops.seq import dur_to_mel2ph_host as jax_dur_to_mel2ph_host
from prodiff_tpu.serve.handler import WebHandler as JaxWebHandler
from prodiff_tpu.utils import ckpt_utils
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.binarize.pitch_predictor import base_pitch_curve
from prodiff_tpu_torch.infer.handler import SVSInferHandler
from prodiff_tpu_torch.infer.inferers import (
    DurPredictorInferer,
    PitchPredictorInferer,
    VariPredictorInferer,
    get_inferer_cls,
)
from prodiff_tpu_torch.models.diffusion import GaussianDiffusion
from prodiff_tpu_torch.models.duration import DurPredictor
from prodiff_tpu_torch.models.encoder import NoteEncoder
from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.reflow import RectifiedFlow
from prodiff_tpu_torch.models.vari_predictor import VariPredictor
from prodiff_tpu_torch.models.wavenet import WaveNet
from prodiff_tpu_torch.ops.seq import dur_to_mel2ph_host
from prodiff_tpu_torch.serve.handler import WebHandler
from prodiff_tpu_torch.utils import convert
from tests.test_torch_modules import TEACHER_HP, close, perturb, to_np
from tests.test_torch_slice import EXP, _request, make_experiment

T = torch.as_tensor
SPEAKERS = {"spk0": 0, "spk1": 1}


def small_hp(**overrides) -> dict:
    """The base config cut to 2 encoder layers of 64, WaveNets of 4 x 64,
    repeat_bins 8 (pitch) and 6 (three variance curves of 2 bins)."""
    hp = load_base_config()
    enc = {"hidden_size": 32, "num_layers": 2, "ffn_kernel_size": 9, "num_heads": 2}
    hp.update(  # num_spk 3 against 2 datasets: the variance and pitch speaker tables differ
        hidden_size=64, enc_layers=2, num_heads=2, num_spk=3, languages={"zh": 1},
        datasets=[{"speaker": s} for s in SPEAKERS], sampling_steps=3, seed=7,
        length_bucket_step=32,
        dur_prediction_args=dict(hp["dur_prediction_args"], num_layers=2, hidden_size=64),
        f0_prediction_args=dict(hp["f0_prediction_args"], repeat_bins=8, encoder_args=enc,
                                denoise_args={"dilation_cycle_length": 5, "residual_layers": 4,
                                              "residual_channels": 64}),
        vari_prediction_args=dict(hp["vari_prediction_args"], repeat_bins=6, encoder_args=enc,
                                  denoise_args={"dilation_cycle_length": 1, "residual_layers": 4,
                                                "residual_channels": 64}),
    )
    hp.update(overrides)
    return hp


def jax_init(model, *args, **kwargs):
    params = jax.jit(lambda rngs: model.init(rngs, *args, **kwargs))(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)})
    return perturb(params, scale=0.1)


JAX_PREDICTORS = {"dur": JaxDurPredictor, "pitch": JaxPitchPredictor, "vari": JaxVariPredictor}


@functools.lru_cache(maxsize=None)
def predictor_params(name: str):
    """Seeded, perturbed JAX params of a ``small_hp()`` predictor (vocabulary
    8), made once a session."""
    rng = np.random.default_rng(20)
    tokens, mel2ph = phone_batch(rng, 8, b=1)
    note_midi, note_rest, mel2note = note_batch(rng, b=1)
    model = JAX_PREDICTORS[name](vocab_size=8, hparams=small_hp())
    if name == "dur":
        return jax_init(model, tokens, tokens > 0, np.ones(tokens.shape, np.float32))
    spk = {"spk_id" if name == "pitch" else "spk_embed_id": np.array([1])}
    return jax_init(model, tokens, mel2ph, note_midi, note_rest, mel2note,
                    np.full(mel2ph.shape, 60.0, np.float32), infer=True, **spk)


def port_model(cls, vocab, hp, to_state_dict, params):
    model = cls(vocab, hp)
    model.load_state_dict(to_state_dict(jax.tree.map(np.asarray, params), hp))
    return model.eval()


@pytest.fixture
def inject(monkeypatch):
    """``inject(init_noise=..., step_noises=...)`` makes the JAX samplers
    start from (and the DDPM step with) the given noise."""
    def install(init_noise, step_noises=None):
        for cls, extra in ((JaxFlow, {}), (JaxDiffusion, {"step_noises": step_noises})):
            orig = cls.__dict__["__call__"]

            def call(self, *a, _orig=orig, _extra=extra, **kw):
                if kw.get("infer"):
                    kw["init_noise"] = jnp.asarray(init_noise)
                    kw.update({k: jnp.asarray(v) for k, v in _extra.items() if v is not None})
                return _orig(self, *a, **kw)
            monkeypatch.setattr(cls, "__call__", call)
    return install


def note_batch(rng, b=2, t_note=5, t_mel=40, pad_notes=1, pad_frames=4):
    """Notes (the last ``pad_notes`` padding: midi -1), rests, a mel2note
    that ends in ``pad_frames`` padding frames."""
    note_midi = rng.uniform(50, 70, (b, t_note)).astype(np.float32)
    note_midi[:, t_note - pad_notes:] = -1.0
    note_rest = rng.random((b, t_note)) < 0.3
    sung = t_note - pad_notes
    mel2note = np.repeat(np.arange(1, sung + 1), (t_mel - pad_frames) // sung)
    mel2note = np.pad(mel2note, (0, t_mel - len(mel2note)))[None].repeat(b, 0)
    return note_midi, note_rest, mel2note


def phone_batch(rng, vocab, b=2, t_ph=6, t_mel=40, pad=1):
    tokens = rng.integers(3, vocab, (b, t_ph))
    tokens[:, t_ph - pad:] = 0
    real = t_ph - pad
    mel2ph = np.repeat(np.arange(1, real + 1), (t_mel - 4) // real)
    return tokens, np.pad(mel2ph, (0, t_mel - len(mel2ph)))[None].repeat(b, 0)


# ---- modules -------------------------------------------------------------------

def test_note_encoder_matches_jax():
    rng = np.random.default_rng(0)
    note_midi, note_rest, mel2note = note_batch(rng)
    note_dur = rng.uniform(1, 9, note_midi.shape).astype(np.float32)
    jax_enc = JaxNoteEncoder(hidden_size=32, num_layers=2)
    params = jax_init(jax_enc, note_midi, note_rest, note_dur)
    want = jax_enc.apply(params, note_midi, note_rest, note_dur)
    enc = NoteEncoder(32, 2)
    enc.load_state_dict(convert._state_dict(
        convert._rebase(convert._note_encoder_entries(2), "note_encoder.", "", 1),
        jax.tree.map(np.asarray, params)))
    got = enc.eval()(T(note_midi), T(note_rest), T(note_dur))
    close(got, want)
    assert (to_np(got)[:, -1] == 0).all()  # the padding note


@pytest.mark.parametrize("infer", [True, False])
def test_dur_predictor_matches_jax(infer):
    """Padding tokens masked end to end; clamped at 0 only at inference."""
    hp, rng = small_hp(), np.random.default_rng(1)
    tokens, _ = phone_batch(rng, 8, t_ph=9, pad=3)
    onset = rng.integers(0, 2, tokens.shape)
    word_dur = rng.uniform(0.1, 0.6, tokens.shape).astype(np.float32)
    jax_model, params = JaxDurPredictor(vocab_size=8, hparams=hp), predictor_params("dur")
    want = jax_model.apply(params, tokens, onset, word_dur, infer=infer)
    model = port_model(DurPredictor, 8, hp, convert.dur_predictor_state_dict, params)
    got = model(T(tokens), T(onset), T(word_dur), infer=infer)
    close(got, want)
    assert (to_np(got) < 0).any() != infer


@pytest.mark.parametrize("algorithm", ["euler", "rk2", "rk4", "rk5", "midpoint"])
@pytest.mark.parametrize("mode", ["pitch", "mel"])
def test_rectified_flow_matches_jax(algorithm, mode):
    """Every stepper (an unknown name runs euler) in the pitch mode (clamp,
    repeat to repeat_bins, mean-decode) and the mel mode (per-bin bounds)."""
    rng = np.random.default_rng(2)
    b, t, h, bins = 2, 12, 16, 6
    if mode == "pitch":
        kw = dict(out_dims=bins, spec_min=(-8.0,), spec_max=(8.0,), repeat_bins=bins,
                  clamp_min=-12.0, clamp_max=12.0)
    else:
        kw = dict(out_dims=bins, spec_min=tuple(np.linspace(-12, -6, bins)),
                  spec_max=tuple(np.linspace(-1, 0, bins)))
    cond = rng.normal(size=(b, t, h)).astype(np.float32)
    noise = rng.normal(size=(b, 1, t, bins)).astype(np.float32)
    jax_flow = JaxFlow(denoise_fn=JaxWaveNet(in_dims=bins, hidden_size=h, residual_layers=2,
                                             residual_channels=16), time_scale=1000,
                       sampling_algorithm=algorithm, **kw)
    params = jax_init(jax_flow, cond, infer=True, init_noise=noise)
    want = jax_flow.apply(params, cond, infer=True, infer_step=3, init_noise=noise)
    flow = RectifiedFlow(WaveNet(bins, h, 2, 16), time_scale=1000, sampling_algorithm=algorithm,
                         **kw)
    flow.denoise_fn.load_state_dict(convert.wavenet_state_dict(
        jax.tree.map(np.asarray, params)["params"]["denoise_fn"], 2, prefix=""))
    got = flow.infer(T(cond), infer_step=3, init_noise=T(noise))
    assert got.shape == ((b, 1, t) if mode == "pitch" else (b, 1, t, bins))
    close(got, want)
    gt = rng.normal(size=(b, 1, t) if mode == "pitch" else (b, 1, t, bins)).astype(np.float32) * 9
    close(flow.norm_spec(T(gt)), jax_flow.apply(params, jnp.asarray(gt), method="norm_spec"))


def test_multi_variance_diffusion_matches_jax():
    """Per-feature clamps (the second feature unclamped), repeat to
    repeat_bins, mean-decode; 4 steps on injected noise."""
    rng = np.random.default_rng(3)
    b, t, h, f, r = 2, 10, 16, 2, 3
    kw = dict(out_dims=r, timesteps=4, schedule_type="vpsde", max_beta=40, num_features=f,
              repeat_bins=r)
    clamps = ((-96.0, -12.0), (None, None))
    cond = rng.normal(size=(b, t, h)).astype(np.float32)
    init = rng.uniform(size=(b, f, t, r)).astype(np.float32)
    steps = rng.normal(size=(4, b, f, t, r)).astype(np.float32)
    jax_diff = JaxDiffusion(denoise_fn=JaxWaveNet(in_dims=f * r, hidden_size=h, residual_layers=2,
                                                  residual_channels=16),
                            clamp_ranges=clamps, **kw)
    params = jax_init(jax_diff, cond, infer=True, init_noise=init)
    want = jax_diff.apply(params, cond, infer=True, init_noise=init, step_noises=steps)
    diff = GaussianDiffusion(WaveNet(f * r, h, 2, 16), clamp_ranges=clamps, **kw)
    diff.denoise_fn.load_state_dict(convert.wavenet_state_dict(
        jax.tree.map(np.asarray, params)["params"]["denoise_fn"], 2, prefix=""))
    got = diff.infer(T(cond), init_noise=T(init), step_noises=T(steps))
    assert got.shape == (b, f, t)
    close(got, want)
    curves = rng.uniform(-150, 20, (b, f, t)).astype(np.float32)
    close(diff.norm_spec(T(curves)), jax_diff.apply(params, curves, method="norm_spec"))
    close(diff.denorm_spec(diff.norm_spec(T(curves))),
          jax_diff.apply(params, jax_diff.apply(params, curves, method="norm_spec"),
                         method="denorm_spec"))


@pytest.mark.parametrize("expr,retake", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_pitch_predictor_matches_jax(expr, retake, inject):
    """With and without ``pitch_expr`` and a retake region; the vocabulary
    is ``vocab_size + 1``, the speaker table ``len(datasets)`` rows."""
    hp, rng = small_hp(), np.random.default_rng(4)
    tokens, mel2ph = phone_batch(rng, 8)
    note_midi, note_rest, mel2note = note_batch(rng)
    base = rng.uniform(50, 70, mel2ph.shape).astype(np.float32)
    spk = np.array([0, 1])
    kw = {}
    if expr:
        kw["pitch_expr"] = rng.uniform(0.2, 1.0, (2, 1)).astype(np.float32)
    if retake:
        kw["pitch"] = base + rng.normal(size=base.shape).astype(np.float32)
        kw["pitch_retake"] = (rng.random(base.shape) < 0.5).astype(np.int32)
    jax_model, params = JaxPitchPredictor(vocab_size=8, hparams=hp), predictor_params("pitch")
    assert params["params"]["spk_embed"]["embedding"].shape[0] == 2
    assert params["params"]["encoder"]["embed_tokens"]["embedding"].shape[0] == 9
    noise = rng.normal(size=(2, 1, mel2ph.shape[1], 8)).astype(np.float32)
    inject(noise)
    want = jax_model.apply(params, tokens, mel2ph, note_midi, note_rest, mel2note, base,
                           spk_id=spk, infer=True, infer_step=3, **kw)
    model = port_model(PitchPredictor, 8, hp, convert.pitch_predictor_state_dict, params)
    got = model.infer(T(tokens), T(mel2ph), T(note_midi), T(note_rest), T(mel2note), T(base),
                      infer_step=3, init_noise=T(noise), spk_id=T(spk),
                      **{k: T(v) for k, v in kw.items()})
    close(got, want)


def test_vari_predictor_matches_jax(inject):
    """Voicing, breath and tension (2 bins each), clamped to their ranges;
    the speaker table ``num_spk`` rows; 4 steps on injected noise."""
    hp, rng = small_hp(), np.random.default_rng(5)
    tokens, mel2ph = phone_batch(rng, 8)
    note_midi, note_rest, mel2note = note_batch(rng)
    f0 = rng.uniform(100, 400, mel2ph.shape).astype(np.float32)
    spk = np.array([2, 0])
    jax_model, params = JaxVariPredictor(vocab_size=8, hparams=hp), predictor_params("vari")
    assert params["params"]["spk_embed"]["embedding"].shape[0] == 3
    init = rng.uniform(size=(2, 3, mel2ph.shape[1], 2)).astype(np.float32)
    steps = rng.normal(size=(4, 2, 3, mel2ph.shape[1], 2)).astype(np.float32)
    inject(init, steps)
    want = jax_model.apply(params, tokens, mel2ph, note_midi, note_rest, mel2note, f0,
                           spk_embed_id=spk, infer=True)
    model = port_model(VariPredictor, 8, hp, convert.vari_predictor_state_dict, params)
    got = model.infer(T(tokens), T(mel2ph), T(note_midi), T(note_rest), T(mel2note), T(f0),
                      spk_embed_id=T(spk), init_noise=T(init), step_noises=T(steps))
    assert list(got) == ["voicing", "breath", "tension"]
    for name in got:
        close(got[name], want[name])
    assert to_np(got["breath"]).max() <= -20.0


def test_reflow_teacher_matches_jax():
    """A ``diff_type: reflow`` teacher: spec_min/spec_max normalisation, 3
    euler steps from the injected start point (its only noise); its
    training call returns the velocity pair."""
    hp = dict(TEACHER_HP, diff_type="reflow", spec_min=[-12.0], spec_max=[0.0],
              sampling_algorithm="euler")
    rng = np.random.default_rng(6)
    tokens, mel2ph = phone_batch(rng, 12, b=2, t_ph=5, t_mel=24)
    f0 = rng.uniform(150, 300, mel2ph.shape).astype(np.float32)
    lang = np.ones_like(tokens)
    spk, gender = np.array([0, 2]), np.array([1, 0])
    curves = {k: rng.uniform(-60, -10, mel2ph.shape).astype(np.float32)
              for k in ("voicing", "breath")}
    noise = rng.normal(size=(2, 1, 24, 16)).astype(np.float32)
    jax_model = JaxTeacher(vocab_size=12, hparams=hp)
    cond = dict(lang_seq=lang, spk_embed_id=spk, gender_embed_id=gender, **curves)
    params = jax_init(jax_model, tokens, mel2ph, f0, infer=True, init_noise=noise, **cond)
    want = jax_model.apply(params, tokens, mel2ph, f0, infer=True, infer_step=3,
                           init_noise=noise, **cond)
    model = port_model(ProDiffTeacher, 12, hp, convert.teacher_state_dict, params)
    got = model.infer(T(tokens), T(mel2ph), T(f0), infer_step=3, init_noise=T(noise),
                      **{k: T(v) for k, v in cond.items()})
    close(got, want)
    # training takes the flow's branch: the velocity target from the
    # normalised mel and the start point (the loss tests live beside the
    # training slice's)
    gt = rng.uniform(-11, -1, (2, 24, 16)).astype(np.float32)
    v_pred, v_gt, t = model(T(tokens), T(mel2ph), T(f0), gt_spec=T(gt), t=T([0.2, 0.6]),
                            noise=T(noise), **{k: T(v) for k, v in cond.items()})
    assert v_pred.shape == v_gt.shape == (2, 1, 24, 16) and t.tolist() == pytest.approx([0.2, 0.6])
    close(v_gt, (gt[:, None] + 12) / 12 * 2 - 1 - noise, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["dur", "pitch", "vari"])
def test_predictor_weights_round_trip(name):
    """flax params -> the port's state dict (strict load) -> flax params."""
    hp = small_hp()
    cls = {"dur": DurPredictor, "pitch": PitchPredictor, "vari": VariPredictor}[name]
    params = jax.tree.map(np.asarray, predictor_params(name))
    to_sd = getattr(convert, f"{name}_predictor_state_dict")
    to_flax = getattr(convert, f"{name}_predictor_flax_params")
    model = cls(8, hp)
    model.load_state_dict(to_sd(params, hp))
    back = to_flax(model.state_dict(), hp)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (path, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


# ---- host helpers --------------------------------------------------------------

def test_host_helpers_match_jax_exactly():
    rng = np.random.default_rng(8)
    ph_num = [1, 3, 2, 1, 2]
    cases = [rng.uniform(0.0, 0.4, 9), np.array([0.2, 0, 0, 0, 0.1, 0.3, 0.0, 0.3, 0.2]),
             np.zeros(9)]  # a degenerate (all-zero) word falls back to an even split
    note_dur = np.array([0.5, 0.8, 0.3, 0.6, 0.4])
    for ph_dur in cases:
        want = jax_inferers.DurPredictorInferer.force_align_pdur(ph_num, ph_dur, note_dur)
        got = DurPredictorInferer.force_align_pdur(ph_num, ph_dur, note_dur)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    timestep = 512 / 44100
    for durs, length in (([0.1, 0.25, 0.3], 60), ([0.1, 0.25, 0.3], 40), ([0.05], 3), ([], 4)):
        want = jax_dur_to_mel2ph_host(durs, timestep, length)
        got = dur_to_mel2ph_host(durs, timestep, length)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    note_midi = rng.uniform(50, 70, 4)
    mel2note = jax_dur_to_mel2ph_host([0.1, 0.3, 0.2, 0.15], timestep, 70)
    for kernel in (3, 5, 8):
        want = jax_base_pitch_curve(note_midi, mel2note, kernel)
        got = base_pitch_curve(note_midi, mel2note, kernel)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert get_inferer_cls("vari") is VariPredictorInferer
    with pytest.raises(ValueError, match="not found"):
        get_inferer_cls("tension")


# ---- inferers, handler and server over one experiment ------------------------

DICT_WORDS = {"ba": "b a", "ca": "c a", "a": "a"}
DICT_PHONES = {"a": ("vowel", "vowel"), "b": ("consonant", "stop"), "c": ("consonant", "fric")}
PHONES = ["SP", "AP", "a", "b", "c"]
PRED_SEGMENT = {  # words SP | b a | c a | SP: one note a word
    "ph_seq": "SP b a c a SP", "ph_num": "1 2 2 1", "note_seq": "rest A3 C4+20 rest",
    "note_dur": "0.11 0.23 0.29 0.07", "note_slur": "0 0 0 0",
    "note_dur_seq": "0.11 0.23 0.29 0.07", "ph_dur": "0.11 0.06 0.17 0.08 0.21 0.07",
    "f0_seq": " ".join(str(220.0 + 3 * i) for i in range(16)), "f0_timestep": "0.05",
    "offset": 0.0,
}


def _write_task(root, task, hp, params, maps):
    work = root / "checkpoints" / EXP / task
    work.mkdir(parents=True)
    with open(work / "config.yaml", "w") as f:
        yaml.dump(hp, f)
    for name, content in maps.items():
        with open(work / name, "w") as f:
            json.dump(content, f)
    ckpt_utils.save_checkpoint(str(work), 5, {"state_dict": params, "global_step": 5})


@pytest.fixture(scope="module")
def predictor_tree(tmp_path_factory):
    """The slice's experiment (``checkpoints/port/svs``) with a dictionary
    and the dur, pitch, voicing and breath predictors written by the JAX
    package, made once for the module; returns its root."""
    tmp_path = tmp_path_factory.mktemp("variance")
    make_experiment(tmp_path)
    dict_dir = tmp_path / "dictionary"
    dict_dir.mkdir()
    (dict_dir / "zh.txt").write_text("".join(f"{w}\t{p}\n" for w, p in DICT_WORDS.items()))
    (dict_dir / "zh_phones.txt").write_text(
        "".join(f"{p} {k} {c}\n" for p, (k, c) in DICT_PHONES.items()))
    dictionary = {"zh": {"word": str(dict_dir / "zh.txt"), "phoneme": str(dict_dir / "zh_phones.txt")}}
    svs_cfg = tmp_path / "checkpoints" / EXP / "svs" / "config.yaml"
    with open(svs_cfg) as f:
        svs = yaml.safe_load(f)
    with open(svs_cfg, "w") as f:
        yaml.dump(dict(svs, dictionary=dictionary, precompile=False), f)

    phone_set = {f"{p}/zh": p for p in PHONES}
    categories = ["AP", "SP", "vowel", "stop", "fric"]
    hps = {"dur": small_hp(dictionary=dictionary),
           "pitch": small_hp(dictionary=dictionary),
           "vari": small_hp(use_spk_id=False)}  # the JAX vari inferer passes no speaker id
    _write_task(tmp_path, "dur", hps["dur"], predictor_params("dur"),
                {"phone_set.json": phone_set})
    _write_task(tmp_path, "pitch", hps["pitch"], predictor_params("pitch"),
                {"ph_category_list.json": categories, "spk_map.json": SPEAKERS})
    vari = {"params": {k: v for k, v in predictor_params("vari")["params"].items()
                       if k != "spk_embed"}}
    for i, task in enumerate(("voicing", "breath")):
        _write_task(tmp_path, task, hps["vari"], perturb(vari, seed=10 + i, scale=0.05),
                    {"phone_set.json": phone_set})
    return tmp_path


@pytest.fixture
def predictors(predictor_tree, tmp_path, monkeypatch):
    """A copy of ``predictor_tree`` as the cwd (tests may edit it)."""
    shutil.copytree(predictor_tree, tmp_path, dirs_exist_ok=True)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _capture_jax_apply(inferer):
    """Record the padded inputs the JAX inferer hands its jitted model."""
    seen = {}
    run = inferer._jitted_apply

    def spy(params, *args, **kw):
        seen["args"] = [np.asarray(a) for a in args[:-1]]  # the last is the PRNG key
        return run(params, *args, **kw)

    inferer.__dict__["_jitted_apply"] = spy
    return seen


def _note_args():
    rng = np.random.default_rng(11)
    note_midi = np.array([57.0, 62.0, 62.0, 59.0, 64.0], np.float32)
    note_rest = np.array([True, False, False, True, False])
    note_dur = rng.uniform(0.05, 0.2, 5).astype(np.float32)
    return note_midi, note_rest, note_dur


def test_dur_inferer_matches_jax(predictors):
    """End to end from the checkpoint: 7 phonemes padded to 16 on both
    sides, the predicted durations force-aligned to the notes."""
    jax_inf = jax_inferers.DurPredictorInferer.from_workdir(EXP, "checkpoints", None)
    inf = DurPredictorInferer.from_workdir(EXP, "checkpoints", None, device="cpu")
    phones = ["SP", "b", "a", "c", "a", "a", "SP"]
    ph_num, note_dur = [1, 2, 2, 1, 1], [0.2, 0.31, 0.17, 0.4, 0.1]
    assert np.array_equal(inf.encode(phones), jax_inf.encode(phones))
    want = jax_inf.run(jax_inf.encode(phones), ph_num, note_dur)
    got = inf.run(inf.encode(phones), ph_num, note_dur)
    assert got.shape == (7,) and got.dtype == np.float32
    close(got, want)
    np.testing.assert_allclose([got[:1].sum(), got[1:3].sum(), got[3:5].sum()],
                               note_dur[:3], rtol=1e-5)


def test_pitch_inferer_matches_jax(predictors, inject):
    """The padded model inputs equal the JAX inferer's exactly (notes to
    16 with midi -1 / rest True, frames to the bucket, the base melody
    padded with its last value); the f0 curve agrees on injected noise."""
    jax_inf = jax_inferers.PitchPredictorInferer.from_workdir(EXP, "checkpoints")
    inf = PitchPredictorInferer.from_workdir(EXP, "checkpoints", device="cpu")
    note_midi, note_rest, note_dur = _note_args()
    mel_len, timestep = 50, 512 / 44100
    inputs, _ = inf.model_inputs(note_midi, note_rest, note_dur, mel_len, timestep, spk_id=1,
                                 pitch_expr=0.6)
    noise = np.random.default_rng(12).normal(size=(1, 1, 64, 8)).astype(np.float32)
    inject(noise)
    seen = _capture_jax_apply(jax_inf)
    want = jax_inf.run(note_midi, note_rest, note_dur, mel_len, timestep, spk_id=1,
                       pitch_expr=0.6)
    names = ["txt_tokens", "mel2ph", "note_midi", "note_rest", "mel2note", "base_pitch",
             "pitch_expr", "spk_id"]
    for name, arr in zip(names, seen["args"]):
        assert np.array_equal(inputs[name], arr), name
    got = inf.run(note_midi, note_rest, note_dur, mel_len, timestep, spk_id=1, pitch_expr=0.6,
                  init_noise=T(noise))
    assert got.shape == (mel_len,)
    close(got, want)


def test_vari_inferer_matches_jax(predictors, inject):
    """As the pitch inferer's: padded inputs exactly, the breath curve on
    injected noise (uniform start, 4 posterior steps)."""
    jax_inf = jax_inferers.VariPredictorInferer.from_workdir(EXP, "checkpoints", "breath")
    inf = VariPredictorInferer.from_workdir(EXP, "checkpoints", "breath", device="cpu")
    note_midi, note_rest, note_dur = _note_args()
    mel_len, timestep = 40, 512 / 44100
    f0 = np.linspace(200, 260, mel_len).astype(np.float32)
    inputs = inf.model_inputs(note_midi, note_rest, note_dur, mel_len, timestep, f0)
    rng = np.random.default_rng(13)
    init = rng.uniform(size=(1, 3, 64, 2)).astype(np.float32)
    steps = rng.normal(size=(4, 1, 3, 64, 2)).astype(np.float32)
    inject(init, steps)
    seen = _capture_jax_apply(jax_inf)
    want = jax_inf.run(note_midi, note_rest, note_dur, mel_len, timestep, f0)
    names = ["txt_tokens", "mel2ph", "note_midi", "note_rest", "mel2note", "f0"]
    for name, arr in zip(names, seen["args"]):
        assert np.array_equal(inputs[name], arr), name
    got = inf.run(note_midi, note_rest, note_dur, mel_len, timestep, f0, init_noise=T(init),
                  step_noises=T(steps))
    close(got, want)


def test_vari_inferer_reads_speaker_zero(predictors, tmp_path):
    """With a speaker embed (the base config's ``use_spk_id``) the port's
    variance inferer conditions on speaker 0 (the JAX inferer passes no id
    and raises there); the same seed gives the same curve."""
    cfg = tmp_path / "checkpoints" / EXP / "voicing" / "config.yaml"
    hp = small_hp(use_spk_id=True)
    with open(cfg, "w") as f:
        yaml.dump(hp, f)
    ckpt_utils.save_checkpoint(str(cfg.parent), 6, {"state_dict": predictor_params("vari"),
                                                    "global_step": 6})
    inf = VariPredictorInferer.from_workdir(EXP, "checkpoints", "voicing", device="cpu")
    args = (*_note_args(), 40, 512 / 44100, np.full(40, 230.0, np.float32))
    inputs = inf.model_inputs(*args)
    assert inputs["spk_embed_id"].tolist() == [0]
    a, b = inf.run(*args), inf.run(*args)
    assert a.shape == (40,) and np.array_equal(a, b)
    t = {k: T(v) for k, v in inputs.items()}
    gen = torch.Generator().manual_seed(hp["seed"])
    want = inf.model.infer(t["txt_tokens"], t["mel2ph"], t["note_midi"], t["note_rest"],
                           t["mel2note"], t["f0"], spk_embed_id=torch.zeros(1, dtype=torch.long),
                           generator=gen)["voicing"][0, :40]
    np.testing.assert_array_equal(a, to_np(want))


def test_handler_pred_dur_matches_jax(predictors):
    """The handler with predicted durations, noise-free, against the JAX
    handler: the same frames per phoneme and the same wav."""
    jax_h = JaxHandler(EXP, pred_dur=True, deterministic=True)
    port_h = SVSInferHandler(EXP, pred_dur=True, deterministic=True, device="cpu")
    seg = dict(PRED_SEGMENT, lang="zh", spk_name="spk1")
    want, got = jax_h.prepare(dict(seg)), port_h.prepare(dict(seg))
    assert got["mel_len"] == want["mel_len"] and np.array_equal(got["mel2ph"], want["mel2ph"])
    wav_want = jax_h.render_batch([want])[0]
    wav_got = port_h.render_batch([got])[0]
    assert wav_got.shape == wav_want.shape and np.abs(wav_want).max() > 1e-3
    np.testing.assert_allclose(wav_got, wav_want, atol=2e-5, rtol=1e-3)


def test_reflow_handler_matches_jax(predictors, tmp_path):
    """A ``diff_type: reflow`` teacher through both handlers, noise-free:
    ``sampling_steps`` euler steps from a zero start point."""
    work = tmp_path / "checkpoints" / EXP / "svs"
    with open(work / "config.yaml") as f:
        hp = yaml.safe_load(f)
    hp.update(diff_type="reflow", sampling_steps=3)
    with open(work / "config.yaml", "w") as f:
        yaml.dump(hp, f)
    teacher = JaxTeacher(vocab_size=8, hparams=hp)
    tokens = jnp.ones((1, 4), jnp.int32)
    params = jax_init(teacher, tokens, jnp.ones((1, 8), jnp.int32), jnp.full((1, 8), 200.0),
                      lang_seq=tokens, spk_embed_id=jnp.zeros((1,), jnp.int32),
                      voicing=jnp.zeros((1, 8)), breath=jnp.zeros((1, 8)), infer=True,
                      init_noise=jnp.zeros((1, 1, 8, 16)))
    ckpt_utils.save_checkpoint(str(work), 20, {"state_dict": params, "global_step": 20})
    jax_h = JaxHandler(EXP, deterministic=True)
    port_h = SVSInferHandler(EXP, deterministic=True, device="cpu")
    assert port_h.infer_step == jax_h.infer_step == 3
    seg = dict(PRED_SEGMENT, lang="zh", spk_name="spk0")
    want = jax_h.render_batch([jax_h.prepare(dict(seg))])[0]
    got = port_h.render_batch([port_h.prepare(dict(seg))])[0]
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-3)


def _jax_web(core):
    """The JAX server's route code over a JAX handler, without its warm-up
    compile (``WebHandler.__init__`` less ``precompile``)."""
    web = JaxWebHandler.__new__(JaxWebHandler)
    web.core, web.hparams, web.timestep = core, core.hparams, core.timestep
    web.dur_predictor = jax_inferers.DurPredictorInferer.from_workdir(
        EXP, "checkpoints", core.ph_encoder)
    web._build_word_dictionary()
    return web


def test_web_pred_dur_matches_jax(predictors):
    """``/api/pred_dur``'s answer against the JAX server's: the same words,
    phonemes and start time, the times within the tolerance."""
    port_web = WebHandler(EXP, device="cpu")
    jax_web = _jax_web(JaxHandler(EXP))
    req = {"language": "zh", "word_list": ["ba", "ca", "SP", "a"],
           "word_dur_list": [0.3, 0.45, 0.2, 0.5], "start_time": 1.25}
    want, got = jax_web.api_pred_dur(dict(req)), port_web.api_pred_dur(dict(req))
    assert got["start_time"] == want["start_time"] == 0.75
    assert [[p["ph"] for p in w] for w in got["note_ph_list"]] == \
        [[p["ph"] for p in w] for w in want["note_ph_list"]] == [["SP", "b", "a"], ["c", "a"],
                                                                 ["SP"], ["a"]]
    for key in ("start_time", "end_time"):
        close([p[key] for w in got["note_ph_list"] for p in w],
              [p[key] for w in want["note_ph_list"] for p in w])


def test_web_pred_routes_and_cli(predictors):
    """The port's server answers ``/api/pred_dur`` and ``/api/pred_pitch``
    (the same seeded answer twice), lists the pitch styles, refuses a
    request that lacks a key or whose lists disagree; the CLI renders with
    every predictor."""
    web = WebHandler(EXP, host="127.0.0.1", port=0, device="cpu")
    server = web.make_server()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, info = _request(f"{base}/api/basic_info")
        assert code == 200 and info["pitch_styles"] == list(SPEAKERS)
        code, out = _request(f"{base}/api/pred_dur", {
            "language": "zh", "word_list": ["ba", "a"], "word_dur_list": [0.4, 0.3],
            "start_time": 1.0})
        assert code == 200 and out["start_time"] == 0.5
        req = {"language": "zh", "ph_text_list": ["SP", "b", "a", "c", "a"],
               "ph_dur_list": [0.1, 0.05, 0.2, 0.06, 0.15], "note_midi_list": [-1, 57.0, 60.5],
               "note_dur_list": [0.1, 0.25, 0.21], "style": "spk1", "pitch_expr": 0.8}
        first, second = _request(f"{base}/api/pred_pitch", req), _request(f"{base}/api/pred_pitch", req)
        assert first[0] == 200 and first == second
        ph_acc = np.round(np.cumsum(req["ph_dur_list"]) / web.timestep + 0.5)
        pitch = np.asarray(first[1]["pitch"])
        assert pitch.shape == (int(ph_acc[-1]),) and np.isfinite(pitch).all()
        code, err = _request(f"{base}/api/pred_pitch", {"language": "zh"})
        assert code == 400 and "required" in err["error"]
        code, err = _request(f"{base}/api/pred_pitch", dict(req, note_dur_list=[0.1, 0.25]))
        assert code == 400 and "one duration per note" in err["error"]
        code, err = _request(f"{base}/api/pred_dur", {
            "language": "zh", "word_list": ["ba", "a"], "word_dur_list": [0.4], "start_time": 1.0})
        assert code == 400 and "one duration per word" in err["error"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    seg = {k: v for k, v in PRED_SEGMENT.items() if k not in ("ph_dur", "f0_seq", "f0_timestep")}
    with open("song.ds", "w") as f:
        json.dump([seg], f)
    port_cli(["infer", "song.ds", "--exp_name", EXP, "--spk_name", "spk0", "--pred_dur",
              "--pred_pitch", "spk1", "--pred_voicing", "--pred_breath", "--device", "cpu"])
    assert os.path.exists(os.path.join("infer_out", f"song【{EXP}】.wav"))
