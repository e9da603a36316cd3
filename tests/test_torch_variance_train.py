"""The training half of the variance stack: the PyTorch port vs the JAX package, on the CPU.

Losses (``spec_loss_reflow``, ``dur_loss``) with their gradients against
``jax.grad``; the retake masks bit for bit from one seed; for the ``dur``,
``pitch`` (with and without retake masks), ``vari`` and ``diff_type:
reflow`` ``svs`` tasks, the loss and every parameter's gradient against
``jax.value_and_grad`` of the JAX task's own ``compute_losses``. Its random
draws (t, the flow's start point or the diffusion's noise) are replaced by
the injected arrays for the length of a test (``jax.random.uniform`` /
``randint`` / ``normal`` patched, after the params were made), the port's
are passed in; dropout is off on both sides (``deterministic=True``,
``model.eval()``). The datasets' batches against the JAX ones on the same
shards, the pitch task's retake masks included; checkpoints of each task
both ways; and ``binarize dur|pitch`` -> ``train dur|pitch|vari`` ->
the inferers of both packages from the port-trained checkpoints.

Tolerances: losses atol 2e-4 / rtol 1e-3 (float32 on both sides, other sum
orders); gradients at 1e-4 of each one's peak, rtol 1e-3
(``tests/test_torch_train.py:grad_close``). Masks, maps, shards and
batches are held exactly, but the binarized f0 (the ACF's device part runs
in torch here, in XLA there: 1e-3 relative, as ``tests/test_torch_vocode.py``
holds the extractor).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from prodiff_tpu.binarize import BinarizeHandler as JaxBinarizeHandler
from prodiff_tpu.config import set_hparams as jax_set_hparams
from prodiff_tpu.infer import inferers as jax_inferers
from prodiff_tpu.models.diffusion import GaussianDiffusion as JaxDiffusion
from prodiff_tpu.models.duration import DurPredictor as JaxDurPredictor
from prodiff_tpu.models.pitch_predictor import PitchPredictor as JaxPitchPredictor
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.models.reflow import RectifiedFlow as JaxFlow
from prodiff_tpu.models.vari_predictor import VariPredictor as JaxVariPredictor
from prodiff_tpu.ops import losses as jax_losses
from prodiff_tpu.tasks.dur_predictor import DurPredictorDataset as JaxDurDataset
from prodiff_tpu.tasks.dur_predictor import DurPredictorTask as JaxDurTask
from prodiff_tpu.tasks.pitch_predictor import PitchPredictorDataset as JaxPitchDataset
from prodiff_tpu.tasks.pitch_predictor import PitchPredictorTask as JaxPitchTask
from prodiff_tpu.tasks.pitch_predictor import random_retake_masks as jax_retake_masks
from prodiff_tpu.tasks.svs import SVSTask as JaxSVSTask
from prodiff_tpu.tasks.vari_predictor import VariPredictorDataset as JaxVariDataset
from prodiff_tpu.tasks.vari_predictor import VariPredictorTask as JaxVariTask
from prodiff_tpu.utils import ckpt_utils as jax_ckpt
from prodiff_tpu.utils import pitch_utils as jax_pitch_utils
from prodiff_tpu.utils.indexed_datasets import IndexedDataset as JaxIndexedDataset
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.config import set_hparams
from prodiff_tpu_torch.data.dataset import BatchIterator
from prodiff_tpu_torch.infer.inferers import (
    DurPredictorInferer,
    PitchPredictorInferer,
    VariPredictorInferer,
)
from prodiff_tpu_torch.models.duration import DurPredictor
from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.vari_predictor import VariPredictor
from prodiff_tpu_torch.ops.losses import dur_loss, spec_loss_reflow
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.tasks.dur_predictor import DurPredictorDataset
from prodiff_tpu_torch.tasks.pitch_predictor import PitchPredictorDataset, random_retake_masks
from prodiff_tpu_torch.tasks.svs import SVSTask
from prodiff_tpu_torch.tasks.vari_predictor import VariPredictorDataset
from prodiff_tpu_torch.training.trainer import host_tensors
from prodiff_tpu_torch.utils import ckpt_utils, convert
from prodiff_tpu_torch.utils.indexed_datasets import IndexedDataset, IndexedDatasetBuilder
from prodiff_tpu_torch.utils.pitch_utils import hz_to_midi, random_continuous_masks
from tests.test_torch_modules import TEACHER_HP, _jax_teacher, close, to_np
from tests.test_torch_train import _train_batch, grad_close
from tests.test_torch_variance import (  # noqa: F401  (inject: a fixture)
    inject,
    note_batch,
    phone_batch,
    port_model,
    predictor_params,
    small_hp,
)

T = torch.as_tensor


def task_hp(task: str, **overrides) -> dict:
    """``small_hp()`` with what a task reads besides the model."""
    return dict(small_hp(), task=task, data_dir="unused", max_tokens=4000, max_sentences=4,
                **overrides)


# ---- losses and masks ----------------------------------------------------------

@pytest.mark.parametrize("loss_type,log_norm", [("l1", True), ("mse", True), ("l2", False)])
def test_spec_loss_reflow_matches_jax(loss_type, log_norm):
    """Values and the gradient in v_pred, padded frames masked, t at both
    ends of the logit-normal weight's clip."""
    rng = np.random.default_rng(0)
    v_pred = rng.normal(size=(4, 2, 10, 3)).astype(np.float32)
    v_gt = rng.normal(size=v_pred.shape).astype(np.float32)
    t = np.array([0.0, 0.3, 0.9, 1.0], np.float32)
    nonpad = np.ones((4, 10), bool)
    nonpad[1, 6:] = False

    def jloss(v):
        return jax_losses.spec_loss_reflow(v, jnp.asarray(v_gt), jnp.asarray(t),
                                           jnp.asarray(nonpad), loss_type, log_norm, "pitch")["pitch"]

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(v_pred))
    v = T(v_pred).requires_grad_()
    got = spec_loss_reflow(v, T(v_gt), T(t), T(nonpad), loss_type, log_norm, "pitch")
    assert list(got) == ["pitch"]
    got["pitch"].backward()
    close(got["pitch"].detach(), want)
    grad_close(v.grad, want_grad, "d loss / d v_pred")
    with pytest.raises(NotImplementedError):
        spec_loss_reflow(v, T(v_gt), T(t), None, "ssim")


def test_dur_loss_matches_jax():
    """Values and the gradient in the predictions, with padded phonemes
    (onset 0: they join the last word's segment sum) and predictions below
    zero (clipped for the word and sentence terms only)."""
    rng = np.random.default_rng(1)
    onset = np.array([[1, 0, 1, 1, 0, 0, 1, 0, 0, 0],
                      [1, 1, 0, 1, 0, 1, 0, 0, 0, 0]])
    real = np.array([7, 6])
    pad = np.arange(10)[None] >= real[:, None]
    onset[pad] = 0
    pred = rng.uniform(-0.3, 0.5, onset.shape).astype(np.float32)
    tgt = np.where(pad, 0.0, rng.uniform(0.02, 0.4, onset.shape)).astype(np.float32)
    assert (pred < 0).any() and (pred[pad] != 0).all()
    args = dict(log_offset=1.0, lambda_pdur=0.3, lambda_wdur=1.0, lambda_sdur=3.0)

    for max_words in (None, 4):
        def jloss(d):
            return jax_losses.dur_loss(d, jnp.asarray(tgt), jnp.asarray(onset),
                                       max_words=max_words, **args)

        want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
        d = T(pred).requires_grad_()
        got = dur_loss(d, T(tgt), T(onset), max_words=max_words, **args)
        got.backward()
        close(got.detach(), want)
        grad_close(d.grad, want_grad, f"d dur_loss / d pred (max_words {max_words})")
        assert (d.grad[T(pad)] != 0).all()  # the pad phonemes' predictions reach the loss


def test_masks_and_midi_match_jax_bit_for_bit():
    """``random_continuous_masks`` (along dims 1 and 2) and the pitch task's
    ``random_retake_masks`` from one seed, after the same earlier draws;
    ``hz_to_midi`` exactly."""
    for seed in (0, 5):
        got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        for rng in (got_rng, want_rng):
            rng.permutation(11)  # an earlier draw, as the dataset's shuffle
        for shape, dim in (((3, 17), 1), ((2, 4, 9), 2), ((5, 1), 1)):
            got = random_continuous_masks(got_rng, *shape, dim=dim)
            want = jax_pitch_utils.random_continuous_masks(want_rng, *shape, dim=dim)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        got, want = random_retake_masks(got_rng, 6, 40), jax_retake_masks(want_rng, 6, 40)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
        assert np.array_equal(got_rng.integers(0, 1000, 4), want_rng.integers(0, 1000, 4))
    hz = np.array([0.0, 1e-6, 55.0, 261.63, 440.0, 1046.5], np.float32)
    got, want = hz_to_midi(hz), jax_pitch_utils.hz_to_midi(hz)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ---- each task's loss and gradients ---------------------------------------------

@pytest.fixture
def jax_draws(monkeypatch):
    """``install(t, noise)``: from then on the JAX modules' training draws
    of t (``jax.random.uniform``/``randint``) and of the noise
    (``normal``) return these arrays, where a call asks for their shape
    (flax's shape checks of the params' initialisers pass through); returns
    the count of the draws replaced, by name."""
    def install(t, noise):
        taken = {"t": 0, "noise": 0}

        def fixed(name, value, dtype, orig):
            def draw(key, shape=(), *args, **kwargs):
                if tuple(shape) != value.shape:
                    return orig(key, shape, *args, **kwargs)
                taken[name] += 1
                return jnp.asarray(value, dtype)
            return draw

        for fn, name, value, dtype in (("uniform", "t", t, jnp.float32),
                                       ("randint", "t", t, jnp.int32),
                                       ("normal", "noise", noise, jnp.float32)):
            monkeypatch.setattr(jax.random, fn, fixed(name, value, dtype, getattr(jax.random, fn)))
        return taken
    return install


def _dur_case(rng):
    hp = task_hp("dur")
    tokens, _ = phone_batch(rng, 8, t_ph=9, pad=3)
    onset = np.zeros(tokens.shape, np.int64)
    onset[:, [0, 2, 3, 5]] = 1
    ph_dur = np.where(tokens > 0, rng.uniform(0.05, 0.4, tokens.shape), 0).astype(np.float32)
    word_dur = rng.uniform(0.1, 0.6, tokens.shape).astype(np.float32) * (tokens > 0)
    batch = {"ph_seq": tokens, "onset": onset, "ph_dur": ph_dur, "word_dur": word_dur}
    jtask, task = JaxDurTask(hp), get_task_cls("dur")(hp)
    jtask.model = JaxDurPredictor(vocab_size=8, hparams=hp)
    params = predictor_params("dur")
    model = port_model(DurPredictor, 8, hp, convert.dur_predictor_state_dict, params)
    return hp, batch, jtask, task, params, model, convert.dur_predictor_state_dict, None, None


def _pitch_case(rng, retake):
    hp = task_hp("pitch", use_pitch_retake=retake)
    tokens, mel2ph = phone_batch(rng, 8)
    note_midi, note_rest, mel2note = note_batch(rng)
    base = rng.uniform(50, 70, mel2ph.shape).astype(np.float32)
    batch = {"ph_seq": tokens, "mel2ph": mel2ph, "note_midi": note_midi, "note_rest": note_rest,
             "mel2note": mel2note, "base_pitch": base,
             "pitch": base + 2 * rng.normal(size=base.shape).astype(np.float32),
             "spk_id": np.array([1, 0])}
    if retake:
        batch["pitch_retake"] = random_retake_masks(rng, *mel2note.shape)
    jtask, task = JaxPitchTask(hp), get_task_cls("pitch")(hp)
    jtask.model = JaxPitchPredictor(vocab_size=8, hparams=hp)
    params = predictor_params("pitch")
    model = port_model(PitchPredictor, 8, hp, convert.pitch_predictor_state_dict, params)
    t = np.array([0.13, 0.87], np.float32)
    noise = rng.normal(size=(2, 1, mel2ph.shape[1], 8)).astype(np.float32)
    return hp, batch, jtask, task, params, model, convert.pitch_predictor_state_dict, t, noise


def _vari_case(rng):
    hp = task_hp("vari")
    tokens, mel2ph = phone_batch(rng, 8)
    note_midi, note_rest, mel2note = note_batch(rng)
    batch = {"ph_seq": tokens, "mel2ph": mel2ph, "note_midi": note_midi, "note_rest": note_rest,
             "mel2note": mel2note, "f0": rng.uniform(100, 400, mel2ph.shape).astype(np.float32),
             "spk_id": np.array([2, 0]),
             "voicing": rng.uniform(-100, -5, mel2ph.shape).astype(np.float32),
             "breath": rng.uniform(-90, -30, mel2ph.shape).astype(np.float32),
             "tension": rng.uniform(-12, 12, mel2ph.shape).astype(np.float32)}
    jtask, task = JaxVariTask(hp), get_task_cls("vari")(hp)
    jtask.model = JaxVariPredictor(vocab_size=8, hparams=hp)
    params = predictor_params("vari")
    model = port_model(VariPredictor, 8, hp, convert.vari_predictor_state_dict, params)
    t = np.array([4, 1])
    noise = rng.normal(size=(2, 3, mel2ph.shape[1], 2)).astype(np.float32)
    return hp, batch, jtask, task, params, model, convert.vari_predictor_state_dict, t, noise


def _reflow_svs_case(rng):
    hp = dict(TEACHER_HP, diff_type="reflow", spec_min=[-12.0], spec_max=[0.0],
              data_dir="unused", task="svs", max_tokens=1000, max_sentences=4,
              mel_loss="l1:0.5|ssim:0.5")
    _, params, inp = _jax_teacher()  # a prodiff teacher's params: the flow adds none
    batch, _, _ = _train_batch(inp)
    jtask, task = JaxSVSTask(hp), SVSTask(hp)
    jtask.model = JaxTeacher(vocab_size=12, hparams=hp)
    model = ProDiffTeacher(12, hp)
    model.load_state_dict(convert.teacher_state_dict(jax.tree.map(np.asarray, params), hp))
    t = np.array([0.02, 0.71], np.float32)
    noise = rng.normal(size=(2, 1, batch["mel"].shape[1], 16)).astype(np.float32)
    return hp, batch, jtask, task, params, model.eval(), convert.teacher_state_dict, t, noise


CASES = {"dur": _dur_case, "pitch": lambda rng: _pitch_case(rng, False),
         "pitch_retake": lambda rng: _pitch_case(rng, True), "vari": _vari_case,
         "svs_reflow": _reflow_svs_case}


@pytest.mark.parametrize("case", list(CASES))
def test_task_loss_and_grads_match_jax(case, jax_draws):
    """The task's losses and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX task's ``compute_losses`` (dropout
    off), t and noise injected on both sides; the batches have padded
    phonemes, notes and frames."""
    rng = np.random.default_rng(30)
    hp, batch, jtask, task, params, model, to_state_dict, t, noise = CASES[case](rng)
    taken = jax_draws(t, noise) if t is not None else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        losses = jtask.compute_losses(p, jb, jax.random.PRNGKey(0), deterministic=True)
        return sum(losses.values()), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    assert taken is None or taken == {"t": 1, "noise": 1}
    kw = {} if t is None else {"t": T(t), "noise": T(noise)}
    losses = task.compute_losses(model, host_tensors(batch, pin=False), **kw)
    total = sum(losses.values())
    total.backward()
    assert set(losses) == set(jlosses)
    for k in losses:
        close(losses[k].detach(), jlosses[k])
    close(total.detach(), jtotal)
    want = to_state_dict(jax.tree.map(np.asarray, jgrads), hp)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        grad_close(p.grad, want[name], name)


def test_port_draws_its_own_t_and_noise():
    """Without injected draws each task's losses come from the caller's
    generator: the same seed gives the same losses, another seed others."""
    rng = np.random.default_rng(31)
    for case in ("pitch_retake", "vari", "svs_reflow"):
        _, batch, _, task, _, model, _, _, _ = CASES[case](rng)
        b = host_tensors(batch, pin=False)
        with torch.no_grad():
            runs = [sum(task.compute_losses(model, b, torch.Generator().manual_seed(s)).values())
                    for s in (3, 3, 4)]
        assert float(runs[0]) == float(runs[1]) != float(runs[2]), case


# ---- checkpoints both ways -------------------------------------------------------

@pytest.mark.parametrize("name", ["dur", "pitch", "vari"])
def test_task_checkpoints_both_ways(name, tmp_path):
    """A JAX checkpoint of each predictor loads into the port's task
    (``load_params_tree``) exactly; the port's ``params_tree``, written by
    the port, reads back in the JAX package as the same tree."""
    hp = task_hp(name)
    task = get_task_cls(name)(hp)
    cls = {"dur": DurPredictor, "pitch": PitchPredictor, "vari": VariPredictor}[name]
    params = jax.tree.map(np.asarray, predictor_params(name))
    path = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 4, {"global_step": 4,
                                                               "state_dict": params})
    model = cls(8, hp)
    task.load_params_tree(model, convert.load_flax_checkpoint(path)["state_dict"])
    to_sd = getattr(convert, f"{name}_predictor_state_dict")
    for k, v in to_sd(params, hp).items():
        torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0)
    torch.manual_seed(2)
    model = cls(8, hp)
    port_path = ckpt_utils.save_checkpoint(str(tmp_path / "port"), 9, {
        "global_step": 9, "state_dict": task.params_tree(model)})
    read = jax_ckpt.load_checkpoint_file(port_path)["state_dict"]
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(read)] == [p for p, _ in flat(params)]
    for (path_, a), (_, b) in zip(flat(read), flat(task.params_tree(model))):
        np.testing.assert_array_equal(a, b, err_msg=str(path_))


# ---- datasets ----------------------------------------------------------------

def _write_shards(data_dir, items_by_prefix):
    os.makedirs(data_dir, exist_ok=True)
    for prefix, items in items_by_prefix.items():
        builder = IndexedDatasetBuilder(data_dir, prefix)
        for item in items:
            builder.add_item(item)
        builder.finalize()
        np.save(os.path.join(data_dir, f"{prefix}_lengths.npy"), [it["length"] for it in items])


def _note_items(rng, n, with_curves):
    """Pitch (or, ``with_curves``, variance) items of 20-70 frames."""
    items = []
    for _ in range(n):
        t_mel, t_ph, t_note = int(rng.integers(20, 70)), int(rng.integers(3, 9)), int(rng.integers(2, 6))
        item = {"ph_seq": rng.integers(1, 8, t_ph), "spk_id": int(rng.integers(0, 2)),
                "mel2ph": np.sort(rng.integers(1, t_ph + 1, t_mel)),
                "mel2note": np.sort(rng.integers(1, t_note + 1, t_mel)),
                "note_midi": rng.uniform(50, 70, t_note), "note_rest": rng.random(t_note) < 0.3,
                "length": t_mel}
        if with_curves:
            item["f0"] = rng.uniform(100, 400, t_mel).astype(np.float32)
            for name in ("voicing", "breath", "tension"):
                item[name] = rng.uniform(-80, -10, t_mel).astype(np.float32)
        else:
            item["pitch"] = rng.uniform(50, 70, t_mel).astype(np.float32)
            item["base_pitch"] = rng.uniform(50, 70, t_mel).astype(np.float32)
        items.append(item)
    return items


def _dur_items(rng, n):
    items = []
    for _ in range(n):
        ph_num = rng.integers(1, 4, int(rng.integers(2, 7)))
        ph2word = np.repeat(np.arange(1, len(ph_num) + 1), ph_num)
        ph_dur = rng.uniform(0.02, 0.3, len(ph2word)).astype(np.float32)
        word_dur = np.zeros(len(ph_num) + 1, np.float32)
        np.add.at(word_dur, ph2word, ph_dur)
        items.append({"ph_seq": rng.integers(1, 8, len(ph2word)), "ph_dur": ph_dur,
                      "word_dur": word_dur[ph2word], "onset": np.diff(ph2word, prepend=0),
                      "length": len(ph2word)})
    return items


DATASETS = {
    "dur": (DurPredictorDataset, JaxDurDataset, _dur_items),
    "pitch": (PitchPredictorDataset, JaxPitchDataset, lambda rng, n: _note_items(rng, n, False)),
    "vari": (VariPredictorDataset, JaxVariDataset, lambda rng, n: _note_items(rng, n, True)),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_batches_match_jax(name, tmp_path):
    """The same shards and seed: the same padded batches in the same order
    over two shuffled epochs of the train set and one of the valid set; the
    pitch task's retake masks are drawn by the collater after the
    shuffle's draws, in the JAX package's order."""
    port_cls, jax_cls, make = DATASETS[name]
    rng = np.random.default_rng(40)
    _write_shards(str(tmp_path / name), {"train": make(rng, 14), "valid": make(rng, 3)})
    hp = dict(small_hp(), task=name, data_dir=str(tmp_path), max_frames=128, seed=11,
              length_bucket_step=32, batch_size_buckets=[1, 2, 4, 8])
    pairs = []
    for prefix, shuffle, epochs in (("train", True, 2), ("valid", False, 1)):
        want = BatchIterator(jax_cls(prefix, shuffle, hp), max_tokens=160, max_sentences=4)
        got = BatchIterator(port_cls(prefix, shuffle, hp), max_tokens=160, max_sentences=4)
        for _ in range(epochs):
            pairs += list(zip(got, want))
    assert len(pairs) > 8
    for got, want in pairs:
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if name == "pitch":
        masks = np.concatenate([g["pitch_retake"].ravel() for g, _ in pairs])
        assert 0 < masks.mean() < 1


# ---- binarize -> train -> inferers, through the CLI -------------------------------

def _raw_corpus(root):
    """Eight 0.7 s seeded tones with labels (two words, a note and a rest),
    a phoneme dictionary with categories."""
    raw = root / "raw"
    (raw / "wav").mkdir(parents=True)
    rng = np.random.default_rng(50)
    sr, labels = 44100, {}
    for i in range(8):
        t = np.arange(int(sr * 0.7)) / sr
        f = 196.0 * 2 ** (rng.uniform(-4, 4) / 12)
        wav = 0.4 * np.sin(2 * np.pi * f * t) * np.hanning(len(t))
        wavfile.write(str(raw / "wav" / f"it{i}.wav"), sr, (wav * 32767).astype(np.int16))
        labels[f"it{i}"] = {"ph_seq": "SP a b", "ph_dur": f"0.2 {0.25 + 0.01 * i:.2f} "
                            f"{0.25 - 0.01 * i:.2f}", "ph_num": "1 2", "note_seq": "G3 rest",
                            "note_dur": "0.5 0.2"}
    with open(raw / "label.json", "w") as f:
        json.dump(labels, f)
    (root / "dict").mkdir()
    (root / "dict" / "zh_phones.txt").write_text("a vowel vowel\nb consonant stop\n")
    return raw


def _config(root, raw, **overrides):
    hp = dict(small_hp(), datasets=[{"data_dir": str(raw), "speaker": "s0", "language": "zh"}],
              dictionary={"zh": {"phoneme": str(root / "dict" / "zh_phones.txt")}},
              languages={"zh": 1}, test_num=1, valid_num=1, pitch_extractor="acf",
              max_updates=3, val_check_interval=100, num_sanity_val_steps=0,
              max_tokens=400, max_sentences=4, batch_size_buckets=[1, 2, 4], max_frames=128,
              length_bucket_step=32, num_spk=1)
    hp.update(dict(data_dir=str(root / "data")), **overrides)
    path = root / f"cfg_{len(os.listdir(root))}.yaml"
    with open(path, "w") as f:
        yaml.dump(hp, f)
    return str(path)


def _assert_same_items(got_dir, want_dir, prefix):
    got, want = IndexedDataset(got_dir, prefix), JaxIndexedDataset(want_dir, prefix)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for k in w:
            if k == "pitch":  # the f0 of the ACF's device part, torch here and XLA there
                np.testing.assert_allclose(g[k], w[k], atol=12 * np.log2(1.001), err_msg=k)
            else:
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for side in ("lengths.npy", "item_lengths.npz"):
        a, b = np.load(f"{got_dir}/{prefix}_{side}"), np.load(f"{want_dir}/{prefix}_{side}")
        if side.endswith(".npz"):
            assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in b.files)
        else:
            assert np.array_equal(a, b)


def _vari_shards(data_dir, rng):
    """The vari task's shards from seeded arrays (its binarizer needs a VR
    checkpoint), with its phone set."""
    phone_set = {"AP/zh": "AP", "SP/zh": "SP", "a/zh": "a", "b/zh": "b"}
    os.makedirs(data_dir)
    with open(os.path.join(data_dir, "phone_set.json"), "w") as f:
        json.dump(phone_set, f)
    items = _note_items(rng, 6, True)
    for it in items:
        it["ph_seq"] = it["ph_seq"] % 4 + 1
        it["note_rest"][:] = False
        del it["spk_id"]
    _write_shards(data_dir, {"train": items[:4], "valid": items[4:]})


def test_binarize_train_and_infer_through_the_cli(tmp_path, monkeypatch, inject):
    """``binarize dur|pitch`` (shards, sidecars and maps equal to the JAX
    binarizer's on the same corpus), ``train dur|pitch|vari`` for 3 steps,
    then both packages' inferers read the port-trained checkpoints and
    agree (the pitch curve on injected noise); ``binarize svs`` runs on the
    same corpus."""
    monkeypatch.chdir(tmp_path)
    raw = _raw_corpus(tmp_path)
    cfg = _config(tmp_path, raw)
    jax_cfg = _config(tmp_path, raw, data_dir=str(tmp_path / "jax_data"))
    for task in ("dur", "pitch"):
        port_cli(["binarize", task, "--config", cfg, "--exp_name", "v", "--device", "cpu"])
        JaxBinarizeHandler(jax_set_hparams(config_fn=jax_cfg, exp_name="v", task=task,
                                           make_work_dir=False)).handle()
        got_dir, want_dir = str(tmp_path / "data" / task), str(tmp_path / "jax_data" / task)
        for prefix in ("valid", "test", "train"):
            _assert_same_items(got_dir, want_dir, prefix)
        maps = sorted(f for f in os.listdir(want_dir) if f.endswith(".json"))
        assert maps == sorted(f for f in os.listdir(got_dir) if f.endswith(".json")) != []
        for m in maps:
            with open(os.path.join(got_dir, m)) as a, open(os.path.join(want_dir, m)) as b:
                assert json.load(a) == json.load(b), m
    port_cli(["binarize", "svs", "--config", cfg, "--exp_name", "v", "--device", "cpu"])
    assert len(IndexedDataset(str(tmp_path / "data" / "svs"), "train")) == 6

    _vari_shards(str(tmp_path / "data" / "vari"), np.random.default_rng(51))
    vari_cfg = _config(tmp_path, raw, use_spk_id=False)  # the JAX vari inferer passes no speaker
    for task, config in (("dur", cfg), ("pitch", cfg), ("vari", vari_cfg)):
        port_cli(["train", task, "--config", config, "--exp_name", "v", "--device", "cpu"])
        work = tmp_path / "checkpoints" / "v" / task
        assert (work / "model_ckpt_steps_3.ckpt").exists()
        steps = [json.loads(ln)["step"] for ln in open(work / "metrics.jsonl")]
        assert steps == [] or max(steps) <= 3

    with open("data/dur/phone_set.json") as f:
        phones = sorted(set(json.load(f).values()))
    from prodiff_tpu.utils.text_encoder import TokenTextEncoder as JaxEncoder

    dur_inf = DurPredictorInferer.from_workdir("v", "checkpoints", None, device="cpu")
    jax_dur = jax_inferers.DurPredictorInferer.from_workdir("v", "checkpoints",
                                                            JaxEncoder(phones, replace_oov="SP"))
    tokens = dur_inf.encode(["SP", "a", "b"])
    got, want = dur_inf.run(tokens, [1, 2], [0.5, 0.2]), jax_dur.run(tokens, [1, 2], [0.5, 0.2])
    close(got, want)
    np.testing.assert_allclose([got[0], got[1:].sum()], [0.5, 0.2], rtol=1e-4)

    pitch_inf = PitchPredictorInferer.from_workdir("v", "checkpoints", device="cpu")
    jax_pitch = jax_inferers.PitchPredictorInferer.from_workdir("v", "checkpoints")
    note_args = (np.array([55.0, 55.0]), np.array([False, True]), np.array([0.5, 0.2]), 60,
                 512 / 44100)
    noise = np.random.default_rng(52).normal(size=(1, 1, 64, 8)).astype(np.float32)
    samplers = {cls: cls.__dict__["__call__"] for cls in (JaxFlow, JaxDiffusion)}
    inject(noise)
    got = pitch_inf.run(*note_args, spk_id=0, init_noise=T(noise))
    close(got, jax_pitch.run(*note_args, spk_id=0))
    assert got.shape == (60,) and np.isfinite(got).all()

    vari_hp = set_hparams("v", "vari")
    vari_inf = VariPredictorInferer(vari_hp, "voicing", device="cpu")
    jax_vari = jax_inferers.VariPredictorInferer(jax_set_hparams(exp_name="v", task="vari"),
                                                 "voicing")
    f0 = np.full(60, 196.0, np.float32)
    init = np.random.default_rng(53).uniform(size=(1, 3, 64, 2)).astype(np.float32)
    steps = np.random.default_rng(54).normal(size=(4, 1, 3, 64, 2)).astype(np.float32)
    for cls, call in samplers.items():  # the pitch curve's injection off, then the curves'
        monkeypatch.setattr(cls, "__call__", call)
    inject(init, steps)
    got = vari_inf.run(*note_args, f0, init_noise=T(init), step_noises=T(steps))
    close(got, jax_vari.run(*note_args, f0))
    assert got.shape == (60,) and to_np(got).max() <= vari_hp["voicing_db_max"]
