"""The rest of float32 training in the PyTorch port vs the JAX package, on the CPU.

The optimizer's state against optax's (the tree, its values, and one more
step from a carried state); resuming across the two trainers (a JAX
``Trainer.fit`` checkpoint resumed by the port's ``Trainer(device="cpu")``,
a port checkpoint resumed by the JAX ``Trainer``, the port's pre-optax
layout still resumed, a resumed run repeating an unbroken one); ``async_save``
against a blocking save; ``profile_steps``; and the validation plots:
``SVSTask.infer_mels``, the pitch and variance curves and the dur printout
against the JAX tasks on injected noise, the PNG names against the JAX ones.

Tolerances: the optimizer state and params atol 1e-6 / rtol 1e-5 (the same
float32 arithmetic in another order; the schedule is float64 here, float32
in optax); a carried state exactly; a resumed run against an unbroken one
1e-5 of each tensor's peak (the same CPU arithmetic: equal in practice);
sampled mels and curves atol 2e-4 / rtol 1e-3 (float32 both sides, other
sum orders), as ``tests/test_torch_train.py`` holds the teacher.
"""

import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from prodiff_tpu.models.duration import DurPredictor as JaxDurPredictor
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.models.pitch_predictor import PitchPredictor as JaxPitchPredictor
from prodiff_tpu.models.vari_predictor import VariPredictor as JaxVariPredictor
from prodiff_tpu.tasks.dur_predictor import DurPredictorTask as JaxDurTask
from prodiff_tpu.tasks.pitch_predictor import PitchPredictorTask as JaxPitchTask
from prodiff_tpu.tasks.svs import SVSTask as JaxSVSTask
from prodiff_tpu.tasks.vari_predictor import VariPredictorTask as JaxVariTask
from prodiff_tpu.training.optim import build_optimizer
from prodiff_tpu.training.trainer import Trainer as JaxTrainer
from prodiff_tpu.utils import ckpt_utils as jax_ckpt
from prodiff_tpu_torch.models.duration import DurPredictor
from prodiff_tpu_torch.models.pitch_predictor import PitchPredictor
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.models.vari_predictor import VariPredictor
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.tasks.svs import SVSTask
from prodiff_tpu_torch.training import trainer as trainer_mod
from prodiff_tpu_torch.training.optim import Optimizer
from prodiff_tpu_torch.training.trainer import Trainer, host_tensors
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import (
    dur_predictor_flax_params,
    optimizer_state_from_flax,
    pitch_predictor_flax_params,
    teacher_flax_params,
    vari_predictor_flax_params,
)
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder
from tests.test_torch_modules import TEACHER_HP, close, text_batch
from tests.test_torch_variance import (  # noqa: F401  (inject: a fixture)
    inject,
    note_batch,
    phone_batch,
    small_hp,
)

T = torch.as_tensor


def assert_same_tree(got, want, exact=False, where=""):
    """The same keys at every level; leaves of one shape and dtype, equal
    (``exact``) or within the optimizer tolerance."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_same_tree(got[k], want[k], exact, f"{where}/{k}")
        return
    a, b = np.asarray(got), np.asarray(want)
    assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, a.dtype, b.shape, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5, err_msg=where)


# ---- the optimizer's state --------------------------------------------------------

OPT_CASES = {"norm_clip": (1, 0, 1.0, 0.0), "value_clip_only": (1, 0.6, 0, 0.0),
             "accum_both_clips_decay": (2, 0.6, 1.0, 0.01)}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_state_matches_optax(case):
    """Three steps on the same gradients, then the port's ``state_dict()``
    against ``serialization.to_state_dict`` of optax's state: the same tree,
    its values within 1e-6; then each state carried into the other package
    takes one more step equal to the other's."""
    accum, clip_value, clip_norm, wd = OPT_CASES[case]
    rng = np.random.default_rng(4)
    hp = dict(lr=2.0, warmup_updates=3, hidden_size=16, clip_grad_norm=clip_norm,
              clip_grad_value=clip_value, weight_decay=wd, accumulate_grad_batches=accum)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()}
             for s in (0.1, 2.0, 0.3, 3.0)]
    tx = build_optimizer(hp)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)

    def port(values):
        params = {k: torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in values.items()}
        return params, Optimizer(params.items(), hp)

    def port_step(params, opt, gs):
        for k, p in params.items():
            p.grad = torch.from_numpy(gs[k])
        opt.step()

    def jax_step(jparams, state, gs):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, state, jparams)
        return optax.apply_updates(jparams, updates), state

    params, opt = port(init)
    for gs in grads[:3]:
        jparams, state = jax_step(jparams, state, gs)
        port_step(params, opt, gs)
    want = serialization.to_state_dict(jax.tree.map(np.asarray, state))
    got = opt.state_dict()
    assert_same_tree(got, want)
    assert jax.tree.structure(serialization.from_state_dict(state, got)) == jax.tree.structure(state)

    # optax's state into the port, the port's into optax: one more step each
    carried_params, carried = port({k: np.asarray(v) for k, v in jparams.items()})
    carried.load_state_dict(want)
    jcarried = serialization.from_state_dict(state, jax.tree.map(np.asarray, got))
    # a copy: jnp.asarray may alias a numpy buffer that the port's next step updates
    jparams_from_port = {k: jnp.asarray(p.detach().numpy().copy()) for k, p in params.items()}
    jparams, state = jax_step(jparams, state, grads[3])
    port_step(params, opt, grads[3])
    port_step(carried_params, carried, grads[3])
    jnext, _ = jax_step(jparams_from_port, jcarried, grads[3])
    for k in init:
        np.testing.assert_allclose(carried_params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=f"port step from optax's {k}")
        np.testing.assert_allclose(np.asarray(jnext[k]), params[k].detach().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=f"optax step from the port's {k}")


def test_optimizer_reads_the_old_layout_and_refuses_foreign_trees():
    """The pre-optax layout (``count``, ``mini_step``, ``mu``, ``nu``)
    loads to the same state; a tree of another optimizer, or an empty one,
    raises as flax's ``from_state_dict`` does."""
    hp = dict(lr=1.0, warmup_updates=3, hidden_size=16, clip_grad_norm=1.0)
    params = {"a": torch.nn.Parameter(torch.randn(3, 2))}
    opt = Optimizer(params.items(), hp)
    params["a"].grad = torch.randn(3, 2)
    opt.step()
    old = {"count": opt.count, "mini_step": opt.mini_step,
           "mu": {"a": opt.mu["a"].numpy().copy()}, "nu": {"a": opt.nu["a"].numpy().copy()}}
    again = Optimizer(params.items(), hp)
    again.load_state_dict(old)
    assert_same_tree(again.state_dict(), opt.state_dict(), exact=True)
    with pytest.raises(ValueError, match="keys"):
        again.load_state_dict({})
    with pytest.raises(ValueError, match="keys"):
        Optimizer(params.items(), dict(hp, accumulate_grad_batches=2)).load_state_dict(
            opt.state_dict())


@pytest.mark.parametrize("fault", ["scaled", "folded", "dropped"])
def test_optimizer_refuses_a_carrier_that_is_not_a_permutation(fault):
    """The moments are carried only through a carrier that moves elements:
    one that rescales a tensor (weight norm), adds two (a folded bias) or
    leaves one out fails loudly before a state is written or read."""
    params = {"w": torch.nn.Parameter(torch.randn(3, 2)), "b": torch.nn.Parameter(torch.randn(2)),
              "c": torch.nn.Parameter(torch.randn(2))}

    def to_tree(sd):
        w = sd["w"].detach().numpy().T.copy()
        tree = {"w": {"kernel": w * 2 if fault == "scaled" else w}}
        b, c = sd["b"].detach().numpy(), sd["c"].detach().numpy()
        tree.update({"b": b + c} if fault == "folded" else
                    {"b": b} if fault == "dropped" else {"b": b, "c": c})
        return {"params": tree}

    def from_tree(tree):
        p = tree["params"]
        w = torch.from_numpy(np.asarray(p["w"]["kernel"]).T.copy())
        b = torch.from_numpy(np.asarray(p["b"]))
        return {"w": w / 2 if fault == "scaled" else w, "b": b,
                "c": torch.from_numpy(np.asarray(p.get("c", np.zeros(2, np.float32))))}

    opt = Optimizer(params.items(), dict(lr=1.0, warmup_updates=3, hidden_size=4),
                    carrier=(to_tree, from_tree))
    with pytest.raises(ValueError, match="carrier"):
        opt.state_dict()
    good = Optimizer(params.items(), dict(lr=1.0, warmup_updates=3, hidden_size=4))
    with pytest.raises(ValueError, match="carrier"):
        opt.load_state_dict(good.state_dict())


# ---- resuming across the trainers ---------------------------------------------------

def _hp(root, work, **kw):
    kw = dict(dict(val_check_interval=100, tb_log_interval=1, num_sanity_val_steps=0,
                   num_valid_plots=1), **kw)
    return small_hparams(str(root), work_dir=str(root / work), **kw)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX ``Trainer.fit`` of 3 steps on the synthetic set (the JAX
    trainer initialises from the first batch and compiles its step, so it
    runs once a module); returns the hparams, its checkpoint and the
    trainer, whose compiled step the tests reuse."""
    root = tmp_path_factory.mktemp("jax_run")
    make_svs_dataset(str(root), n_train=16, n_valid=8)
    hp = _hp(root, "jax")
    jt = JaxTrainer(dict(hp))
    jt.fit(get_task_cls_jax("svs")(dict(hp)), max_steps=3)
    path = jax_ckpt.get_last_checkpoint_path(hp["work_dir"])
    assert path.endswith("model_ckpt_steps_3.ckpt")
    return root, hp, jax_ckpt.load_checkpoint_file(path), jt


def get_task_cls_jax(name):
    from prodiff_tpu.tasks import get_task_cls as jax_get_task_cls

    return jax_get_task_cls(name)


def test_port_resumes_a_jax_trainer_checkpoint(jax_run):
    """The port's trainer reads the JAX trainer's step-3 checkpoint: the
    weights and optax's Adam state exactly, then trains on to step 5 and
    writes a tree of the JAX checkpoint's structure."""
    root, hp, want, _ = jax_run
    work = root / "port_from_jax"
    shutil.copytree(hp["work_dir"], work)
    php = dict(hp, work_dir=str(work))
    trainer = Trainer(php, device="cpu")
    task = get_task_cls("svs")(php)
    trainer.build(task)
    assert trainer.restore_checkpoint() and trainer.global_step == 3
    assert_same_tree(task.params_tree(trainer.model), want["state_dict"], exact=True)
    assert_same_tree(trainer.optimizer.state_dict(), want["optimizer_state"], exact=True)
    assert trainer.optimizer.count == 3

    Trainer(php, device="cpu").fit(get_task_cls("svs")(php), max_steps=5)
    got = ckpt_utils.load_checkpoint_file(str(work / "model_ckpt_steps_5.ckpt"))
    assert got["global_step"] == 5
    assert jax.tree.structure(got["optimizer_state"]) == jax.tree.structure(want["optimizer_state"])
    assert int(got["optimizer_state"]["1"]["0"]["count"]) == 5


def test_jax_trainer_resumes_a_port_checkpoint(jax_run):
    """The JAX trainer restores the port's step-3 checkpoint (weights and
    optimizer state exactly, through ``from_state_dict``) and its compiled
    step trains on to step 5."""
    from prodiff_tpu.parallel.mesh import shard_batch

    root, hp, _, jt = jax_run
    php = dict(hp, work_dir=str(root / "jax_from_port"))
    Trainer(php, device="cpu").fit(get_task_cls("svs")(php), max_steps=3)
    written = ckpt_utils.load_checkpoint_file(os.path.join(php["work_dir"],
                                                           "model_ckpt_steps_3.ckpt"))
    jt.work_dir = php["work_dir"]
    assert jt.restore_checkpoint() and jt.global_step == 3
    restored = jax.tree.map(np.asarray, jax.device_get(jt.state))
    assert_same_tree(serialization.to_state_dict(restored["params"]), written["state_dict"],
                     exact=True)
    assert_same_tree(serialization.to_state_dict(restored["opt_state"]),
                     written["optimizer_state"], exact=True)
    batches = iter(get_task_cls_jax("svs")(dict(php)).train_iterator(jt.n_devices))
    for _ in range(2):
        batch = next(batches)
        batch.pop("nsamples")
        jt.state, metrics = jt.train_step(jt.state, shard_batch(batch, jt.mesh),
                                          jax.random.PRNGKey(jt.seed))
        assert np.isfinite(float(metrics["total_loss"]))
    counts = [x for x in jax.tree.leaves(jax.device_get(jt.state["opt_state"])) if np.ndim(x) == 0]
    assert len(counts) == 2 and all(int(c) == 5 for c in counts)


@pytest.mark.parametrize("layout", ["optax", "old"])
def test_resumed_run_repeats_an_unbroken_one(tmp_path, layout):
    """N steps (one epoch), a restart, 2 more: the params equal an unbroken
    run of N + 2, dropout included (its draws are seeded by step); the
    checkpoint resumed from is in optax's layout or rewritten in the port's
    older one."""
    make_svs_dataset(str(tmp_path), n_train=12, n_valid=4, structured=True)
    hp = _hp(tmp_path, "unbroken")
    n = len(get_task_cls("svs")(hp).train_iterator())
    unbroken = Trainer(hp, device="cpu")
    unbroken.fit(get_task_cls("svs")(hp), max_steps=n + 2)

    bhp = dict(hp, work_dir=str(tmp_path / "broken"))
    first = Trainer(bhp, device="cpu")
    first.fit(get_task_cls("svs")(bhp), max_steps=n)
    if layout == "old":
        path = os.path.join(bhp["work_dir"], f"model_ckpt_steps_{n}.ckpt")
        payload = ckpt_utils.load_checkpoint_file(path)
        st = optimizer_state_from_flax(payload["optimizer_state"], first.task.carrier(), bhp)
        payload["optimizer_state"] = {
            "count": st["count"], "mini_step": st["mini_step"],
            **{k: {n_: t.numpy() for n_, t in st[k].items()} for k in ("mu", "nu")}}
        ckpt_utils.write_checkpoint_file(path, payload)
    resumed = Trainer(bhp, device="cpu")
    resumed.fit(get_task_cls("svs")(bhp), max_steps=n + 2)
    assert resumed.global_step == unbroken.global_step == n + 2
    want = unbroken.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        peak = max(float(want[k].abs().max()), 1e-6)
        torch.testing.assert_close(v, want[k], atol=1e-5 * peak, rtol=0, msg=k)


def test_async_save_writes_what_a_blocking_save_does(tmp_path, monkeypatch):
    """``async_save``: the periodic checkpoints are written off the main
    thread (non-daemon), joined by the time ``fit`` returns, and their bytes
    equal a blocking run's."""
    make_svs_dataset(str(tmp_path), n_train=8, n_valid=2)
    threads = []
    save = ckpt_utils.save_checkpoint

    def recording(*args, **kwargs):
        threads.append(threading.current_thread())
        return save(*args, **kwargs)

    monkeypatch.setattr(trainer_mod.ckpt_utils, "save_checkpoint", recording)
    files = {}
    for name, flag in (("blocking", False), ("async", True)):
        hp = _hp(tmp_path, name, val_check_interval=2, num_ckpt_keep=5, async_save=flag)
        threads.clear()
        trainer = Trainer(hp, device="cpu")
        trainer.fit(get_task_cls("svs")(hp), max_steps=5)
        files[name] = {f: open(os.path.join(hp["work_dir"], f), "rb").read()
                       for f in sorted(os.listdir(hp["work_dir"])) if f.endswith((".ckpt", ".pt"))}
        main = threading.main_thread()
        assert trainer._save_thread is None and not any(t.is_alive() for t in threads
                                                        if t is not main)
        assert [t is main for t in threads] == ([True] * 3 if not flag else [False, False, True])
        assert all(not t.daemon for t in threads)
    assert sorted(files["async"]) == ["model_ckpt_best.pt", "model_ckpt_steps_2.ckpt",
                                      "model_ckpt_steps_4.ckpt", "model_ckpt_steps_5.ckpt"]
    assert files["async"] == files["blocking"]


def test_async_save_raises_the_writers_error(tmp_path, monkeypatch):
    """A checkpoint write that fails on its thread fails ``fit``."""
    make_svs_dataset(str(tmp_path), n_train=8, n_valid=2)
    main = threading.main_thread()

    def failing(*args, **kwargs):
        if threading.current_thread() is not main:
            raise OSError("disk full")

    monkeypatch.setattr(trainer_mod.ckpt_utils, "save_checkpoint", failing)
    hp = _hp(tmp_path, "failing", val_check_interval=2, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        Trainer(hp, device="cpu").fit(get_task_cls("svs")(hp), max_steps=3)


def test_profile_steps_writes_a_trace(tmp_path):
    """``profile_steps: 2`` over 12 steps: a Chrome trace of steps 11-12
    under ``work_dir/profile`` holding the steps' operators."""
    make_svs_dataset(str(tmp_path), n_train=8, n_valid=2)
    hp = _hp(tmp_path, "prof", profile_steps=2)
    Trainer(hp, device="cpu").fit(get_task_cls("svs")(hp), max_steps=12)
    out = os.path.join(hp["work_dir"], "profile")
    assert os.listdir(out) == ["trace_steps_10-12.json"]
    with open(os.path.join(out, "trace_steps_10-12.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::conv1d") for n in names)
    assert any(n.startswith("aten::mm") or n.startswith("aten::addmm") for n in names)


def test_convert_ckpt_file_is_refused_by_both_trainers(jax_run, tmp_path):
    """A ``convert_ckpt`` file has no optimizer state: the JAX trainer's
    ``from_state_dict`` refuses it, and so does the port's trainer."""
    import yaml

    from prodiff_tpu_torch.__main__ import convert_ckpt
    from prodiff_tpu_torch.models.prodiff import ProDiffTeacher

    _, hp, _, jt = jax_run
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.dump({k: v for k, v in hp.items() if k != "work_dir"}))
    task = get_task_cls("svs")(dict(hp))
    torch.save({"state_dict": {"model": ProDiffTeacher(len(task.build_phone_encoder()),
                                                       hp).state_dict()}},
               str(tmp_path / "ref.ckpt"))
    work = tmp_path / "work"
    convert_ckpt(str(tmp_path / "ref.ckpt"), str(cfg), str(work / "model_ckpt_steps_0.ckpt"))
    trainer = Trainer(dict(hp, work_dir=str(work)), device="cpu")
    trainer.build(task)
    with pytest.raises(ValueError, match="no optimizer state"):
        trainer.restore_checkpoint()
    jt.work_dir = str(work)
    with pytest.raises(ValueError, match="do not match"):
        jt.restore_checkpoint()


# ---- validation sampling and plots -----------------------------------------------------

def _task_hp(task, **kw):
    return dict(kw, data_dir="unused", task=task, max_tokens=1000, max_sentences=4)


class Compiled:
    """A JAX module whose ``apply(..., infer=True)`` runs as one compiled
    program (the JAX tasks' plots call ``model.apply``, op by op otherwise)."""

    def __init__(self, module):
        self.fn = jax.jit(lambda params, *a, **kw: module.apply(params, *a, infer=True, **kw),
                          static_argnames=("infer_step",))

    def apply(self, params, *args, infer=True, **kwargs):
        return self.fn(params, *args, **kwargs)


def seeded(cls, vocab, hp, seed):
    """A port model with every weight nudged off its init (the WaveNet's
    output projection starts at zero); the JAX package gets its weights by
    the carrier, so no JAX init is compiled."""
    torch.manual_seed(seed)
    model = cls(vocab, hp)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model.eval()


def test_infer_mels_and_mel_plots_match_jax(tmp_path):
    """``SVSTask.infer_mels`` vs the JAX task's on the same injected
    sampling noise; both tasks' plots of one batch have the same names."""
    rng = np.random.default_rng(30)
    model = seeded(ProDiffTeacher, 12, TEACHER_HP, 30)
    params = teacher_flax_params(model.state_dict(), TEACHER_HP)
    tokens, mel2ph = text_batch(rng)
    b, t_mel = mel2ph.shape
    batch = {"ph_seq": tokens, "mel2ph": mel2ph, "lang_seq": (tokens > 0).astype(np.int64),
             "f0": rng.uniform(100, 500, (b, t_mel)).astype(np.float32),
             "mel": rng.uniform(-6, 1, (b, t_mel, 16)).astype(np.float32),
             "spk_id": np.array([0, 2]), "gender_id": np.array([1, 0]),
             "voicing": rng.uniform(-30, -5, (b, t_mel)).astype(np.float32),
             "breath": rng.uniform(-60, -20, (b, t_mel)).astype(np.float32)}
    noise = {"init_noise": rng.uniform(size=(b, 1, t_mel, 16)).astype(np.float32),
             "step_noises": rng.normal(size=(4, b, 1, t_mel, 16)).astype(np.float32)}
    hp = _task_hp("svs", **TEACHER_HP, mel_loss="l1", num_valid_plots=10)
    jtask, task = JaxSVSTask(hp), SVSTask(hp)
    jtask.model = Compiled(JaxTeacher(vocab_size=12, hparams=TEACHER_HP))
    plain_inputs = jtask._model_inputs
    jtask._model_inputs = lambda bt: (lambda a, kw: (a, dict(kw, **{
        k: jnp.asarray(v) for k, v in noise.items()})))(*plain_inputs(bt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jtask.infer_mels(params, jb, jax.random.PRNGKey(0))
    tb = host_tensors(batch, pin=False)
    got = task.infer_mels(model, tb, **{k: T(v) for k, v in noise.items()})
    assert got.shape == (b, t_mel, 16)
    close(got, want)

    jtask.validation_plots(params, jb, 7, str(tmp_path / "jax"))  # the injected noise again
    task.validation_plots(model, tb, 7, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["mel_0_step7.png", "mel_1_step7.png"] == sorted(os.listdir(tmp_path / "port"))


def _note_inputs(rng, vocab=8):
    tokens, mel2ph = phone_batch(rng, vocab)
    note_midi, note_rest, mel2note = note_batch(rng)
    return {"ph_seq": tokens, "mel2ph": mel2ph, "note_midi": note_midi,
            "note_rest": note_rest, "mel2note": mel2note, "spk_id": np.array([1, 0])}


def test_pitch_validation_curves_and_plots_match_jax(tmp_path, inject):
    rng = np.random.default_rng(31)
    hp = small_hp()
    model = seeded(PitchPredictor, 8, hp, 31)
    params = pitch_predictor_flax_params(model.state_dict(), hp)
    b = _note_inputs(rng)
    t_mel = b["mel2ph"].shape[1]
    b["base_pitch"] = rng.uniform(55, 65, (2, t_mel)).astype(np.float32)
    b["pitch"] = (b["base_pitch"] + rng.normal(size=(2, t_mel))).astype(np.float32)
    noise = rng.normal(size=(2, 1, t_mel, 8)).astype(np.float32)
    inject(noise)
    jmodel = Compiled(JaxPitchPredictor(vocab_size=8, hparams=hp))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    delta = jmodel.apply(params, jb["ph_seq"], jb["mel2ph"], jb["note_midi"], jb["note_rest"],
                         jb["mel2note"], jb["base_pitch"], pitch_expr=np.ones((2, 1), np.float32),
                         spk_id=jb["spk_id"], infer=True,
                         rngs={"diffusion": jax.random.PRNGKey(3)})
    task = get_task_cls("pitch")(_task_hp("pitch", **hp))
    curves = task.validation_curves(model, host_tensors(b, pin=False), init_noise=T(noise))
    assert list(curves) == ["pitch"]
    np.testing.assert_array_equal(curves["pitch"][0], b["pitch"])
    close(curves["pitch"][1], b["base_pitch"] + np.asarray(delta))

    jtask = JaxPitchTask(_task_hp("pitch", **hp))
    jtask.model = jmodel
    jtask.validation_plots(params, jb, 3, str(tmp_path / "jax"))
    task.validation_plots(model, host_tensors(b, pin=False), 3, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port")) == [
        "pitch_0_step3.png", "pitch_1_step3.png"]


def test_vari_validation_curves_and_plots_match_jax(tmp_path, inject):
    rng = np.random.default_rng(32)
    hp = small_hp()
    model = seeded(VariPredictor, 8, hp, 32)
    params = vari_predictor_flax_params(model.state_dict(), hp)
    b = _note_inputs(rng)
    t_mel = b["mel2ph"].shape[1]
    b["f0"] = rng.uniform(150, 300, (2, t_mel)).astype(np.float32)
    task = get_task_cls("vari")(_task_hp("vari", **hp))
    for name in task.variance_names:
        b[name] = rng.uniform(-40, -10, (2, t_mel)).astype(np.float32)
    n_feat = len(task.variance_names)
    init = rng.uniform(size=(2, n_feat, t_mel, 2)).astype(np.float32)  # 2 bins a curve
    steps = rng.normal(size=(4, 2, n_feat, t_mel, 2)).astype(np.float32)
    inject(init, steps)
    jmodel = Compiled(JaxVariPredictor(vocab_size=8, hparams=hp))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jmodel.apply(params, jb["ph_seq"], jb["mel2ph"], jb["note_midi"], jb["note_rest"],
                        jb["mel2note"], jb["f0"], spk_embed_id=jb["spk_id"], infer=True,
                        rngs={"diffusion": jax.random.PRNGKey(3)})
    curves = task.validation_curves(model, host_tensors(b, pin=False), init_noise=T(init),
                                    step_noises=T(steps))
    assert list(curves) == task.variance_names and set(want) == set(curves)
    for name, (gt, pred) in curves.items():
        np.testing.assert_array_equal(gt, b[name])
        close(pred, want[name])

    jtask = JaxVariTask(_task_hp("vari", **hp))
    jtask.model = jmodel
    jtask.validation_plots(params, jb, 4, str(tmp_path / "jax"))
    task.validation_plots(model, host_tensors(b, pin=False), 4, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == sorted(
        f"{n}_{i}_step4.png" for n in task.variance_names for i in range(2))


def test_dur_validation_printout_matches_jax(capsys):
    rng = np.random.default_rng(33)
    hp = small_hp()
    model = seeded(DurPredictor, 8, hp, 33)
    params = dur_predictor_flax_params(model.state_dict(), hp)
    tokens, _ = phone_batch(rng, 8)
    onset = (rng.random(tokens.shape) < 0.5).astype(np.int64)
    onset[:, 0] = 1
    b = {"ph_seq": tokens, "onset": onset * (tokens > 0),
         "word_dur": rng.uniform(0.2, 1.0, tokens.shape).astype(np.float32),
         "ph_dur": rng.uniform(0.05, 0.4, tokens.shape).astype(np.float32)}
    encoder = TokenTextEncoder([f"p{i}" for i in range(5)])
    jtask, task = JaxDurTask(_task_hp("dur", **hp)), get_task_cls("dur")(_task_hp("dur", **hp))
    jtask.model, jtask.ph_encoder, task.ph_encoder = (
        Compiled(JaxDurPredictor(vocab_size=8, hparams=hp)), encoder, encoder)
    jtask.validation_plots(params, {k: jnp.asarray(v) for k, v in b.items()}, 0, None)
    want = capsys.readouterr().out
    task.validation_plots(model, host_tensors(b, pin=False), 0, None)
    got = capsys.readouterr().out
    (gw, tw, pw), (gg, tg, pg) = (s.replace("\n ", " ").splitlines() for s in (want, got))
    assert gg == gw and gg.startswith("ph_text: ['p") and tg == tw

    def numbers(line):
        return np.array(line.split("[", 1)[1].rstrip("]").split(), np.float32)

    close(numbers(pg), numbers(pw))


def test_plots_without_matplotlib_log_once_and_draw_nothing(tmp_path, monkeypatch, caplog):
    """Where matplotlib does not import, the port's plots log once and draw
    nothing (no sampling either); the JAX task raises there."""
    import sys

    from prodiff_tpu_torch.tasks import base

    monkeypatch.setattr(base, "_PYPLOT", [])
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import raises ImportError
    rng = np.random.default_rng(34)
    hp = small_hp()
    model = seeded(PitchPredictor, 8, hp, 34)
    b = _note_inputs(rng)
    t_mel = b["mel2ph"].shape[1]
    b["base_pitch"] = b["pitch"] = np.full((2, t_mel), 60.0, np.float32)
    task = get_task_cls("pitch")(_task_hp("pitch", **hp))
    with caplog.at_level("WARNING", logger="prodiff_tpu_torch.tasks"):
        for step in (1, 2):
            task.validation_plots(model, host_tensors(b, pin=False), step, str(tmp_path / "p"))
    assert not (tmp_path / "p").exists()
    assert sum("matplotlib" in r.getMessage() for r in caplog.records) == 1
    jtask = JaxPitchTask(_task_hp("pitch", **hp))
    with pytest.raises(ImportError):
        jtask.validation_plots(pitch_predictor_flax_params(model.state_dict(), hp),
                               {k: jnp.asarray(v) for k, v in b.items()}, 1, str(tmp_path / "j"))
