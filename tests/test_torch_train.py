"""The training slice: the PyTorch port vs the JAX package, on the CPU.

Losses, ``q_sample``, the teacher's loss and every parameter's gradient
(injected ``t`` and noise, dropout off) against ``jax.value_and_grad``; the
optimizer against ``optax`` (``build_optimizer``); the batches of the data
pipeline; checkpoints written by one package and read by the other; and the
port's ``Trainer`` on a small synthetic dataset.

Tolerances: losses and forwards atol 2e-4 / rtol 1e-3 (float32 both sides,
other sum orders); gradients at 1e-4 of each one's peak (rtol 1e-3); the
optimizer's params atol 1e-6 / rtol 1e-5 (the same float32 arithmetic;
the schedule is float64 here, float32 in optax).
"""

import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from prodiff_tpu import config as jax_config
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.ops import losses as jax_losses
from prodiff_tpu.ops import ssim as jax_ssim
from prodiff_tpu.ops.schedules import DiffusionCoefficients
from prodiff_tpu.tasks.svs import SVSTask as JaxSVSTask
from prodiff_tpu.training.optim import build_optimizer
from prodiff_tpu.utils import ckpt_utils as jax_ckpt
from prodiff_tpu.utils.synthetic import make_svs_dataset
from prodiff_tpu_torch import config as port_config
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.ops.losses import parse_loss_spec, spec_loss_prodiff
from prodiff_tpu_torch.ops.ssim import ssim
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.tasks.svs import SVSTask
from prodiff_tpu_torch.training.optim import Optimizer
from prodiff_tpu_torch.training.trainer import Trainer, host_tensors
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import (
    load_flax_checkpoint,
    teacher_flax_params,
    teacher_state_dict,
)
from prodiff_tpu_torch.utils.synthetic import small_hparams
from tests.test_torch_modules import TEACHER_HP, _jax_teacher, close

LOSS_SPEC = "l1:0.5|ssim:0.5"


def grad_close(got, want, name):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4 * peak, rtol=1e-3, err_msg=name)


def test_ssim_and_spec_losses_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(2, 1, 24, 16)).astype(np.float32) - 4
    gt = pred + 0.3 * rng.normal(size=pred.shape).astype(np.float32)
    nonpad = np.ones((2, 24), bool)
    nonpad[1, 17:] = False
    close(ssim(torch.from_numpy(pred), torch.from_numpy(gt)),
          jax_ssim.ssim(jnp.asarray(pred), jnp.asarray(gt)))
    spec = "l1:0.5|mse:0.2|ssim:0.3"
    assert parse_loss_spec(spec) == jax_losses.parse_loss_spec(spec)
    got = spec_loss_prodiff(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(nonpad),
                            parse_loss_spec(spec), name="mel")
    want = jax_losses.spec_loss_prodiff(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(nonpad),
                                        jax_losses.parse_loss_spec(spec), name="mel")
    assert set(got) == set(want) == {"mel_l1", "mel_mse", "mel_ssim"}
    for k in want:
        close(got[k], want[k])


def test_q_sample_matches_jax():
    """Every t of ``[0, timesteps]`` (inclusive, as the training draw)."""
    rng = np.random.default_rng(1)
    _, params, model, _ = _teacher_pair()
    x0 = rng.normal(size=(5, 1, 6, 16)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.arange(5)
    coefs = DiffusionCoefficients(timesteps=4, schedule_type="vpsde", max_beta=40)
    want = (coefs.sqrt_alphas_cumprod[t][:, None, None, None] * x0
            + coefs.sqrt_one_minus_alphas_cumprod[t][:, None, None, None] * noise)
    got = model.diffusion.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(noise))
    close(got, want, atol=1e-6, rtol=1e-6)


def _teacher_pair():
    jmodel, params, inputs = _jax_teacher()
    model = ProDiffTeacher(12, TEACHER_HP)
    model.load_state_dict(teacher_state_dict(params, TEACHER_HP))
    return jmodel, params, model.eval(), inputs


def _train_batch(inp):
    """The teacher inputs of ``_jax_teacher`` as a training batch, with a
    target mel, ids, and injected t (including ``timesteps``) and noise."""
    rng = np.random.default_rng(2)
    b, t_mel = inp["mel2ph"].shape
    batch = {
        "ph_seq": inp["tokens"], "mel2ph": inp["mel2ph"], "f0": inp["f0"],
        "mel": (rng.normal(size=(b, t_mel, 16)) * 2 - 4).astype(np.float32),
        "spk_id": np.array([0, 2]), "gender_id": np.array([1, 0]), "lang_seq": inp["lang"],
        "voicing": inp["voicing"], "breath": inp["breath"],
    }
    t = np.array([4, 1])
    noise = rng.normal(size=(b, 1, t_mel, 16)).astype(np.float32)
    return batch, t, noise


def test_teacher_loss_and_grads_match_jax():
    """The teacher's training loss and the gradient of every parameter vs
    ``jax.value_and_grad`` of forward_condition -> q_sample -> the denoiser's
    training branch -> spec_loss_prodiff. The batch has padded tokens and
    frames: torch zeroes the padding rows' gradients, JAX's gather does not,
    and the two agree because the encoder masks pad positions."""
    jmodel, params, model, inp = _teacher_pair()
    batch, t, noise = _train_batch(inp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_type = jax_losses.parse_loss_spec(LOSS_SPEC)

    def denoise(m, cond, x0, t, noise):
        return m.diffusion._denoise(m.diffusion.q_sample(x0, t, noise), t, cond, train=True)

    def jloss(p):
        cond = jmodel.apply(p, jb["ph_seq"], jb["mel2ph"], jb["f0"], lang_seq=jb["lang_seq"],
                            spk_embed_id=jb["spk_id"], gender_embed_id=jb["gender_id"],
                            voicing=jb["voicing"], breath=jb["breath"],
                            method=JaxTeacher.forward_condition)
        x0 = jb["mel"][:, None]
        pred = jmodel.apply(p, cond, x0, jnp.asarray(t), jnp.asarray(noise), method=denoise)
        losses = jax_losses.spec_loss_prodiff(pred, x0, jb["mel2ph"] > 0, loss_type, name="mel")
        return sum(losses.values()), losses

    (jtotal, jlosses), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    hp = dict(TEACHER_HP, data_dir="unused", task="svs", max_tokens=1000, max_sentences=4,
              mel_loss=LOSS_SPEC)
    losses = SVSTask(hp).compute_losses(model, host_tensors(batch, pin=False),
                                        t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    total = sum(losses.values())
    total.backward()
    assert set(losses) == set(jlosses) == {"mel_l1", "mel_ssim"}
    for k in losses:
        close(losses[k].detach(), jlosses[k])
    close(total.detach(), jtotal)
    want = teacher_state_dict(jax.tree.map(np.asarray, jgrads), TEACHER_HP)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        grad_close(p.grad, want[name], name)


@pytest.mark.parametrize("accum,clip_value,weight_decay", [(1, 0, 0.0), (2, 0.6, 0.01)])
def test_optimizer_matches_optax(accum, clip_value, weight_decay):
    """Five steps on the same gradients: warmup (the first update at the
    schedule's 1e-7 floor), the global-norm clip triggering on the large
    steps, value clipping, weight decay and accumulation of 2."""
    rng = np.random.default_rng(3)
    hp = dict(lr=2.0, warmup_updates=3, hidden_size=16, clip_grad_norm=1.0,
              clip_grad_value=clip_value, weight_decay=weight_decay,
              accumulate_grad_batches=accum)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    scales = (0.1, 2.0, 0.3, 3.0, 0.5)
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()}
             for s in scales]
    assert any(np.sqrt(sum((g ** 2).sum() for g in gs.values())) > 1.0 for gs in grads)
    tx = build_optimizer(hp)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Optimizer(params.items(), hp)
    for i, gs in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(gs[k])
        assert opt.step() == ((i + 1) % accum == 0)
        for k in init:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                       atol=1e-6, rtol=1e-5, err_msg=f"{k} after step {i + 1}")
    assert opt.count == len(grads) // accum


def test_batch_iterator_matches_jax(tmp_path):
    """Same synthetic dataset and seed: the same batches, in the same order,
    over two epochs of the shuffled train set and one of the valid set."""
    make_svs_dataset(str(tmp_path), n_train=12, n_valid=4)
    jtask = JaxSVSTask(small_hparams(str(tmp_path)))
    task = get_task_cls("svs")(small_hparams(str(tmp_path)))
    jit, it = jtask.train_iterator(), task.train_iterator()
    pairs = [(jb, b) for _ in range(2) for jb, b in zip(jit, it)]
    pairs += list(zip(jtask.val_iterator(), task.val_iterator()))
    assert len(pairs) == 2 * len(jit) + len(jtask.val_iterator())
    for jb, b in pairs:
        assert set(jb) == set(b)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(jb[k]), err_msg=k)


def _infer(model, jmodel, params, inp):
    """(port mel, JAX mel) of 4-step sampling on injected noise."""
    ji = {k: jnp.asarray(v) for k, v in inp.items()}
    want = jax.jit(functools.partial(jmodel.apply, infer=True, infer_step=4))(
        params, ji["tokens"], ji["mel2ph"], ji["f0"], lang_seq=ji["lang"],
        spk_mix_embed=ji["spk_mix"], gender_mix_embed=ji["gender_mix"], voicing=ji["voicing"],
        breath=ji["breath"], init_noise=ji["init_noise"], step_noises=ji["step_noises"])
    ti = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = model.infer(ti["tokens"], ti["mel2ph"], ti["f0"], infer_step=4,
                      init_noise=ti["init_noise"], step_noises=ti["step_noises"],
                      lang_seq=ti["lang"], spk_mix_embed=ti["spk_mix"],
                      gender_mix_embed=ti["gender_mix"], voicing=ti["voicing"], breath=ti["breath"])
    return got, want


def test_checkpoint_port_to_jax(tmp_path):
    """The port writes (params as the JAX tree, flax msgpack); the JAX
    package reads it with ``load_checkpoint_file`` + ``from_state_dict``
    and its forward equals the port's; the optimizer state is optax's tree
    of ``build_optimizer``, which ``from_state_dict`` restores."""
    jmodel, params, _, inp = _teacher_pair()
    torch.manual_seed(3)
    model = ProDiffTeacher(12, TEACHER_HP).eval()
    torch.nn.init.normal_(model.diffusion.denoise_fn.output_projection.weight, std=0.05)
    opt_hp = dict(lr=1.0, warmup_updates=10, hidden_size=32)
    opt = Optimizer(model.named_parameters(), opt_hp,
                    carrier=(lambda sd: teacher_flax_params(sd, TEACHER_HP),
                             lambda tree: teacher_state_dict(tree, TEACHER_HP)))
    payload = {"global_step": 7, "epoch": 1, "checkpoint_callback_best": float("inf"),
               "state_dict": teacher_flax_params(model.state_dict(), TEACHER_HP),
               "optimizer_state": opt.state_dict()}
    path = ckpt_utils.save_checkpoint(str(tmp_path), 7, payload)
    assert not os.path.exists(path + ".part")
    read = jax_ckpt.load_checkpoint_file(path)
    assert (read["global_step"], read["epoch"]) == (7, 1)
    assert jax.tree.structure(read["state_dict"]) == jax.tree.structure(params)
    jparams = serialization.from_state_dict(params, read["state_dict"])
    got, want = _infer(model, jmodel, jparams, inp)
    close(got, want)
    # the optimizer state is optax's tree, which the JAX trainer restores
    jopt = serialization.from_state_dict(build_optimizer(opt_hp).init(params["params"]),
                                         read["optimizer_state"])
    adam = jopt[0][0]  # chain(adamw) -> adamw = chain(scale_by_adam, ...)
    assert int(adam.count) == 0 and jax.tree.structure(adam.mu) == jax.tree.structure(
        params["params"])
    back = load_flax_checkpoint(path)  # and the port reads its own file
    assert int(back["optimizer_state"]["0"]["0"]["count"]) == 0
    for k, v in teacher_state_dict(back["state_dict"], TEACHER_HP).items():
        torch.testing.assert_close(v, model.state_dict()[k], atol=0, rtol=0)


def test_checkpoint_jax_to_port(tmp_path):
    jmodel, params, _, inp = _teacher_pair()
    path = jax_ckpt.save_checkpoint(str(tmp_path), 3, {"global_step": 3, "state_dict": params})
    read = load_flax_checkpoint(path)
    model = ProDiffTeacher(12, TEACHER_HP).eval()
    model.load_state_dict(teacher_state_dict(read["state_dict"], TEACHER_HP))
    got, want = _infer(model, jmodel, params, inp)
    close(got, want)


@pytest.fixture
def train_env(tmp_path):
    make_svs_dataset(str(tmp_path), n_train=12, n_valid=4, structured=True)
    return small_hparams(str(tmp_path), val_check_interval=5, tb_log_interval=1,
                         num_ckpt_keep=2, num_sanity_val_steps=1)


def _logged(hp, key="tr/total_loss"):
    with open(os.path.join(hp["work_dir"], "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if key in r]


def test_trainer_fit_resume_prune_and_best(train_env):
    """On the CPU: the loss falls over 30 steps; keep-2 pruning and the best
    copy; a second fit resumes at step 30 and runs to 40."""
    hp = train_env
    trainer = Trainer(hp, device="cpu")
    trainer.fit(get_task_cls("svs")(hp), max_steps=30)
    assert trainer.global_step == 30
    losses = [r["tr/total_loss"] for r in _logged(hp)]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < 0.9 * np.mean(losses[:6])
    assert [s for _, s in ckpt_utils.sorted_checkpoints(hp["work_dir"])] == [25, 30]
    assert os.path.exists(os.path.join(hp["work_dir"], "model_ckpt_best.pt"))
    assert len(_logged(hp, "val/total_loss")) == 6

    again = Trainer(hp, device="cpu")
    again.fit(get_task_cls("svs")(hp), max_steps=40)
    assert again.global_step == 40
    assert [r["step"] for r in _logged(hp)][30:] == list(range(31, 41))
    assert [s for _, s in ckpt_utils.sorted_checkpoints(hp["work_dir"])] == [35, 40]


def test_trainer_saves_and_stops_on_sigusr1(train_env, monkeypatch):
    """SIGUSR1 during step 3 (0-based): the step finishes, a checkpoint is
    written at step 4 and ``fit`` returns."""
    hp = dict(train_env, val_check_interval=100)
    trainer = Trainer(hp, device="cpu")
    step = Trainer.train_step

    def signalling_step(self, batch):
        if self.global_step == 3:
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(self, batch)

    monkeypatch.setattr(Trainer, "train_step", signalling_step)
    trainer.fit(get_task_cls("svs")(hp), max_steps=50)
    assert trainer.global_step == 4
    assert [s for _, s in ckpt_utils.sorted_checkpoints(hp["work_dir"])] == [4]
    assert signal.getsignal(signal.SIGUSR1) is not None


def test_base_config_is_the_ports_own_copy(tmp_path):
    """The shipped defaults live inside the port (it reads nothing of the JAX
    package's tree) and parse to the JAX package's defaults; a ``builtin``
    parent resolves to them in both packages."""
    port_dir = os.path.dirname(os.path.abspath(port_config.__file__))
    path = os.path.abspath(port_config.BASE_CONFIG_PATH)
    assert os.path.commonpath([path, port_dir]) == port_dir
    with open(jax_config.BASE_CONFIG_PATH) as f:
        want = yaml.safe_load(f)
    assert port_config.load_base_config() == want == jax_config.load_base_config()
    child = tmp_path / "child.yaml"
    child.write_text(yaml.dump({"base_config": "builtin", "lr": 0.5}))
    assert port_config.load_config(str(child)) == jax_config.load_config(str(child))


@pytest.mark.parametrize("multi", [False, True], ids=["one_parent", "two_parents"])
def test_config_parents_and_work_dir_reload_match_jax(tmp_path, monkeypatch, multi):
    """``load_config`` as the JAX package's for one parent (the key kept) and
    for a list of parents (merged in order, the key dropped); the config that
    ``set_hparams(make_work_dir=True)`` writes reloads through ``exp_name``
    from another working directory to the same hparams."""
    cfg_dir, run_dir, other_dir = (tmp_path / d for d in ("cfg", "run", "other"))
    for d in (cfg_dir, run_dir, other_dir):
        d.mkdir()
    (cfg_dir / "p1.yaml").write_text(yaml.dump({"a": 1, "b": 1}))
    (cfg_dir / "p2.yaml").write_text(yaml.dump({"b": 2, "c": 2}))
    # one parent by absolute path (a relative one cannot be found from the
    # work dir by either package); a list by paths relative to the child
    base = ["p1.yaml", "p2.yaml"] if multi else str(cfg_dir / "p1.yaml")
    child = cfg_dir / "child.yaml"
    child.write_text(yaml.dump({"base_config": base, "c": 3}))

    got = port_config.load_config(str(child))
    assert got == jax_config.load_config(str(child))
    assert {k: got[k] for k in "abc"} == ({"a": 1, "b": 2, "c": 3} if multi
                                          else {"a": 1, "b": 1, "c": 3})
    assert ("base_config" in got) is not multi

    root = str(tmp_path / "checkpoints")
    monkeypatch.chdir(run_dir)
    hp = port_config.set_hparams("e", "svs", root, config_fn=str(child), make_work_dir=True)
    assert hp == jax_config.set_hparams(config_fn=str(child), exp_name="e", task="svs",
                                        global_hparams=False, make_work_dir=False,
                                        checkpoints_root=root)
    monkeypatch.chdir(other_dir)
    assert port_config.set_hparams("e", "svs", root) == hp
