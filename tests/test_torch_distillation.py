"""Distillation in the PyTorch port vs the JAX package, on the CPU.

``svs_rectified``: the dataset's batches over two shuffled epochs; the
student's loss and every gradient (``diff_type: prodiff``, noised with the
teacher's x_T, and ``reflow``) against the JAX task's ``compute_losses``
with its ``jax.random`` draws replaced by the injected ones; the student's
weight carrier both ways; ``convert_ckpt`` on a reference checkpoint with
``denoise_fn`` names and one with a reflow teacher's ``velocity_fn``
names, port against the JAX CLI; and the loop ``binarize svs`` -> ``train
svs`` -> ``binarize svs_rectified`` -> ``train svs_rectified`` ->
``merge_rectified`` through the port's CLI, its merged file against the
JAX ``merge_rectified`` of the same two files and the JAX teacher's
one-step render of it against the port's.

Tolerances: losses atol 2e-4 / rtol 1e-3 and gradients 1e-4 of each one's
peak (rtol 1e-3), as ``tests/test_torch_train.py`` holds the teacher;
batches, carried weights and checkpoint trees exactly; the merged
teacher's mel atol 2e-4 / rtol 1e-3.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import main as jax_main
from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.tasks.svs import SVSRectifiedTask as JaxRectifiedTask
from prodiff_tpu.utils import ckpt_utils as jax_ckpt
from prodiff_tpu_torch.__main__ import main as port_cli
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.training.trainer import host_tensors
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import (
    rectified_flax_params,
    rectified_state_dict,
    teacher_state_dict,
)
from prodiff_tpu_torch.utils.indexed_datasets import IndexedDataset
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder
from tests.test_torch_data_pipeline import pipeline_hp, write_corpus
from tests.test_torch_modules import TEACHER_HP, close
from tests.test_torch_train import grad_close
from tests.test_torch_train_extras import assert_same_tree
from tests.test_torch_variance_train import jax_draws  # noqa: F401  (a fixture)

T = torch.as_tensor


def rect_hp(root, diff_type: str = "prodiff", **kw) -> dict:
    return small_hparams(str(root), task="svs_rectified", diff_type=diff_type, **kw)


def test_rectified_batches_match_jax(tmp_path):
    """The triplets' dataset: the same batches, in the same order, over two
    epochs of the shuffled train set and one of the valid set."""
    make_svs_dataset(str(tmp_path), task="svs_rectified", rectified=True, n_train=12, n_valid=4)
    jtask, task = JaxRectifiedTask(rect_hp(tmp_path)), get_task_cls("svs_rectified")(
        rect_hp(tmp_path))
    jit, it = jtask.train_iterator(), task.train_iterator()
    pairs = [(jb, b) for _ in range(2) for jb, b in zip(jit, it)]
    pairs += list(zip(jtask.val_iterator(), task.val_iterator()))
    assert len(pairs) == 2 * len(jit) + len(jtask.val_iterator())
    for jb, b in pairs:
        assert set(jb) == set(b) >= {"condition", "x_T", "x_0", "mel2ph"}
        assert b["x_T"].shape == b["x_0"].shape == b["mel"].shape
        for k in jb:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(jb[k]), err_msg=k)


def _student(tmp_path, diff_type):
    """Seeded port student (every weight nudged: the output projection
    starts at zero), its JAX params by the carrier, and one padded batch."""
    make_svs_dataset(str(tmp_path), task="svs_rectified", rectified=True, n_train=6, n_valid=2)
    hp = rect_hp(tmp_path, diff_type)
    task = get_task_cls("svs_rectified")(hp)
    torch.manual_seed(3)
    model = task.build_model()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    ds = task.train_iterator().dataset
    batch = ds.collater([ds[i] for i in range(3)])
    batch.pop("nsamples")
    assert (batch["mel2ph"] == 0).any()  # padded frames
    return hp, task, model, batch


@pytest.mark.parametrize("diff_type", ["prodiff", "reflow"])
def test_student_loss_and_grads_match_jax(tmp_path, diff_type, jax_draws):
    """The student's losses and every gradient vs ``jax.value_and_grad`` of
    the JAX task's ``compute_losses`` on the same params (carried from the
    port), t injected (and the reflow start point; the DDPM student noises
    with the batch's x_T and draws none)."""
    hp, task, model, batch = _student(tmp_path, diff_type)
    rng = np.random.default_rng(9)
    b = batch["x_0"].shape[0]
    t = (np.array([1, 0, 1]) if diff_type == "prodiff"
         else rng.uniform(0.05, 0.95, b).astype(np.float32))
    noise = rng.normal(size=(b, 1, *batch["x_0"].shape[1:])).astype(np.float32)
    taken = jax_draws(t, noise)
    jtask = JaxRectifiedTask(hp)
    jtask.build_model()
    params = rectified_flax_params(model.state_dict(), hp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        losses = jtask.compute_losses(p, jb, jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    (jtotal, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    assert taken == {"t": 1, "noise": int(diff_type == "reflow")}

    model.train()
    losses = task.compute_losses(model, host_tensors(batch, pin=False), t=T(t),
                                 noise=T(noise) if diff_type == "reflow" else None)
    total = sum(losses.values())
    total.backward()
    assert set(losses) == set(jlosses) == ({"mel_l1", "mel_ssim"} if diff_type == "prodiff"
                                           else {"mel"})
    for k in losses:
        close(losses[k].detach(), jlosses[k])
    close(total.detach(), jtotal)
    want = rectified_state_dict(jax.tree.map(np.asarray, jgrads), hp)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        grad_close(p.grad, want[name], name)


def test_student_carrier_both_ways(tmp_path):
    """The port student's weights as the JAX student's tree (the structure
    of ``SVSRectifiedTask.init_params``) and back, exactly."""
    hp, task, model, batch = _student(tmp_path, "prodiff")
    jtask = JaxRectifiedTask(hp)
    jtask.build_model()
    shapes = jax.eval_shape(jtask.init_params, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tree = rectified_flax_params(model.state_dict(), hp)
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    assert list(tree["params"]) == ["denoise_fn"]
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype
    back = rectified_state_dict(tree, hp)
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, atol=0, rtol=0)


@pytest.mark.parametrize("net", ["denoise_fn", "velocity_fn"])
def test_convert_ckpt_matches_the_jax_cli(tmp_path, net):
    """A reference teacher checkpoint (``{"state_dict": {"model": ...}}``,
    torch names; a gender embed the config turns off; the reflow teacher's
    net named ``velocity_fn``) through ``convert_ckpt`` of both CLIs: the
    same file, byte for byte."""
    hp = dict(TEACHER_HP, use_gender_id=False, spec_min=[-12], spec_max=[0],
              diff_type="prodiff" if net == "denoise_fn" else "reflow")
    torch.manual_seed(4)
    sd = ProDiffTeacher(12, dict(hp, use_gender_id=True)).state_dict()
    sd = {k.replace("diffusion.denoise_fn.", f"diffusion.{net}."): v for k, v in sd.items()}
    assert "gender_embed.weight" in sd
    torch.save({"state_dict": {"model": sd}, "global_step": 11}, str(tmp_path / "ref.ckpt"))
    cfg = tmp_path / "teacher.yaml"
    cfg.write_text(yaml.dump(hp))
    outs = {w: str(tmp_path / w / "model_ckpt_steps_7.ckpt") for w in ("port", "jax")}
    port_cli(["convert_ckpt", str(tmp_path / "ref.ckpt"), "--config", str(cfg),
              "--out", outs["port"], "--step", "7"])
    jax_main.convert_ckpt.callback(torch_ckpt=str(tmp_path / "ref.ckpt"), config=str(cfg),
                                   out=outs["jax"], step=7)
    got, want = (jax_ckpt.load_checkpoint_file(outs[w]) for w in ("port", "jax"))
    assert_same_tree(got, want, exact=True)
    with open(outs["port"], "rb") as a, open(outs["jax"], "rb") as b:
        assert a.read() == b.read()
    assert got["optimizer_state"] == {} and got["global_step"] == 7
    assert "gender_embed" not in got["state_dict"]["params"]
    assert set(got["state_dict"]["params"]["diffusion"]) == {"denoise_fn"}


def test_distillation_loop_through_the_cli(tmp_path, monkeypatch):
    """``binarize svs``, ``train svs`` (3 steps), ``binarize svs_rectified``
    with that teacher, ``train svs_rectified`` (3 steps), ``merge_rectified``,
    all through the port's CLI on the CPU. The merged file equals the JAX
    ``merge_rectified`` of the same two files byte for byte, its
    ``diffusion`` is the student's, and the JAX teacher's one-step render of
    it equals the port's on the same noise."""
    monkeypatch.chdir(tmp_path)
    raw = write_corpus(tmp_path, n=5)
    hp = pipeline_hp(tmp_path, raw, "svs", max_updates=3)
    for key in ("task", "work_dir"):
        hp.pop(key)
    cfg = str(tmp_path / "svs.yaml")
    with open(cfg, "w") as f:
        yaml.dump(hp, f)
    work = tmp_path / "checkpoints" / "dl"
    port_cli(["binarize", "svs", "--config", cfg, "--exp_name", "dl", "--device", "cpu"])
    port_cli(["train", "svs", "--config", cfg, "--exp_name", "dl", "--device", "cpu"])
    rect_cfg = str(tmp_path / "rect.yaml")
    with open(rect_cfg, "w") as f:
        yaml.dump(dict(hp, teacher_ckpt=str(work / "svs")), f)
    port_cli(["binarize", "svs_rectified", "--config", rect_cfg, "--exp_name", "dl",
              "--device", "cpu"])
    assert len(IndexedDataset(str(tmp_path / "data" / "svs_rectified"), "train")) == 3
    port_cli(["train", "svs_rectified", "--config", rect_cfg, "--exp_name", "dl",
              "--device", "cpu"])
    losses = [json.loads(ln)["tr/total_loss"] for ln in open(work / "svs_rectified" / "metrics.jsonl")
              if "tr/total_loss" in ln]
    assert len(losses) == 3 and np.isfinite(losses).all()

    teacher, student = (str(work / t / "model_ckpt_steps_3.ckpt") for t in ("svs", "svs_rectified"))
    shutil.copy(teacher, tmp_path / "jax_teacher.ckpt")
    port_cli(["merge_rectified", teacher, student])
    jax_main.merge_rectified.callback(target_ckpt=str(tmp_path / "jax_teacher.ckpt"),
                                      component_ckpt=student)
    merged_path = teacher + ".merged.ckpt"
    with open(merged_path, "rb") as a, open(str(tmp_path / "jax_teacher.ckpt.merged.ckpt"),
                                            "rb") as b:
        assert a.read() == b.read()
    merged = ckpt_utils.load_checkpoint_file(merged_path)
    assert_same_tree(merged["state_dict"]["params"]["diffusion"],
                     ckpt_utils.load_checkpoint_file(student)["state_dict"]["params"], exact=True)

    # the merged teacher renders at timesteps 1 in both packages
    thp = dict(hp, timesteps=1)
    with open(tmp_path / "data" / "svs" / "phone_set.json") as f:
        vocab = len(TokenTextEncoder(sorted(set(json.load(f).values()))))
    item = IndexedDataset(str(tmp_path / "data" / "svs"), "valid")[0]
    rng = np.random.default_rng(13)
    t_mel = item["mel2ph"].shape[0]
    inp = {"txt_tokens": item["ph_seq"][None], "mel2ph": item["mel2ph"][None],
           "f0": item["f0"][None].astype(np.float32), "lang_seq": item["lang_seq"][None],
           "spk_embed_id": np.array([item["spk_id"]])}
    noise = {"init_noise": rng.uniform(size=(1, 1, t_mel, 32)).astype(np.float32),
             "step_noises": rng.normal(size=(1, 1, 1, t_mel, 32)).astype(np.float32)}
    jmodel = JaxTeacher(vocab_size=vocab, hparams=thp)
    j = {k: jnp.asarray(v) for k, v in {**inp, **noise}.items()}
    want = jax.jit(lambda p, j: jmodel.apply(
        p, j["txt_tokens"], j["mel2ph"], j["f0"], lang_seq=j["lang_seq"],
        spk_embed_id=j["spk_embed_id"], init_noise=j["init_noise"],
        step_noises=j["step_noises"], infer=True, infer_step=1))(merged["state_dict"], j)
    model = ProDiffTeacher(vocab, thp).eval()
    model.load_state_dict(teacher_state_dict(merged["state_dict"], thp))
    t = {k: T(v) for k, v in {**inp, **noise}.items()}
    got = model.infer(t["txt_tokens"], t["mel2ph"], t["f0"], infer_step=1,
                      init_noise=t["init_noise"], step_noises=t["step_noises"],
                      lang_seq=t["lang_seq"], spk_embed_id=t["spk_embed_id"])
    assert got.shape == (1, t_mel, 32) and torch.isfinite(got).all()
    close(got, want)
