"""Multi-process training of the port (``prodiff_tpu_torch/parallel``) vs the
JAX package's mesh, on the CPU.

The ranks run in worker processes (``tests/torch_parallel_worker.py``: two
ranks over ``gloo``, started by ``parallel.mesh.launch_local`` with
torchrun's environment and joined to the store it holds, each call killed
after ``RANK_TIMEOUT``); the JAX side runs here, on conftest's 8 virtual
devices.

- the (data, model) layout and ``process_data_blocks`` vs JAX
  ``create_mesh`` / ``process_data_blocks`` (one device a process), and the
  mesh's divisibility assertion;
- a two-rank data-parallel step (per-process loading, and the global batch
  cut by ``shard_batch``): the reduced gradients, the metrics and the
  params after the update vs the port's one-process step on the global
  batch, and the gradients vs ``jax.value_and_grad`` of the JAX task's
  ``compute_losses`` on that batch with the same draws injected;
- two-rank tensor-parallel ``WaveNet`` and ``FastspeechEncoder`` (forward
  and gradients) vs the JAX modules on a (4, 2) mesh, at
  ``tests/test_tp_wavenet.py``'s and ``tests/test_tp_encoder.py``'s sizes and
  tolerances;
- a ``model_parallel: 2`` fit of 2 steps: each step's total loss and
  gradient norm and its gathered checkpoint vs the port's one-process steps
  (Adam's moments at 1e-4 of each one's peak, each tensor's update within
  1e-3 of its own, the params within twice the summed learning rates),
  restored by the JAX trainer on a (4, 2) mesh;
- a data-parallel resume where only rank 0's work dir holds the checkpoint
  (no shared disk): every rank resumes at its step, as the one-process
  trainer does;
- a data-parallel fit on a dataset without the item-lengths sidecar loads
  the global batch and cuts it, as the JAX trainer's one process loads it:
  its step vs the one-process step; with ``multi_host: true`` it raises;
- the validation plots at ``model_parallel: 2``: both ranks of the model
  axis render, rank 0 draws, the mel equal to the one-process render;
- the ranks join a store the launcher bound before it started them (no
  port chosen, released and bound again), and leave their group when their
  function returns.

Dropout is off here, where the JAX side draws its own masks; a multi-rank
step with dropout on is held against the port's one-process step in
``tests/test_torch_dropout.py``.
"""

import os
import shutil
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from prodiff_tpu.models.encoder import FastspeechEncoder as JaxEncoder
from prodiff_tpu.models.wavenet import WaveNet as JaxWaveNet
from prodiff_tpu.parallel.mesh import create_mesh as jax_create_mesh
from prodiff_tpu.parallel.mesh import process_data_blocks as jax_process_data_blocks
from prodiff_tpu.tasks import get_task_cls as jax_task_cls
from prodiff_tpu.training.trainer import Trainer as JaxTrainer
from prodiff_tpu_torch.parallel.mesh import (
    LAUNCHER_ENV,
    Mesh,
    create_mesh,
    init_distributed,
    mesh_grid,
    process_data_blocks,
)
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.training.trainer import Trainer
from prodiff_tpu_torch.utils import ckpt_utils
from prodiff_tpu_torch.utils.convert import (
    encoder_state_dict,
    teacher_flax_params,
    teacher_state_dict,
    wavenet_state_dict,
)
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams
from tests.torch_parallel_worker import seed_output_projection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
# seconds: over twice the slowest call (``fit``, ~25 s under the suite's
# ``-n 6`` load) times the heavier load a shared machine has shown (a ~18 s
# ``dp_fit`` once took over 60 s there)
RANK_TIMEOUT = 180


def run_ranks(case, n, outdir, *args):
    """``case`` on ``n`` ranks; every rank's saved results."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    os.makedirs(outdir, exist_ok=True)
    proc = subprocess.Popen([sys.executable, WORKER, case, str(n), str(outdir), *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{case}: the ranks did not finish in {RANK_TIMEOUT} s\n{out}")
    assert proc.returncode == 0, out
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


def grad_close(got, want, name):
    want = np.asarray(want)
    peak = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4 * peak, rtol=1e-3, err_msg=name)


# ---- the layout ----------------------------------------------------------------------

@pytest.mark.parametrize("mp", [1, 2, 4])
def test_mesh_layout_matches_jax(mp, monkeypatch):
    """World 8: the ranks' (data, model) grid is the JAX mesh's device grid,
    and each rank's data blocks are what JAX ``process_data_blocks`` gives a
    process owning that one device."""
    jmesh = jax_create_mesh(8, model_parallel=mp)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(8 // mp, mp)
    grid = mesh_grid(8, mp)
    np.testing.assert_array_equal(grid, ids)
    one_each = types.SimpleNamespace(
        axis_names=jmesh.axis_names,
        devices=np.vectorize(lambda d: types.SimpleNamespace(process_index=d.id),
                             otypes=[object])(jmesh.devices))
    for rank in range(8):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        mesh = Mesh(grid, rank, torch.device("cpu"))
        assert process_data_blocks(mesh) == jax_process_data_blocks(one_each)
        assert (mesh.data_rank, mesh.model_rank) == tuple(np.argwhere(ids == rank)[0])


def test_mesh_divisibility_and_launcher_environment(monkeypatch):
    """A world that model_parallel does not divide raises the JAX mesh's
    assertion; a half-set launcher environment raises rather than run one
    process; without one, a world of one."""
    with pytest.raises(AssertionError) as jax_err:
        jax_create_mesh(8, model_parallel=3)
    with pytest.raises(AssertionError) as err:
        mesh_grid(8, 3)
    assert str(err.value) == str(jax_err.value) == "8 devices not divisible by model_parallel=3"
    with pytest.raises(AssertionError, match="1 devices not divisible by model_parallel=2"):
        create_mesh(model_parallel=2)
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed({}, device="cpu") == torch.device("cpu")
    assert create_mesh().size == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="half set"):
        init_distributed({}, device="cpu")


# ---- data parallelism ---------------------------------------------------------------

@pytest.fixture(scope="module")
def svs_data(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("parallel_data"))
    make_svs_dataset(data_dir, n_train=16, n_valid=4)
    return data_dir


def _jax_grads(hp, sd, batch, t, noise, monkeypatch):
    """The JAX task's total loss and gradients (port names) on ``batch``
    with the draws ``t`` and ``noise`` injected, dropout off."""
    def fixed(value, dtype, orig):
        def draw(key, shape=(), *args, **kwargs):
            if tuple(shape) != value.shape:
                return orig(key, shape, *args, **kwargs)
            return jnp.asarray(value, dtype)
        return draw

    monkeypatch.setattr(jax.random, "randint", fixed(t, jnp.int32, jax.random.randint))
    monkeypatch.setattr(jax.random, "normal", fixed(noise, jnp.float32, jax.random.normal))
    jtask = jax_task_cls("svs")(dict(hp))
    jtask.model = jtask.build_model()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return sum(jtask.compute_losses(p, jb, jax.random.PRNGKey(0), deterministic=True).values())

    total, grads = jax.jit(jax.value_and_grad(loss))(teacher_flax_params(sd, hp))
    return float(total), teacher_state_dict(jax.tree.map(np.asarray, grads), hp)


def test_data_parallel_step_matches_one_process_and_jax(svs_data, tmp_path, monkeypatch):
    """The denoiser's output projection seeded on both sides, so the step's
    gradients reach every layer."""
    ranks = run_ranks("dp_step", 2, tmp_path / "ranks", svs_data)
    hp = small_hparams(svs_data, dropout=0.0, work_dir=str(tmp_path / "one"))
    one = Trainer(hp, device="cpu")
    task = get_task_cls("svs")(hp)
    one.build(task)
    seed_output_projection(one.model)
    before = {k: v.clone() for k, v in one.model.state_dict().items()}
    numpy_batch = next(iter(task.train_iterator(2)))
    numpy_batch.pop("nsamples")
    _, batch = next(iter(one._prefetcher(task.train_iterator(2))))
    b = batch["mel"].shape[0]
    metrics = {k: float(v) for k, v in one.train_step(batch).items()}
    assert float(dict(one.model.named_parameters())[
        "encoder.layers.0.op.self_attn.in_proj_weight"].grad.abs().max()) > 0
    for per_process in (True, False):
        r0, r1 = ranks[0][per_process], ranks[1][per_process]
        assert r0["rows"] == (0, b) and r1["rows"] == (b // 2, b)
        assert torch.equal(torch.cat([r0["mel"], r1["mel"]]), batch["mel"])
        for k, v in metrics.items():
            assert r0["metrics"][k] == r1["metrics"][k]
            np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5, err_msg=k)
        for n, p in one.model.named_parameters():
            assert torch.equal(r0["grads"][n], r1["grads"][n]), n
            assert torch.equal(r0["params"][n], r1["params"][n]), n
            grad_close(r0["grads"][n], p.grad, n)
            np.testing.assert_allclose(r0["params"][n], p.detach(), atol=1e-6, rtol=1e-5,
                                       err_msg=n)
    # the global draws of the one-process step (its generator, seeded for step 0)
    gen = torch.Generator().manual_seed(hp["seed"] * 2 ** 32)
    t = torch.randint(0, hp["timesteps"] + 1, (b,), generator=gen).numpy()
    noise = torch.randn((b, 1, *batch["mel"].shape[1:]), generator=gen).numpy()
    jtotal, jgrads = _jax_grads(hp, before, numpy_batch, t, noise, monkeypatch)
    np.testing.assert_allclose(ranks[0][True]["metrics"]["total_loss"], jtotal, rtol=1e-4)
    for n, g in jgrads.items():
        grad_close(ranks[0][True]["grads"][n], g, n)


# ---- tensor parallelism ------------------------------------------------------------

def _perturbed(params):
    return jax.tree.map(
        lambda a: a if a.ndim == 0 else a + 0.01 * np.random.default_rng(1)
        .normal(size=a.shape).astype(np.float32), params)


def _tp_vs_jax(tmp_path, name, sd, inputs, probe, jax_out, jax_grads, state_dict_of):
    npz = tmp_path / "case.npz"
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()},
             **{f"in.{k}": v for k, v in inputs.items()}, **{"in.probe": probe})
    r0, r1 = run_ranks("tp_module", 2, tmp_path / "ranks", name, npz)
    assert r0["kinds"] and r0["round_trip"] and r1["round_trip"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["out"], jax_out, atol=2e-5, rtol=1e-4)
    want = state_dict_of(jax.tree.map(np.asarray, jax_grads))
    assert set(want) == set(r0["grads"])
    for n, g in want.items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        np.testing.assert_allclose(r0["grads"][n], g, atol=1e-4, rtol=1e-3, err_msg=n)


def test_tp_wavenet_matches_jax(rng, tmp_path):
    """The denoiser at 128 channels, 64 a rank, vs the JAX TP route on a
    (4, 2) mesh: the output and the gradient of every parameter."""
    kw = dict(in_dims=16, hidden_size=32, residual_layers=4, residual_channels=128,
              dilation_cycle_length=1, use_pallas=False)
    b, t = 4, 24
    x = rng.normal(size=(b, t, 16)).astype(np.float32)
    steps = np.asarray([0, 1, 2, 3])
    cond = rng.normal(size=(b, t, 32)).astype(np.float32)
    params = _perturbed(JaxWaveNet(**kw).init(jax.random.PRNGKey(0), x, steps, cond))
    probe = np.random.default_rng(3).normal(size=(b, t, 16)).astype(np.float32)
    tp_net = JaxWaveNet(**kw, tp_axis="model", tp_size=2)
    mesh = jax_create_mesh(8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    with jax.set_mesh(mesh):
        out = np.asarray(jax.jit(tp_net.apply)(params, x, steps, cond))
        grads = jax.jit(jax.grad(lambda p: jnp.sum(tp_net.apply(p, x, steps, cond) * probe)))(
            params)
    _tp_vs_jax(tmp_path, "wavenet", wavenet_state_dict(params["params"], 4, prefix=""),
               {"x": x, "t": steps, "cond": cond}, probe, out, grads["params"],
               lambda g: wavenet_state_dict(g, 4, prefix=""))


def test_tp_encoder_matches_jax(rng, tmp_path):
    """The phoneme encoder at hidden 64 with 2 heads, one head a rank, vs the
    JAX TP encoder on a (4, 2) mesh: the output and every gradient."""
    tokens = rng.integers(1, 32, (4, 24)).astype(np.int32)
    tokens[:, -4:] = 0  # a padded tail
    kw = dict(vocab_size=32, hidden_size=64, num_layers=2, num_heads=2, dropout=0.0)
    params = JaxEncoder(**kw).init(jax.random.PRNGKey(0), tokens)
    probe = np.random.default_rng(3).normal(size=(4, 24, 64)).astype(np.float32)
    tp_enc = JaxEncoder(**kw, tp_axis="model")
    with jax.set_mesh(jax_create_mesh(8, model_parallel=2)):
        out = np.asarray(jax.jit(tp_enc.apply)(params, tokens))
        grads = jax.jit(jax.grad(lambda p: jnp.sum(tp_enc.apply(p, tokens) * probe)))(params)
    _tp_vs_jax(tmp_path, "encoder", encoder_state_dict(params["params"], 2, prefix=""),
               {"tokens": tokens}, probe, out, grads["params"],
               lambda g: encoder_state_dict(g, 2, prefix=""))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


@pytest.fixture(scope="module")
def mp_fit(svs_data, tmp_path_factory):
    """One ``fit`` run of two ranks at ``model_parallel: 2``: its ranks'
    results and their directory."""
    out = tmp_path_factory.mktemp("mp_fit") / "ranks"
    return run_ranks("fit", 2, out, svs_data), out


def _one_process_steps(svs_data, tmp_path, n):
    """The port's one-process trainer after ``n`` steps on the two-rank
    run's global batches (constant learning rate 1e-3): the trainer, its
    task, the state before, each step's metrics and learning rate."""
    hp = small_hparams(svs_data, dropout=0.0, work_dir=str(tmp_path / "one"),
                       scheduler="constant", lr=1e-3)
    one = Trainer(hp, device="cpu")
    task = get_task_cls("svs")(hp)
    one.build(task)
    before = {k: v.clone() for k, v in one.model.state_dict().items()}
    steps = []
    for _, (_, batch) in zip(range(n), one._prefetcher(task.train_iterator(2))):
        lr = one.optimizer.lr()
        steps.append(({k: float(v) for k, v in one.train_step(batch).items()}, lr))
        one.global_step += 1
    return one, task, before, steps


def test_model_parallel_fit_matches_one_process_and_restores_in_jax(mp_fit, svs_data, tmp_path):
    """``model_parallel: 2`` on two ranks (the encoder one head a rank, the
    denoiser 8 of 16 channels), 2 steps through ``Trainer.fit`` at a
    constant learning rate (step 1 moves the zero-initialised output
    projection, so step 2's gradients reach every layer): the
    checkpoint holds the one-process layout, equal to the port's
    one-process steps on the same global batches, and the JAX trainer on a
    (4, 2) mesh restores it exactly."""
    ranks, out = mp_fit
    assert ranks[0]["kinds"] == ranks[1]["kinds"]
    assert ranks[0]["shapes"]["diffusion.denoise_fn.residual_layers.0.dilated_conv.weight"] \
        == (16, 16, 3)
    work = str(out / "work")
    written = ckpt_utils.load_checkpoint_file(os.path.join(work, "model_ckpt_steps_2.ckpt"))
    assert written["global_step"] == 2

    one, task, before, steps = _one_process_steps(svs_data, tmp_path, 2)
    hp = one.hparams
    lrs = [lr for _, lr in steps]
    for i, (metrics, _) in enumerate(steps):
        for r in ranks:
            for key in ("total_loss", "grad_norm"):
                np.testing.assert_allclose(r["metrics"][i][key], metrics[key],
                                           rtol=1e-4, err_msg=f"step {i + 1} {key}")
    got = dict(_leaves(written["optimizer_state"]))
    want = dict(_leaves(one.optimizer.state_dict()))
    assert set(got) == set(want)
    for k, v in want.items():
        grad_close(got[k], v, k)
    got_sd = teacher_state_dict(written["state_dict"], hp)
    for n, p in one.model.state_dict().items():
        np.testing.assert_allclose(got_sd[n], p, atol=2 * sum(lrs) + 1e-6, rtol=1e-5, err_msg=n)
        # the update, which a run that left the tensor unchanged would miss by all of it
        moved = (p - before[n]).numpy()
        off = np.linalg.norm(np.asarray(got_sd[n]) - before[n].numpy() - moved)
        assert off <= 1e-3 * np.linalg.norm(moved), (n, off, np.linalg.norm(moved))

    jhp = dict(hp, model_parallel=2, work_dir=work)
    jt = JaxTrainer(jhp)
    assert jt.mesh.shape == {"data": 4, "model": 2}
    jtask = jax_task_cls("svs")(dict(jhp))
    first = next(iter(jtask.train_iterator(jt.n_devices)))
    first.pop("nsamples")
    jt.build(jtask, first)
    assert jt.restore_checkpoint() and jt.global_step == 2
    restored = jax.tree.map(np.asarray, jax.device_get(jt.state))
    for tree, key in ((restored["params"], "state_dict"), (restored["opt_state"],
                                                           "optimizer_state")):
        got = dict(_leaves(serialization.to_state_dict(tree)))
        want = dict(_leaves(written[key]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ranks_resume_from_rank_0s_checkpoint(svs_data, tmp_path):
    """Rank 0 reads the checkpoint in its work dir and every rank resumes
    from it: rank 1, whose own work dir is empty (ranks without a shared
    disk), reaches step 3 from step 2 as rank 0 does, with its weights, and
    writes nothing; rank 0's step 3 is the one-process trainer's resumed
    from the same checkpoint."""
    hp = small_hparams(svs_data, dropout=0.0, work_dir=str(tmp_path / "work0"),
                       val_check_interval=1000)
    Trainer(hp, device="cpu").fit(get_task_cls("svs")(hp), max_steps=2)
    shutil.copytree(tmp_path / "work0", tmp_path / "one")
    ranks = run_ranks("resume", 2, tmp_path / "ranks", svs_data, tmp_path / "work0")
    assert [r["global_step"] for r in ranks] == [3, 3]
    assert ranks[1]["files"] == []
    assert "model_ckpt_steps_3.ckpt" in ranks[0]["files"]
    one = Trainer(dict(hp, work_dir=str(tmp_path / "one")), device="cpu")
    one.fit(get_task_cls("svs")(one.hparams), max_steps=3)
    assert one.global_step == 3
    for n, p in one.model.named_parameters():
        assert torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]), n
        np.testing.assert_allclose(ranks[0]["params"][n], p.detach(), atol=1e-6, rtol=1e-5,
                                   err_msg=n)


def test_model_parallel_fit_draws_validation_plots(mp_fit, svs_data, tmp_path):
    """The validation at step 2 of the ``model_parallel: 2`` fit: both ranks
    of the model axis render the first validation batch (the tensor-parallel
    model needs them both) to one mel, rank 0 draws it, and it is the
    one-process render after the same 2 steps (draws seeded from (seed,
    step)) within 1e-4 of its peak."""
    from prodiff_tpu_torch.tasks.base import plot_generator

    ranks, out = mp_fit
    m0, m1 = (r["mels"] for r in ranks)
    assert len(m0) == len(m1) == 1
    assert torch.equal(m0[0], m1[0])
    plots = sorted(os.listdir(out / "work" / "plots"))
    assert "mel_0_step2.png" in plots and all(p.endswith("_step2.png") for p in plots)
    one, task, _, _ = _one_process_steps(svs_data, tmp_path, 2)
    _, batch = next(iter(one._prefetcher(task.val_iterator(2))))
    one.model.eval()
    with torch.no_grad():
        want = task.infer_mels(one.model, batch, plot_generator(one.hparams, 2, "cpu"))
    assert m0[0].shape == want.shape
    grad_close(m0[0], want, "validation mel")


# ---- loading without the item-lengths sidecar -----------------------------------------

@pytest.fixture(scope="module")
def no_sidecar(tmp_path_factory):
    """A dataset written without ``{prefix}_item_lengths.npz`` (as the
    reference's binarizer writes it) and one ``dp_fit`` run of two ranks."""
    data_dir = str(tmp_path_factory.mktemp("no_sidecar_data"))
    make_svs_dataset(data_dir, n_train=16, n_valid=4)
    task_dir = os.path.join(data_dir, "svs")
    for name in os.listdir(task_dir):
        if name.endswith("_item_lengths.npz"):
            os.remove(os.path.join(task_dir, name))
    out = tmp_path_factory.mktemp("no_sidecar") / "ranks"
    return data_dir, run_ranks("dp_fit", 2, out, data_dir)


def test_fit_without_sidecar_loads_the_global_batch(no_sidecar, tmp_path):
    """Two data-parallel ranks fit one step on the dataset without the
    sidecar: each takes its half of the global batch (``shard_batch``), and
    the step's loss, gradient norm, gradients and params are the
    one-process step's on that batch (the output projection seeded)."""
    data_dir, ranks = no_sidecar
    hp = small_hparams(data_dir, dropout=0.0, work_dir=str(tmp_path / "one"))
    one = Trainer(hp, device="cpu")
    task = get_task_cls("svs")(hp)
    one.build(task)
    seed_output_projection(one.model)
    _, batch = next(iter(one._prefetcher(task.train_iterator(2))))
    b = batch["mel"].shape[0]
    metrics = {k: float(v) for k, v in one.train_step(batch).items()}
    assert [r["rows"] for r in ranks] == [[(0, b)], [(b // 2, b)]]
    for r in ranks:
        for key in ("total_loss", "grad_norm"):
            grad_close(r["metrics"][0][key], metrics[key], key)
        for n, p in one.model.named_parameters():
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
            grad_close(r["grads"][n], p.grad, n)
            grad_close(r["params"][n], p.detach(), n)


def test_multi_host_without_sidecar_raises(no_sidecar):
    """``multi_host: true`` under torchrun's environment still needs the
    sidecar, as the JAX multi-process path does."""
    _, ranks = no_sidecar
    for r in ranks:
        assert "train_item_lengths.npz sidecar" in (r["multi_host_error"] or "")


# ---- the rendezvous -------------------------------------------------------------------

def test_worker_leaves_the_group_when_it_returns(monkeypatch):
    """``launch_local``'s rank body, run here as a world of one: after its
    function returns the rank has left the group it joined (a rank that
    exits still in a gloo group whose peer runs on aborted in the group's
    teardown, about one exit in twenty under load)."""
    import torch.distributed as dist

    from prodiff_tpu_torch.parallel import mesh

    for k in (*LAUNCHER_ENV, mesh.AGENT_STORE_ENV):
        monkeypatch.setenv(k, "")
    joined = []

    def join():
        init_distributed({}, device="cpu")
        joined.append(dist.get_world_size())

    with mesh.rendezvous() as port:
        mesh._worker(0, 1, port, "parity", join, ())
    assert joined == [1] and not dist.is_initialized()


def test_launcher_holds_the_rendezvous_store(tmp_path):
    """``launch_local``'s ranks find the store's port already bound and
    listening before any of them joins (the launcher holds it, as torchrun's
    agent does), join it as clients and reduce over the group."""
    ranks = run_ranks("rendezvous", 2, tmp_path / "ranks")
    for r in ranks:
        assert r["listening"] and r["agent_store"] == "True" and r["world"] == 2.0
