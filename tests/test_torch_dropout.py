"""The port's dropout (``prodiff_tpu_torch/models/common.py:Dropout``) vs
flax's, and its masks under the mesh, on the CPU.

- the function: with the mask flax's ``nn.Dropout`` drew injected, the
  port's output is flax's, bit for bit (the rate is the share dropped, kept
  values scaled by ``1 / (1 - p)``), in float32 and bf16; ``p == 1`` gives
  zeros;
- eval mode, ``p == 0`` and ``p == 1`` draw nothing, from the step's
  generator or torch's default one; outside a step the masks come from the
  default generator;
- the rows a rank draws inside ``batch_rows`` are its rows of the
  one-process draw, exactly, for one ``Dropout`` and for every mask of a
  ``FastspeechEncoder`` in train mode; under ``tp`` of 2 the FFN's mask
  columns are the one-process mask's columns at ``_index("out", ...)``, the
  index ``shard_for_rank`` cuts ``ffn_1`` with;
- a two-rank data-parallel ``fit`` step (per-process loading) and a
  ``model_parallel: 2`` one, both with dropout 0.1 (worker case
  ``dropout_fit``): every mask the ranks drew is its part of the
  one-process step's, and the loss, gradient norm, gradients and update
  are the one-process step's on the global batch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu_torch.models.common import Dropout, TransformerFFNLayer, dropout_generator
from prodiff_tpu_torch.models.encoder import FastspeechEncoder
from prodiff_tpu_torch.parallel.megatron import TensorParallel, _index
from prodiff_tpu_torch.parallel.mesh import batch_rows
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.training.trainer import Trainer
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams
from tests.test_torch_parallel import grad_close, run_ranks
from tests.torch_parallel_worker import record_masks, seed_output_projection

P = 0.1


def _mask(drop, shape, rows=None, seed=5):
    with batch_rows(rows), dropout_generator(torch.Generator().manual_seed(seed)):
        return drop.keep(shape, torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_is_flax_dropout(p, dtype):
    """flax's mask (its zeros, on an input without any) injected into the
    port: the same output, bit for bit; each side keeps 1 - p of the values
    within 4.5 sigma."""
    x = np.random.default_rng(0).normal(size=(4, 16, 32)).astype(np.float32)
    x[x == 0] = 1.0
    want = fnn.Dropout(p).apply({}, jnp.asarray(x, dtype), deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(3)})
    keep = np.asarray(want) != 0
    drop = Dropout(p).train()
    drop.keep = lambda shape, device: torch.from_numpy(keep)
    got = drop(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    sigma = (p * (1 - p) / x.size) ** 0.5
    own = _mask(Dropout(p), x.shape).float().mean().item()
    for share in (keep.mean(), own):
        assert abs(share - (1 - p)) < 4.5 * sigma, share
    ones = Dropout(1.0).train()(torch.from_numpy(x))
    assert torch.equal(ones, torch.zeros_like(ones))


def test_dropout_draws_nothing_where_it_is_off():
    """Eval mode and ``p`` of 0 or 1 return without a draw, from the step's
    generator or the default one; a drawing call moves the generator it
    was handed, and outside a step the default one, as torch's draws."""
    x = torch.randn(2, 8, 16)
    gen = torch.Generator().manual_seed(11)
    state, default = gen.get_state(), torch.get_rng_state()
    for drop in (Dropout(0.0).train(), Dropout(P).eval(), Dropout(1.0).train()):
        with dropout_generator(gen):
            drop(x)
        drop(x)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(torch.get_rng_state(), default)
    with dropout_generator(gen):
        Dropout(P).train()(x)
    assert not torch.equal(gen.get_state(), state)
    assert torch.equal(torch.get_rng_state(), default)
    torch.manual_seed(9)
    got = Dropout(P).train()(x)
    torch.manual_seed(9)
    assert torch.equal(got, torch.where(torch.rand(x.shape) >= P, x / (1 - P), 0.0))


def test_ranks_rows_are_the_one_process_draw():
    """Two data ranks' masks, each drawn inside ``batch_rows`` at its 2 rows
    of a global batch of 4, are the one-process mask's rows, exactly."""
    drop = Dropout(P)
    one = _mask(drop, (4, 24, 32))
    halves = [_mask(drop, (2, 24, 32), rows=(2 * r, 4)) for r in range(2)]
    assert torch.equal(torch.cat(halves), one)
    assert not torch.equal(halves[0], halves[1])


def test_encoder_masks_are_rows_of_the_one_process_draw():
    """A ``FastspeechEncoder`` of 2 layers in train mode (its 7 masks: the
    embeddings' and each layer's three), run by two data ranks on their rows of the
    batch: every mask is the rows of the one-process run's, exactly, and
    the outputs its rows."""
    tokens = torch.from_numpy(np.random.default_rng(1).integers(1, 32, (4, 24)))
    tokens[:, -5:] = 0
    torch.manual_seed(0)
    enc = FastspeechEncoder(32, 32, 2, num_heads=2, dropout=P).train()
    masks, patch = record_masks()
    with patch, dropout_generator(torch.Generator().manual_seed(7)):
        want = enc(tokens)
    one = [m for _, m in masks]
    assert len(one) == 7
    for r in range(2):
        masks.clear()
        with patch, batch_rows((2 * r, 4)), dropout_generator(torch.Generator().manual_seed(7)):
            got = enc(tokens[2 * r:2 * r + 2])
        assert len(masks) == len(one)
        for (_, m), o in zip(masks, one):
            assert torch.equal(m, o[2 * r:2 * r + 2])
        torch.testing.assert_close(got, want[2 * r:2 * r + 2], atol=1e-6, rtol=1e-6)


def test_ffn_mask_columns_under_tp_are_the_one_process_columns():
    """Under ``tp`` of 2 the FFN's hidden mask is drawn at the full filter
    width: rank r keeps the columns at ``_index("out", 128, r, 2)`` (the
    rows ``shard_for_rank`` cuts ``ffn_1`` with), within its data rank's
    rows; the two halves differ (no mask repeated on each model rank)."""
    one = _mask(TransformerFFNLayer(32, 128, dropout=P).dropout, (4, 24, 128))
    for data_rank in range(2):
        rows = slice(2 * data_rank, 2 * data_rank + 2)
        halves = []
        for r in range(2):
            ffn = TransformerFFNLayer(32, 128, dropout=P, tp=TensorParallel(None, r, 2))
            assert ffn.ffn_1.out_channels == 64
            got = _mask(ffn.dropout, (2, 24, 64), rows=(2 * data_rank, 4))
            assert torch.equal(got, one[rows][..., _index("out", 128, r, 2)])
            halves.append(got)
        assert not torch.equal(halves[0], halves[1])


# ---- a multi-rank step with dropout on --------------------------------------------------

@pytest.fixture(scope="module")
def dropout_data(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("dropout_data"))
    make_svs_dataset(data_dir, n_train=16, n_valid=4)
    return data_dir


@pytest.fixture(scope="module")
def dropout_ranks(dropout_data, tmp_path_factory):
    """One ``dropout_fit`` run of two ranks: its ranks' results."""
    return run_ranks("dropout_fit", 2, tmp_path_factory.mktemp("dropout_fit") / "ranks",
                     dropout_data)


@pytest.fixture(scope="module")
def one_process(dropout_data, tmp_path_factory):
    """The port's one-process step with dropout 0.1 on the ranks' global
    batch (constant learning rate 1e-3, the output projection seeded): its
    metrics, masks, gradients and the params before and after."""
    hp = small_hparams(dropout_data, dropout=P, scheduler="constant", lr=1e-3,
                       work_dir=str(tmp_path_factory.mktemp("dropout_one")))
    one = Trainer(hp, device="cpu")
    task = get_task_cls("svs")(hp)
    one.build(task)
    seed_output_projection(one.model)
    before = {k: v.clone() for k, v in one.model.state_dict().items()}
    _, batch = next(iter(one._prefetcher(task.train_iterator(2))))
    masks, patch = record_masks()
    with patch:
        metrics = {k: float(v) for k, v in one.train_step(batch).items()}
    return {"metrics": metrics, "masks": [m for _, m in masks], "b": batch["mel"].shape[0], "before": before,
            "grads": {n: p.grad.clone() for n, p in one.model.named_parameters()},
            "params": {k: v.clone() for k, v in one.model.state_dict().items()}}


@pytest.mark.parametrize("mp", [1, 2], ids=["data_parallel", "model_parallel"])
def test_multi_rank_step_with_dropout_is_the_one_process_step(mp, dropout_ranks, one_process):
    """Two ranks, data parallel (4 rows each, loaded per process) or at
    ``model_parallel: 2``, one ``fit`` step with dropout 0.1: each mask is
    the one-process step's rows and, on the FFN's split hidden, its columns,
    exactly; the loss, gradient norm and gradients within 1e-4 of the peak
    and 1e-3 relative; each tensor's update within 1e-3 of the one-process
    update's norm."""
    one, b = one_process, one_process["b"]
    for rank, res in enumerate(dropout_ranks):
        r = res[mp]
        row0 = 0 if mp == 2 else rank * b // 2
        n = b if mp == 2 else b // 2
        assert r["rows"] == [(row0, b)]
        assert len(r["masks"]) == len(one["masks"]) > 0
        split = 0
        for (tp, got), want in zip(r["masks"], one["masks"]):
            want = want[row0:row0 + n]
            if tp:
                want = want[..., _index("out", want.shape[-1], r["model_rank"], mp)]
                split += 1
            assert torch.equal(got, want)
        assert split == (1 if mp == 2 else 0)  # small_hparams: one encoder layer
        for key in ("total_loss", "grad_norm"):
            grad_close(r["metrics"][0][key], one["metrics"][key], key)
        assert set(r["grads"]) == set(one["grads"])
        for name, g in one["grads"].items():
            grad_close(r["grads"][name], g, name)
        for name, p in one["params"].items():
            moved = (p - one["before"][name]).numpy()
            off = np.linalg.norm(r["params"][name].numpy() - one["before"][name].numpy() - moved)
            assert off <= 1e-3 * np.linalg.norm(moved), (name, off, np.linalg.norm(moved))


def test_jax_step_with_dropout_is_the_same_on_a_data_mesh(dropout_data, tmp_path):
    """The reference's own property, which the port's masks follow: the JAX
    svs step with dropout 0.1 gives the same losses and gradient norm on a
    (2, 1) mesh as on one device (``jax.random`` draws do not depend on the
    sharding), on the global batch and key of the port's tests."""
    from prodiff_tpu.parallel.mesh import batch_sharding
    from prodiff_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from prodiff_tpu.tasks import get_task_cls as jax_task_cls
    from prodiff_tpu.training.trainer import Trainer as JaxTrainer

    hp = small_hparams(dropout_data, dropout=P, work_dir=str(tmp_path))
    runs = []
    for n in (1, 2):
        mesh = jax_create_mesh(n)
        jt = JaxTrainer(dict(hp), mesh=mesh)
        jtask = jax_task_cls("svs")(dict(hp))
        batch = next(iter(jtask.train_iterator(2)))
        batch.pop("nsamples")
        jt.build(jtask, batch)
        sharded = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                                 batch_sharding(mesh))
        _, metrics = jt.train_step(jt.state, sharded, jax.random.PRNGKey(hp["seed"]))
        runs.append({k: float(v) for k, v in jax.device_get(metrics).items()})
    assert set(runs[0]) >= {"total_loss", "grad_norm"}
    for k, v in runs[0].items():
        np.testing.assert_allclose(runs[1][k], v, rtol=1e-5, err_msg=k)
