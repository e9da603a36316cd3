"""The multi-device keys where one device cannot honour them, in the
PyTorch port beside the JAX package, on the CPU.

The JAX package acts on ``model_parallel`` (a (data, model) mesh, asserted
to divide the device count, and a tensor-parallel teacher that raises for
``dilation_cycle_length != 1``) and on ``multi_host`` (``jax.distributed``
initialisation, which raises without a coordinator). So does the port: its
``Trainer`` lays the process group out as that mesh (``parallel/mesh.py``),
so ``model_parallel: 2`` on a world of one raises the JAX mesh's
assertion, and ``multi_host: true`` without a launcher's environment raises
(``init_distributed``); the JAX teacher's ``ValueError`` comes first where
the dilation cycle is not 1 (``device.check_tp_dilation``). Without a
process group the teacher builds the one-process model. ``model_parallel:
1`` and ``multi_host: false`` build as before.
"""

import jax
import jax.numpy as jnp
import pytest

from prodiff_tpu.models.prodiff import ProDiffTeacher as JaxTeacher
from prodiff_tpu.parallel.mesh import create_mesh
from prodiff_tpu.training.trainer import Trainer as JaxTrainer
from prodiff_tpu_torch.device import check_tp_dilation
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.parallel.mesh import LAUNCHER_ENV
from prodiff_tpu_torch.training.trainer import Trainer

HP = {"audio_num_mel_bins": 16, "hidden_size": 32, "enc_layers": 1, "enc_ffn_kernel_size": 3,
      "num_heads": 2, "dropout": 0.0, "num_spk": 2, "languages": {"zh": 1},
      "use_voicing_embed": False, "use_breath_embed": False, "residual_layers": 2,
      "residual_channels": 32, "dilation_cycle_length": 1, "timesteps": 4,
      "schedule_type": "vpsde", "max_beta": 40, "timescale": 1000, "diff_type": "prodiff"}


def _jax_teacher_init(hp):
    model = JaxTeacher(vocab_size=8, hparams=hp)
    tokens = jnp.ones((1, 4), jnp.int32)
    mel2ph = jnp.ones((1, 6), jnp.int32)
    return model.init({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1)},
                      tokens, mel2ph, jnp.full((1, 6), 220.0), lang_seq=jnp.ones((1, 4), jnp.int32),
                      spk_embed_id=jnp.zeros((1,), jnp.int32), infer=True)


def test_model_parallel_on_one_device_is_refused(tmp_path, monkeypatch):
    """``model_parallel: 2`` at dilation cycle 1 on a world of one: the JAX
    mesh asserts that one device does not divide it, and the port's trainer
    raises the same assertion; the teacher without a process group builds
    the one-process model."""
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(AssertionError) as jax_err:
        create_mesh(n_devices=1, model_parallel=2)
    hp = dict(HP, model_parallel=2, work_dir=str(tmp_path))
    with pytest.raises(AssertionError) as err:
        Trainer(hp, device="cpu")
    assert str(err.value) == str(jax_err.value) == "1 devices not divisible by model_parallel=2"
    shapes = {n: tuple(p.shape) for n, p in ProDiffTeacher(8, hp).named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in
                      ProDiffTeacher(8, dict(hp, model_parallel=1)).named_parameters()}


def test_model_parallel_with_a_dilation_cycle_raises_the_jax_error(tmp_path):
    """``model_parallel: 2`` with the pitch predictor's dilation cycle 5: the
    JAX teacher's ``ValueError``, word for word, from the port's trainer and
    teacher."""
    hp = dict(HP, model_parallel=2, dilation_cycle_length=5, work_dir=str(tmp_path))
    with pytest.raises(ValueError) as jax_err:
        _jax_teacher_init(hp)
    assert "requires dilation_cycle_length == 1 (got 5)" in str(jax_err.value)
    for build in (lambda: Trainer(hp, device="cpu"), lambda: ProDiffTeacher(8, hp),
                  lambda: check_tp_dilation(hp)):
        with pytest.raises(ValueError) as err:
            build()
        assert str(err.value) == str(jax_err.value)


def test_multi_host_is_refused(tmp_path, monkeypatch):
    """``multi_host: true`` without a launcher: the JAX trainer's
    ``jax.distributed.initialize()`` raises here (no coordinator, or a
    backend this process already started), and the port's trainer raises
    for the missing torchrun environment, as for a half-set one."""
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    hp = dict(HP, multi_host=True, work_dir=str(tmp_path))
    with pytest.raises((ValueError, RuntimeError),
                       match="coordinator_address|jax.distributed.initialize"):
        JaxTrainer(hp)
    with pytest.raises(RuntimeError, match="multi_host: true needs a launcher's environment"):
        Trainer(hp, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="half set"):
        Trainer(hp, device="cpu")


def test_one_device_keys_still_build(tmp_path):
    """``model_parallel: 1`` and ``multi_host: false`` build as without them."""
    hp = dict(HP, model_parallel=1, multi_host=False, work_dir=str(tmp_path))
    check_tp_dilation(hp)
    assert Trainer(hp, device="cpu").device.type == "cpu"
    assert sum(p.numel() for p in ProDiffTeacher(8, hp).parameters()) > 0
