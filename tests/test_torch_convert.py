"""Weights carried between the JAX package and the PyTorch port, on the CPU.

The port keeps the torch reference's state-dict names, so the JAX package's
own converters (``convert_prodiff_teacher``, ``convert_nsf_hifigan``) turn a
port ``state_dict()`` back into flax params: the round trip must be exact.
The port's flax-msgpack reader is held against ``ckpt_utils``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from prodiff_tpu.utils import ckpt_utils
from prodiff_tpu.utils.teacher_convert import convert_prodiff_teacher
from prodiff_tpu.utils.torch_convert import convert_nsf_hifigan
from prodiff_tpu_torch.models.nsf_hifigan import Generator
from prodiff_tpu_torch.models.prodiff import ProDiffTeacher
from prodiff_tpu_torch.utils.convert import (
    load_flax_checkpoint,
    load_torch_state_dict,
    nsf_hifigan_state_dict,
    teacher_state_dict,
)
from tests.test_torch_modules import TEACHER_HP, teacher_pair
from tests.test_torch_vocoder import VOCODER_H, generator_pair


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_teacher_weights_round_trip():
    """JAX params -> port state dict -> port module -> ``convert_prodiff_teacher``."""
    _, params, model, _ = teacher_pair()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert_trees_equal(convert_prodiff_teacher(sd, TEACHER_HP), jax.device_get(params))
    fresh = ProDiffTeacher(12, TEACHER_HP)  # every carried name is a real parameter
    fresh.load_state_dict(teacher_state_dict(params, TEACHER_HP), strict=True)


def test_nsf_hifigan_weights_round_trip(tmp_path):
    """JAX params -> port Generator -> ``torch.save`` -> ``convert_nsf_hifigan``,
    and the port's own loader reads the same file back."""
    _, params, gen, *_ = generator_pair()
    path = str(tmp_path / "model")
    torch.save({"generator": gen.state_dict()}, path)
    from prodiff_tpu.utils.torch_convert import load_torch_state_dict as jax_side_load

    assert_trees_equal(convert_nsf_hifigan(jax_side_load(path), VOCODER_H), jax.device_get(params))
    loaded = load_torch_state_dict(path)
    for k, v in gen.state_dict().items():
        assert torch.equal(loaded[k], v), k
    assert_trees_equal(
        {k: v.numpy() for k, v in nsf_hifigan_state_dict(params, VOCODER_H).items()},
        {k: v.numpy() for k, v in gen.state_dict().items()},
    )


def test_weight_norm_is_folded(tmp_path):
    """A reference checkpoint keeps weight norm (``weight_g``/``weight_v``)."""
    gen = Generator.from_config(VOCODER_H)
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 3, 5))
    sd = {f"conv_pre.{k}": v.detach() for k, v in conv.state_dict().items()}
    path = str(tmp_path / "wn")
    torch.save({"generator": sd}, path)
    folded = load_torch_state_dict(path)
    assert set(folded) == {"conv_pre.weight", "conv_pre.bias"}
    torch.testing.assert_close(folded["conv_pre.weight"], conv.weight.detach(), rtol=1e-6, atol=1e-7)
    assert gen.conv_pre.weight.ndim == 3


@pytest.mark.parametrize("chunked", [False, True])
def test_flax_checkpoint_reader_matches_ckpt_utils(tmp_path, monkeypatch, chunked):
    """Nested params, ints, floats, numpy scalars, bf16 and int
    arrays; ``chunked`` shrinks flax's chunk limit so large leaves are split."""
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(0)
    payload = {
        "global_step": 7,
        "epoch": 0,
        "checkpoint_callback_best": 1.5,
        "state_dict": {"params": {
            "a": {"kernel": rng.normal(size=(3, 40, 5)).astype(np.float32)},
            "ids": np.arange(10, dtype=np.int32),
            "half": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
            "scale": np.float32(0.25),
        }},
    }
    path = ckpt_utils.save_checkpoint(str(tmp_path), 7, payload)
    want = ckpt_utils.load_checkpoint_file(path)
    got = load_flax_checkpoint(path)
    want["state_dict"]["params"]["half"] = np.asarray(
        want["state_dict"]["params"]["half"], np.float32)
    assert_trees_equal(got, want)
    assert got["state_dict"]["params"]["a"]["kernel"].dtype == np.float32
