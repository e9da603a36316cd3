"""The port's copies of the JAX package's small public helpers, each against
its JAX function on the inputs of the JAX package's own tests
(``tests/test_seq_ops.py``, ``tests/test_foundations.py``):
``ops/seq.py:length_regulator``, ``config.py:apply_overrides`` and
``set_hparams(overrides=)``, and ``utils/text_encoder.py:TokenTextEncoder``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prodiff_tpu.config import apply_overrides as jax_apply_overrides
from prodiff_tpu.config import set_hparams as jax_set_hparams
from prodiff_tpu.ops.seq import length_regulator as jax_length_regulator
from prodiff_tpu.utils.text_encoder import TokenTextEncoder as JaxTokenTextEncoder
from prodiff_tpu_torch.config import apply_overrides, set_hparams
from prodiff_tpu_torch.ops.seq import length_regulator, mel2ph_to_dur
from prodiff_tpu_torch.utils.text_encoder import TokenTextEncoder


@pytest.mark.parametrize("alpha", [1.0, 1.5, 0.5])
def test_length_regulator_matches_jax(rng, alpha):
    """``tests/test_seq_ops.py``'s durations (a padding token last), at the
    JAX test's 30 frames and at the durations' own total, and rescaled."""
    dur = rng.integers(0, 5, size=(3, 7))
    dur[:, -1] = 0
    for max_frames in (30, int(dur.sum(1).max())):
        want = np.asarray(jax_length_regulator(jnp.asarray(dur), max_frames, alpha))
        got = length_regulator(torch.from_numpy(dur), max_frames, alpha)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_length_regulator_inverts_mel2ph_to_dur(rng):
    dur = rng.integers(0, 6, size=(4, 9))
    mel2ph = length_regulator(torch.from_numpy(dur), int(dur.sum(1).max()))
    np.testing.assert_array_equal(mel2ph_to_dur(mel2ph, 9).numpy(), dur)


@pytest.mark.parametrize("overrides", ["a=5,b.c=7,b.d=true", " a = , e.f.g=1.5e-3, ,h=x",
                                       ""])
def test_apply_overrides_matches_jax(overrides):
    want = jax_apply_overrides({"a": 1, "b": {"c": 2}}, overrides)
    assert apply_overrides({"a": 1, "b": {"c": 2}}, overrides) == want
    if overrides.startswith("a=5"):
        assert want == {"a": 5, "b": {"c": 7, "d": True}}


def test_set_hparams_overrides_match_jax(tmp_path):
    """``set_hparams(..., overrides=)`` on a config with a parent, as the
    JAX package's: the overrides land before task and work_dir are stamped,
    and the work dir's ``config.yaml`` holds them."""
    base = tmp_path / "base.yaml"
    base.write_text(yaml.dump({"lr": 0.1, "audio": {"sr": 22050}, "hidden_size": 8}))
    cfg = tmp_path / "exp.yaml"
    cfg.write_text(yaml.dump({"base_config": str(base), "hidden_size": 16}))
    overrides = "lr=0.5,audio.sr=44100,new.key=null"
    want = jax_set_hparams(str(cfg), exp_name="e", task="svs", global_hparams=False,
                           overrides=overrides, checkpoints_root=str(tmp_path / "jax"))
    got = set_hparams("e", "svs", str(tmp_path / "port"), str(cfg), make_work_dir=True,
                      overrides=overrides)
    for hp, root in ((want, "jax"), (got, "port")):
        assert hp.pop("work_dir") == os.path.join(str(tmp_path / root), "e", "svs")
    assert got == want
    assert got["lr"] == 0.5 and got["audio"] == {"sr": 44100} and got["new"] == {"key": None}
    with open(tmp_path / "port" / "e" / "svs" / "config.yaml") as f:
        assert yaml.safe_load(f)["audio"] == {"sr": 44100}
    with pytest.raises(TypeError):
        set_hparams("e", "svs", str(tmp_path / "port"), str(cfg), False, "lr=1")


def test_text_encoder_matches_jax(tmp_path):
    """``tests/test_foundations.py``'s round trip, and the members the JAX
    encoder has: ``vocab_size``, ``contains``, ``token``, ``store_to_file``
    and ``decode(strip_padding=)``."""
    jax_enc = JaxTokenTextEncoder(["SP", "a", "b"], replace_oov="SP")
    enc = TokenTextEncoder(["SP", "a", "b"], replace_oov="SP")
    assert enc.vocab_size == len(enc) == jax_enc.vocab_size
    for tok in ("SP", "a", "zz", "<pad>", "<UNK>"):
        assert enc.contains(tok) == jax_enc.contains(tok)
    for s in ("a b SP", "a zz"):
        assert enc.encode(s) == jax_enc.encode(s)
    ids = [0, enc.id("a"), 0, enc.id("b")]
    for strip in (False, True):
        assert enc.decode(ids, strip_padding=strip) == jax_enc.decode(ids, strip_padding=strip)
    assert [enc.token(i) for i in range(enc.vocab_size)] == \
        [jax_enc.token(i) for i in range(jax_enc.vocab_size)]
    enc.store_to_file(str(tmp_path / "port.txt"))
    jax_enc.store_to_file(str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert enc.encode("a b SP") == [4, 5, 3] and enc.encode("a zz") == [4, 3]
    assert enc.decode([0, 4, 5], strip_padding=True) == "a b"
