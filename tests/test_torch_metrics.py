"""MCD, the timers and the dB helpers of the PyTorch port vs the JAX package,
on the CPU: ``ops/metrics.py`` (``_dct_matrix``, ``mel_to_cepstra``,
``mel_cepstral_distortion``), ``utils/profiling.py`` (``Timer``, ``rtf``) and
``utils/audio.py`` (``amp_to_db``, ``db_to_amp``). Inputs are made with numpy
from a seed. Tolerances: the DCT basis, ``rtf`` and the dB helpers exactly
(the same float64 numpy code); cepstra and MCD 1e-5 relative (float32
products of another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prodiff_tpu.ops import metrics as jax_metrics
from prodiff_tpu.utils import profiling as jax_profiling
from prodiff_tpu.utils.audio import amp_to_db as jax_amp_to_db
from prodiff_tpu.utils.audio import db_to_amp as jax_db_to_amp
from prodiff_tpu_torch.ops import metrics
from prodiff_tpu_torch.utils import profiling
from prodiff_tpu_torch.utils.audio import amp_to_db, db_to_amp


def _mels(seed, t=50, m=80):
    rng = np.random.default_rng(seed)
    a = rng.normal(-4, 1, (t, m)).astype(np.float32)
    return a, (a + 0.3 * rng.normal(size=(t, m))).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", [(80, 13), (128, 20), (16, 16)])
def test_dct_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(metrics._dct_matrix(n_in, n_out),
                                  jax_metrics._dct_matrix(n_in, n_out))


def test_mel_to_cepstra_matches_jax():
    a, _ = _mels(0)
    got = metrics.mel_to_cepstra(torch.from_numpy(a), 13).numpy()
    want = np.asarray(jax_metrics.mel_to_cepstra(jnp.asarray(a), 13))
    assert got.shape == want.shape == (50, 13)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_mfcc,exclude_c0", [(13, True), (13, False), (24, True)])
def test_mcd_matches_jax(n_mfcc, exclude_c0):
    """MCD in dB of a log10-mel against a perturbed copy; 0 against itself."""
    a, b = _mels(1, m=128)
    got = float(metrics.mel_cepstral_distortion(torch.from_numpy(a), torch.from_numpy(b),
                                                n_mfcc, exclude_c0))
    want = float(jax_metrics.mel_cepstral_distortion(jnp.asarray(a), jnp.asarray(b), n_mfcc,
                                                     exclude_c0))
    assert got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(metrics.mel_cepstral_distortion(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_rtf_matches_jax():
    for args in ((1.5, 44100 * 3, 44100), (0.02, 131072, 22050)):
        assert profiling.rtf(*args) == jax_profiling.rtf(*args)


def test_timer_accumulates_as_jax(capsys):
    """Totals and counts by name, ``report``, ``reset``; the line printed with
    ``enable``; a CPU device needs no synchronisation."""
    profiling.Timer.reset()
    jax_profiling.Timer.reset()
    for mod in (profiling, jax_profiling):
        for i in range(3):
            with mod.Timer("spec2wav", enable=(i == 2)):
                pass
        with mod.Timer("mel"):
            pass
        assert dict(mod.Timer.counts) == {"spec2wav": 3, "mel": 1}
        assert set(mod.Timer.report()) == {"spec2wav", "mel"}
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(line.startswith("| spec2wav: ") for line in out)
    with profiling.Timer("on_cpu", device=torch.device("cpu")) as t:
        x = torch.ones(8).sum()
    assert t.device.type == "cpu" and float(x) == 8.0
    assert profiling.Timer.counts["on_cpu"] == 1
    profiling.Timer.reset()
    jax_profiling.Timer.reset()
    assert profiling.Timer.report() == {} == jax_profiling.Timer.report()


def test_timer_synchronises_its_card(monkeypatch):
    """Given a CUDA device, the timer synchronises that device at both ends
    (no card needed: the call is recorded)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    with profiling.Timer("render", device="cuda:0"):
        calls.append("body")
    assert calls == [torch.device("cuda:0"), "body", torch.device("cuda:0")]
    profiling.Timer.reset()


def test_db_helpers_match_jax():
    """``amp_to_db`` (floored at 1e-5) and ``db_to_amp``, exactly."""
    x = np.concatenate([np.random.default_rng(2).uniform(0, 2, 100), [0.0, 1e-6, 1.0]])
    np.testing.assert_array_equal(amp_to_db(x), jax_amp_to_db(x))
    db = np.linspace(-120, 20, 57)
    np.testing.assert_array_equal(db_to_amp(db), jax_db_to_amp(db))
