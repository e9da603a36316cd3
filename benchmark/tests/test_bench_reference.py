"""The plain reference against the port at tiny sizes on the CPU, through
the drivers' own checks; and a run with the timed path broken underneath
comes out not correct, once for each fault a cell can have."""

import bench_tiny
import numpy as np
import pytest
import torch

import harness

FAULTS = [(mix, f) for mix, driver in (("song", "render"), ("train", "train"))
          for f in harness.driver_module(driver).FAULTS]


def checked(mix_name, reflow=False, seed=5):
    d = bench_tiny.driver(mix_name, seed=seed, reflow=reflow)
    d.setup()
    d.window(0.5)
    d.release()
    return d, d.check()


@pytest.mark.parametrize("reflow", [False, True])
def test_render_matches_the_port(reflow):
    d, checks = checked("song", reflow)
    assert checks["batching"]["value"] == 0.0
    assert checks["mel_gap"]["value"] < 1e-5 and checks["wav_gap"]["value"] < 1e-5
    assert d.record["audio_s"] > 0 and d.attempted() > 0


def test_training_steps_match_the_port():
    d, checks = checked("train")
    assert checks["batch_gap"]["value"] == 0.0
    assert checks["loss_gap"]["value"] < 1e-6
    assert checks["grad_gap"]["value"] < 1e-5
    assert checks["update_gap"]["value"] < 1e-3
    assert d.record["steps"] > 0


def run_broken(monkeypatch, tmp_path, mix_name):
    """``harness.run_cell`` on the CPU at the tiny size (the look for a chip
    is the command's, which this skips)."""
    bench = harness.load_benchmark(bench_tiny.ROOT)
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": mix_name,
                               "chips": 1})
    monkeypatch.setattr(harness, "load_cell", lambda b, name: (
        b["workloads"][-1], bench_tiny.config(), bench_tiny.mix(mix_name), bench_tiny.LIMITS))
    return harness.run_cell(bench, "tiny.cell", 2 ** 31 + 17, 0.5, False, [torch.device("cpu")],
                            0.0)


def test_sound_run_is_correct(monkeypatch, tmp_path):
    assert run_broken(monkeypatch, tmp_path, "song")["correct"] is True


@pytest.mark.parametrize("mix_name, fault", FAULTS, ids=[f.__name__ for _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, tmp_path, mix_name, fault):
    with fault():
        result = run_broken(monkeypatch, tmp_path, mix_name)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert np.isfinite(result["attempted"])
