"""f32 vs the bf16 compute policy over 250 training steps, in the PyTorch port
(the port of ``tests/test_bf16_convergence.py``).

The port trains ``svs`` on structured synthetic data (``utils/synthetic.py``)
twice, ``bf16: false`` and ``bf16: true``, with identical batches and
per-step draws (the trainer seeds each step from (seed, step)), and holds
the two loss curves together with the JAX test's bounds: each 25-step
window's mean within 8%, the last 50 steps' mean within 5%, and both
curves below 0.6 of the first ten steps' mean at the end. On the CPU (this
test) the teacher runs the plain module loop in each dtype; ``chip_smoke.py``
runs the same check on the card, where the bf16 WaveNet trains through
K5's bf16 kernels.
"""

import json
import os

import numpy as np
import pytest

from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.training.trainer import Trainer
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams

N_STEPS = 250


def loss_curve(work_dir):
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    tr = {r["step"]: r["tr/total_loss"] for r in recs if "tr/total_loss" in r}
    steps = sorted(tr)
    return np.asarray(steps), np.asarray([tr[s] for s in steps])


def convergence_curves(root: str, device: str, **overrides) -> dict:
    """The f32 and bf16 loss curves of N_STEPS ``svs`` steps each on
    ``device``, the JAX test's data and hparams (plus ``overrides``)."""
    data_dir = os.path.join(root, "data")
    make_svs_dataset(data_dir, "svs", n_train=24, structured=True, seed=5)
    base = small_hparams(data_dir, "svs", max_updates=N_STEPS, val_check_interval=10 ** 6,
                         num_sanity_val_steps=0, tb_log_interval=1, num_ckpt_keep=1,
                         **overrides)
    curves = {}
    for name, force in (("f32", False), ("bf16", True)):
        hp = dict(base, bf16=force, work_dir=os.path.join(root, "work_" + name))
        trainer = Trainer(hp, device=device)
        trainer.fit(get_task_cls("svs")(hp), max_steps=N_STEPS)
        assert trainer.global_step == N_STEPS
        _, losses = loss_curve(hp["work_dir"])
        assert len(losses) == N_STEPS and np.isfinite(losses).all()
        curves[name] = losses
    return curves


def check_curves(curves: dict) -> dict:
    """The JAX test's bounds; returns the measured ratios."""
    f32, b16 = curves["f32"], curves["bf16"]
    head = f32[:10].mean()
    assert f32[-50:].mean() < 0.6 * head, (f32[-50:].mean(), head)
    assert b16[-50:].mean() < 0.6 * head, (b16[-50:].mean(), head)
    windows = []
    for lo in range(0, N_STEPS, 25):
        wf, wb = f32[lo:lo + 25].mean(), b16[lo:lo + 25].mean()
        windows.append(abs(wb - wf) / wf)
        assert windows[-1] < 0.08, (lo, wf, wb)
    tf, tb = f32[-50:].mean(), b16[-50:].mean()
    assert abs(tb - tf) / tf < 0.05, (tf, tb)
    return {"worst_window": max(windows), "tail": abs(tb - tf) / tf,
            "tail_f32": tf, "tail_bf16": tb, "head": head}


@pytest.mark.slow
def test_bf16_training_convergence_matches_f32(tmp_path):
    check_curves(convergence_curves(str(tmp_path), "cpu"))
