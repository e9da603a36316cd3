"""Synthetic binarized-dataset generator for tests, smoke runs and dry runs
(the port's copy of ``prodiff_tpu/utils/synthetic.py``: the same items from
the same seed)."""

from __future__ import annotations

import json
import os

import numpy as np

from prodiff_tpu_torch.utils.indexed_datasets import IndexedDatasetBuilder


def small_hparams(data_dir: str, task: str = "svs", **overrides) -> dict:
    from prodiff_tpu_torch.config import load_base_config  # needs PyYAML

    hp = load_base_config()
    hp.update(
        task=task,
        work_dir=os.path.join(data_dir, "work", task),
        data_dir=data_dir,
        audio_num_mel_bins=16,
        hidden_size=32,
        enc_layers=1,
        num_heads=2,
        residual_layers=2,
        residual_channels=16,
        num_spk=2,
        languages={"zh": 1},
        use_voicing_embed=False,
        use_breath_embed=False,
        use_tension_embed=False,
        max_frames=128,
        max_tokens=512,
        max_sentences=8,
        length_bucket_step=32,
        batch_size_buckets=[1, 2, 4, 8],
        val_check_interval=10,
        tb_log_interval=5,
        num_sanity_val_steps=0,
        warmup_updates=10,
        lr=0.05,
    )
    hp.update(overrides)
    return hp


def make_svs_dataset(
    data_dir: str,
    task: str = "svs",
    n_train: int = 12,
    n_valid: int = 4,
    n_mels: int = 16,
    seed: int = 0,
    rectified: bool = False,
    hidden: int = 32,
    structured: bool = False,
    t_ph_range=(4, 8),
    dur_range=(2, 10),
):
    """Write phone_set/spk_map/lang_map + indexed shards + lengths sidecars.

    ``structured=True`` makes mels a deterministic function of the phoneme id
    (plus small noise), so training losses must actually decrease — used by
    learnability tests."""
    rng = np.random.default_rng(seed)
    ph_proto = rng.normal(size=(16, n_mels)) * 2 - 6  # per-phoneme mel prototype
    task_dir = os.path.join(data_dir, task)
    os.makedirs(task_dir, exist_ok=True)
    ph_map = {f"{p}/zh": p for p in ["SP", "AP", "a", "b", "c"]}
    with open(os.path.join(task_dir, "phone_set.json"), "w") as f:
        json.dump(ph_map, f)
    with open(os.path.join(task_dir, "spk_map.json"), "w") as f:
        json.dump({"spk0": 0, "spk1": 1}, f)
    with open(os.path.join(task_dir, "lang_map.json"), "w") as f:
        json.dump({"zh": 1}, f)

    for prefix, n in [("train", n_train), ("valid", n_valid), ("test", n_valid)]:
        builder = IndexedDatasetBuilder(task_dir, prefix, segment_size=1024)
        lengths = []
        f0s = []
        item_lengths = {}
        for i in range(n):
            t_ph = int(rng.integers(*t_ph_range))
            dur = rng.integers(*dur_range, t_ph)
            t_mel = int(dur.sum())
            mel2ph = np.repeat(np.arange(1, t_ph + 1), dur)
            f0 = rng.uniform(100, 500, t_mel).astype(np.float32)
            ph_seq = rng.integers(3, 8, t_ph).astype(np.int64)
            if structured:
                mel_arr = ph_proto[ph_seq[mel2ph - 1]] + rng.normal(
                    size=(t_mel, n_mels)
                ) * 0.1
            else:
                mel_arr = rng.normal(size=(t_mel, n_mels)) * 2 - 6
            item = {
                "ph_seq": ph_seq,
                "mel2ph": mel2ph.astype(np.int64),
                "f0": f0,
                "mel": mel_arr.astype(np.float32),
                "spk_id": int(rng.integers(0, 2)),
                "lang_seq": np.ones(t_ph, np.int64),
            }
            if rectified:
                item["condition"] = rng.normal(size=(t_mel, hidden)).astype(np.float32)
                item["x_T"] = rng.normal(size=(t_mel, n_mels)).astype(np.float32)
                item["x_0"] = (rng.normal(size=(t_mel, n_mels)) - 6).astype(np.float32)
            builder.add_item(item)
            lengths.append(t_mel)
            f0s.append(f0)
            for k, v in item.items():
                arr = np.asarray(v)
                if arr.ndim >= 1:
                    item_lengths.setdefault(k, []).append(arr.shape[0])
        builder.finalize()
        np.save(os.path.join(task_dir, f"{prefix}_lengths.npy"), np.asarray(lengths))
        np.savez(
            os.path.join(task_dir, f"{prefix}_item_lengths.npz"),
            **{k: np.asarray(v, np.int64) for k, v in item_lengths.items()},
        )
        allf0 = np.concatenate(f0s)
        np.save(
            os.path.join(task_dir, f"{prefix}_f0s_mean_std.npy"),
            np.asarray([allf0.mean(), allf0.std()]),
        )
    return task_dir
