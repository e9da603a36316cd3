"""Per-process loading of the port (``BatchIterator(local_block=...)``) vs
the JAX package's, on the CPU, as ``tests/test_local_collation.py`` holds
the JAX one: a process collates only its rows of each global batch, padded
to the global batch's shapes, and loads only its own items."""

import os

import numpy as np
import pytest

from prodiff_tpu.tasks import get_task_cls as jax_task_cls
from prodiff_tpu_torch.tasks import get_task_cls
from prodiff_tpu_torch.utils.synthetic import make_svs_dataset, small_hparams


class _CountingDataset:
    """A dataset that records the item indices loaded."""

    def __init__(self, ds):
        self._ds = ds
        self.loaded = []

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, i):
        self.loaded.append(int(i))
        return self._ds[i]


@pytest.fixture(scope="module")
def svs_data(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("torch_lc_data"))
    make_svs_dataset(data_dir, "svs", n_train=16, n_valid=6)
    return data_dir


def _iter_with_block(task, n_devices, local_block):
    it = task.train_iterator(n_devices, local_block=local_block)
    counting = _CountingDataset(it.dataset)
    it.dataset = counting
    return list(it), counting.loaded


def test_local_shards_reassemble_global_batch_and_match_jax(svs_data):
    """Two processes of two data blocks each: their rows concatenate to the
    global batch, each loads only its own items, and each process's arrays
    equal the JAX ``_local_batch``'s for the same blocks."""
    hp = small_hparams(svs_data, "svs", max_tokens=100000, max_sentences=8)
    task = get_task_cls("svs")(hp)
    jtask = jax_task_cls("svs")(dict(hp))
    n_dev = 4
    global_batches, all_loaded = _iter_with_block(task, n_dev, None)
    parts, loads = [], []
    for lo, hi in [(0, 2), (2, 4)]:
        batches, loaded = _iter_with_block(task, n_dev, (lo, hi, n_dev))
        jax_batches = list(jtask.train_iterator(n_dev, local_block=(lo, hi, n_dev)))
        assert len(batches) == len(jax_batches)
        for b, jb in zip(batches, jax_batches):
            assert b["_local_rows"] == jb["_local_rows"] and b["nsamples"] == jb["nsamples"]
            assert set(b) == set(jb)
            for k, v in jb.items():
                if isinstance(v, np.ndarray):
                    assert b[k].dtype == v.dtype, k
                    np.testing.assert_array_equal(b[k], v, err_msg=k)
        parts.append(batches)
        loads.append(set(loaded))
    assert len(parts[0]) == len(parts[1]) == len(global_batches)
    for gb, b0, b1 in zip(global_batches, parts[0], parts[1]):
        row0_a, b_pad_a = b0.pop("_local_rows")
        row0_b, b_pad_b = b1.pop("_local_rows")
        assert b_pad_a == b_pad_b and row0_a == 0 and row0_b == b_pad_a // 2
        nsamples = gb.pop("nsamples")
        assert b0.pop("nsamples") == nsamples and b1.pop("nsamples") == nsamples
        for k, gv in gb.items():
            lv = np.concatenate([b0[k], b1[k]], axis=0)
            assert lv.shape == gv.shape, (k, lv.shape, gv.shape)
            np.testing.assert_array_equal(lv, gv, err_msg=k)
    assert loads[0].isdisjoint(loads[1])
    assert loads[0] | loads[1] <= set(all_loaded)


def test_local_collation_requires_sidecar(tmp_path):
    """Without ``{prefix}_item_lengths.npz`` per-process loading raises the
    JAX package's ``ValueError``."""
    data_dir = str(tmp_path)
    make_svs_dataset(data_dir, "svs")
    os.remove(os.path.join(data_dir, "svs", "valid_item_lengths.npz"))
    hp = small_hparams(data_dir, "svs")
    with pytest.raises(ValueError, match="item_lengths") as err:
        get_task_cls("svs")(hp).val_iterator(4, local_block=(0, 2, 4))
    with pytest.raises(ValueError) as jax_err:
        jax_task_cls("svs")(dict(hp)).val_iterator(4, local_block=(0, 2, 4))
    assert str(err.value) == str(jax_err.value)


def test_local_shards_all_padding_process(svs_data):
    """A process whose rows are all padding gets typed zero rows of its
    share, as the JAX iterator gives it."""
    hp = small_hparams(svs_data, "svs", max_tokens=100000, max_sentences=3)
    task = get_task_cls("svs")(hp)
    jtask = jax_task_cls("svs")(dict(hp))
    # batches of 3 rows pad to 4; block 3 of 4 owns only padding rows
    batches, _ = _iter_with_block(task, 4, (3, 4, 4))
    jax_batches = list(jtask.train_iterator(4, local_block=(3, 4, 4)))
    assert batches and len(batches) == len(jax_batches)
    padding_only = 0
    for b, jb in zip(batches, jax_batches):
        row0, b_pad = b.pop("_local_rows")
        if row0 >= b.pop("nsamples"):
            padding_only += 1
            assert (b["mel"] == 0).all() and not b["mel2ph"].any()
        assert b["mel"].shape[0] == b_pad // 4
        for k, v in b.items():
            assert v.dtype == jb[k].dtype and v.shape == jb[k].shape, k
    assert padding_only
