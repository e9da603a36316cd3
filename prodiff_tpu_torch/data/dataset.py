"""Datasets over binarized shards and the batch iterator (port of
``prodiff_tpu/data/dataset.py``).

``BaseDataset`` mirrors the reference (``component/train_task/base_dataset.py``):
IndexedDataset-backed, ``{prefix}_lengths.npy`` sizes, ``max_frames``
clamp, shuffled-then-mergesorted ordering. ``BatchIterator`` batches by
token budget, collates to numpy, pads to quantised (B, T) buckets and
collates ahead on a background thread. The seeded shuffle draws from
``numpy.random.default_rng(seed)`` in the JAX package's order, so both
packages give the same batches for the same seed.

Per-process loading (``BatchIterator(local_block=(lo, hi, n_blocks))``):
a data-parallel rank collates only its rows of each global batch, padded to
the global batch's shapes (time lengths from the ``{prefix}_item_lengths.npz``
sidecar the binarizers write), so the mean losses of equal-shaped rank
batches average to the global batch's.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from prodiff_tpu_torch.data.collate import (
    batch_by_size,
    bucket_batch_size,
    pad_to_buckets,
    pad_to_shape,
    round_up,
)
from prodiff_tpu_torch.utils.indexed_datasets import IndexedDataset


class BaseDataset:
    # static-shape metadata, overridden per task
    time_keys: Dict[str, int] = {}
    pad_values: Dict[str, float] = {}
    # batch keys made in the collater whose length follows another item key
    # (pitch_retake follows mel2note): read by local collation
    length_source: Dict[str, str] = {}

    def __init__(self, prefix: str, shuffle: bool, hparams: dict):
        self.hparams = hparams
        self.shuffle = shuffle
        self.sort_by_len = hparams.get("sort_by_len", True)
        self.data_dir = os.path.join(hparams["data_dir"], hparams["task"])
        self.prefix = prefix
        self.sizes = np.load(f"{self.data_dir}/{self.prefix}_lengths.npy")
        # each key's length per item (binarize time): a rank pads its rows to
        # the global batch's shapes without loading the other ranks' items
        il_path = f"{self.data_dir}/{self.prefix}_item_lengths.npz"
        self.item_lengths: Optional[Dict[str, np.ndarray]] = None
        if os.path.exists(il_path):
            with np.load(il_path) as z:
                self.item_lengths = {k: z[k] for k in z.files}
        self.indexed_ds: Optional[IndexedDataset] = None
        self._rng = np.random.default_rng(hparams.get("seed", 1234))

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, index: int) -> dict:
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(
                self.data_dir, self.prefix,
                segment_size=self.hparams.get("idx_ds_segment_size", 1024),
            )
        return self.indexed_ds[index]

    def size(self, index: int) -> int:
        return int(min(self.sizes[index], self.hparams["max_frames"]))

    def num_tokens(self, index: int) -> int:
        return self.size(index)

    def ordered_indices(self) -> np.ndarray:
        if self.shuffle:
            indices = self._rng.permutation(len(self))
            if self.sort_by_len:
                indices = indices[np.argsort(np.asarray(self.sizes)[indices], kind="mergesort")]
        else:
            indices = np.arange(len(self))
        return indices

    def collater(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def pad_batch(self, batch: Dict[str, np.ndarray], batch_multiple: int = 1) -> Dict[str, np.ndarray]:
        return pad_to_buckets(
            batch,
            time_keys=self.time_keys,
            batch_buckets=self.hparams.get("batch_size_buckets", [1, 2, 4, 8, 16, 32, 48]),
            length_bucket_step=self.hparams.get("length_bucket_step", 128),
            pad_values=self.pad_values,
            batch_multiple=batch_multiple,
        )


class BatchIterator:
    """Token-bucketed, bucket-padded batch stream, collated ahead on a
    thread. Leaving the loop early stops and joins that thread.

    ``local_block=(lo, hi, n_blocks)``: this process collates only the rows
    of data blocks ``[lo, hi)`` of each global batch (``_local_batch``);
    its batches carry ``_local_rows=(row0, global_B)``."""

    def __init__(self, dataset: BaseDataset, max_tokens: int, max_sentences: int,
                 required_batch_size_multiple: int = 1, prefetch: int = 4,
                 local_block: Optional[Tuple[int, int, int]] = None):
        self.dataset = dataset
        self.max_tokens = max_tokens if max_tokens and max_tokens > 0 else None
        self.max_sentences = max_sentences if max_sentences and max_sentences > 0 else None
        self.bsz_mult = required_batch_size_multiple
        self.prefetch = prefetch
        self.local_block = local_block
        if local_block is not None and dataset.item_lengths is None:
            raise ValueError(
                "multi-host per-process loading needs the "
                f"{dataset.prefix}_item_lengths.npz sidecar (re-binarize with "
                "this version, or pass local_block=None to fall back to "
                "global loading)"
            )

    def _make_batches(self) -> List[List[int]]:
        return batch_by_size(
            self.dataset.ordered_indices(), self.dataset.num_tokens,
            max_tokens=self.max_tokens, max_sentences=self.max_sentences,
            required_batch_size_multiple=self.bsz_mult,
        )

    def __len__(self) -> int:
        return len(self._make_batches())

    def _produce(self, batches: Sequence[Sequence[int]], q: "queue.Queue",
                 stop: threading.Event):
        try:
            for idxs in batches:
                if stop.is_set():
                    return
                if self.local_block is not None:
                    q.put(self._local_batch(list(idxs)))
                    continue
                batch = self.dataset.collater([self.dataset[i] for i in idxs])
                q.put(self.dataset.pad_batch(batch, batch_multiple=self.bsz_mult))
        except Exception as e:  # surface loader errors on the consumer side
            q.put(e)
        finally:
            q.put(None)

    def _local_batch(self, idxs: List[int]) -> Dict[str, np.ndarray]:
        """This process's rows of the global batch ``idxs``, padded to the
        global batch's shapes: what ``pad_batch`` of the whole batch holds in
        those rows. A process whose rows are all padding gets typed empty
        rows padded to its share."""
        ds = self.dataset
        hp = ds.hparams
        buckets = hp.get("batch_size_buckets", [1, 2, 4, 8, 16, 32, 48])
        step = hp.get("length_bucket_step", 128)
        lo, hi, n_blocks = self.local_block
        b = len(idxs)
        b_pad = round_up(bucket_batch_size(b, buckets), self.bsz_mult)
        if b_pad % n_blocks:
            raise ValueError(f"a padded batch of {b_pad} rows does not split into "
                             f"{n_blocks} data blocks")
        row0, row1 = lo * b_pad // n_blocks, hi * b_pad // n_blocks
        local_idx = idxs[row0:min(row1, b)]
        # all padding: collate one item for the dtypes and keep none of its rows
        batch = ds.collater([ds[i] for i in (local_idx or idxs[:1])])
        if not local_idx:
            batch = {k: v[:0] if isinstance(v, np.ndarray) and v.ndim >= 1 else v
                     for k, v in batch.items()}
        t_targets: Dict[str, int] = {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray) or (v.ndim < 2 and k not in ds.time_keys):
                continue
            src = ds.length_source.get(k, k)
            lens = ds.item_lengths.get(src)
            if lens is None:
                raise ValueError(
                    f"no index-level length for batch key {k!r} (item key "
                    f"{src!r}); add it to the binarizer output or map it via "
                    "length_source"
                )
            t = int(lens[np.asarray(idxs)].max())
            t_targets[k] = round_up(max(t, 1), step) if k in ds.time_keys else t
        out = pad_to_shape(batch, time_keys={k: ds.time_keys.get(k, 1) for k in t_targets},
                           t_targets=t_targets, b_target=row1 - row0, pad_values=ds.pad_values)
        out["nsamples"] = b  # the global batch's items (validation weights)
        out["_local_rows"] = (row0, b_pad)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._make_batches()
        if self.dataset.shuffle:
            # shuffle batch order (sizes stay grouped within batches)
            order = self.dataset._rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        thread = threading.Thread(target=self._produce, args=(batches, q, stop), daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():
                drain(q)
                thread.join(timeout=0.05)


def drain(q: "queue.Queue") -> None:
    """Take every item that is in ``q`` now."""
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
