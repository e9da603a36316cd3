"""Sharded, random-access binary item store (the port's copy of
``prodiff_tpu/utils/indexed_datasets.py``).

Byte-format-compatible with the reference's ``IndexedDataset`` /
``IndexedDatasetBuilder`` (``utils/indexed_datasets.py:7-94``): items are
pickled back-to-back into ``{prefix}_{shard}.data`` files, with a companion
``{prefix}_{shard}.idx`` holding the byte-offset list as a 0-d object ``.npy``
(``np.save`` of ``{'offsets': [...]}``), at ``segment_size`` items per shard.
Binarized data therefore moves between the reference, the JAX package and
the port in any direction.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, prefix: str, num_cache: int = 1, segment_size: int = 1024):
        self.path = path
        self.prefix = prefix
        self.segment_size = segment_size
        segment_count = len(
            [f for f in os.listdir(path) if f.startswith(prefix) and f.endswith(".idx")]
        )
        if segment_count == 0:
            raise FileNotFoundError(f"No index shards found at {path}/{prefix}_*.idx")
        self.data_offsets = [
            np.load(os.path.join(path, f"{prefix}_{i}.idx"), allow_pickle=True).item()["offsets"]
            for i in range(segment_count)
        ]
        self.data_paths = [
            os.path.join(path, f"{prefix}_{i}.data") for i in range(segment_count)
        ]
        self._files = [None] * segment_count
        self.total_size = sum(len(offsets) - 1 for offsets in self.data_offsets)
        self._cache_idx = -1
        self._cache_item: Any = None

    def _file(self, seg: int):
        if self._files[seg] is None:
            self._files[seg] = open(self.data_paths[seg], "rb", buffering=-1)
        return self._files[seg]

    def __len__(self) -> int:
        return self.total_size

    def __getitem__(self, i: int):
        if i < 0 or i >= self.total_size:
            raise IndexError("index out of range")
        if self._cache_idx == i:
            return self._cache_item
        seg, off = divmod(i, self.segment_size)
        offsets = self.data_offsets[seg]
        f = self._file(seg)
        f.seek(offsets[off])
        item = pickle.loads(f.read(offsets[off + 1] - offsets[off]))
        self._cache_idx, self._cache_item = i, item
        return item

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        for f in self._files:
            if f is not None:
                f.close()
        self._files = [None] * len(self._files)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IndexedDatasetBuilder:
    def __init__(self, path: str, prefix: str, segment_size: int = 1024):
        self.path = path
        self.prefix = prefix
        self.segment_size = segment_size
        self.segment_idx = 0
        self.segment_item_count = 0
        self.out_file = open(os.path.join(path, f"{prefix}_0.data"), "wb")
        self.byte_offsets: List[int] = [0]

    def add_item(self, item: Any):
        blob = pickle.dumps(item)
        n = self.out_file.write(blob)
        self.byte_offsets.append(self.byte_offsets[-1] + n)
        self.segment_item_count += 1
        if self.segment_item_count >= self.segment_size:
            self.finalize()
            self.segment_idx += 1
            self.segment_item_count = 0
            self.out_file = open(
                os.path.join(self.path, f"{self.prefix}_{self.segment_idx}.data"), "wb"
            )
            self.byte_offsets = [0]

    def finalize(self):
        self.out_file.close()
        with open(os.path.join(self.path, f"{self.prefix}_{self.segment_idx}.idx"), "wb") as f:
            np.save(f, {"offsets": self.byte_offsets})
