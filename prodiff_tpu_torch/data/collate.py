"""Numpy collation + token-bucketed batching (the port's copy of
``prodiff_tpu/data/collate.py``).

``collate_1d``/``collate_2d``/``batch_by_size`` mirror the reference
(``utils/__init__.py:124-235``). :func:`pad_to_buckets` quantises batch
shapes to a few (B, T) buckets, as the JAX package does for its compiled
programs; on the card it keeps the kernels' shapes and the allocator's
blocks to a small set.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np


def collate_1d(values: Sequence[np.ndarray], pad_value=0, max_len: int | None = None) -> np.ndarray:
    size = max(len(v) for v in values) if max_len is None else max_len
    res = np.full((len(values), size), pad_value, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        res[i, : len(v)] = v[:size]
    return res


def collate_2d(values: Sequence[np.ndarray], pad_value=0, max_len: int | None = None) -> np.ndarray:
    size = max(len(v) for v in values) if max_len is None else max_len
    res = np.full(
        (len(values), size, values[0].shape[1]), pad_value, dtype=np.asarray(values[0]).dtype
    )
    for i, v in enumerate(values):
        res[i, : len(v)] = v[:size]
    return res


def batch_by_size(
    indices: np.ndarray,
    num_tokens_fn,
    max_tokens: int | None = None,
    max_sentences: int | None = None,
    required_batch_size_multiple: int = 1,
) -> List[List[int]]:
    """Token-budget bucketing identical in behaviour to the reference
    (``utils/__init__.py:180-235``): greedy fill, close a batch when adding the
    next item would exceed ``max_tokens`` (with per-batch padding accounted as
    batch_len * max_sample_len) or ``max_sentences``."""
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple

    sample_len = 0
    sample_lens: List[int] = []
    batch: List[int] = []
    batches: List[List[int]] = []
    for idx in map(int, indices):
        num_tokens = num_tokens_fn(idx)
        sample_lens.append(num_tokens)
        sample_len = max(sample_len, num_tokens)
        assert sample_len <= max_tokens, (
            f"sentence at index {idx} of size {sample_len} exceeds max_tokens limit {max_tokens}"
        )
        num_tokens_batch = (len(batch) + 1) * sample_len
        if (
            len(batch) > 0
            and (
                len(batch) == max_sentences
                or num_tokens_batch > max_tokens
            )
        ):
            mod_len = max(
                bsz_mult * (len(batch) // bsz_mult),
                len(batch) % bsz_mult,
            )
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def bucket_batch_size(b: int, buckets: Sequence[int]) -> int:
    """Smallest configured batch-size bucket >= b (or round up to the largest)."""
    for cand in sorted(buckets):
        if cand >= b:
            return cand
    return round_up(b, max(buckets))


def pad_to_shape(
    batch: Dict[str, np.ndarray],
    time_keys: Dict[str, int],
    t_targets: Dict[str, int],
    b_target: int,
    pad_values: Dict[str, float] | None = None,
) -> Dict[str, np.ndarray]:
    """Pad a collated batch to EXPLICIT targets (multi-host local collation:
    every process must produce identical shapes, so the targets come from
    index-level metadata rather than this process's local max)."""
    pad_values = pad_values or {}
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.ndim < 1:
            out[k] = v
            continue
        pads = [(0, 0)] * v.ndim
        pads[0] = (0, b_target - v.shape[0])
        if k in time_keys:
            ax = time_keys[k]
            assert k in t_targets, f"no global length target for time key {k!r}"
            pads[ax] = (0, t_targets[k] - v.shape[ax])
        for lo, hi in pads:
            assert lo >= 0 and hi >= 0, (k, v.shape, b_target, t_targets.get(k))
        out[k] = np.pad(v, pads, constant_values=pad_values.get(k, 0))
    return out


def pad_to_buckets(
    batch: Dict[str, np.ndarray],
    time_keys: Dict[str, int],
    batch_buckets: Sequence[int],
    length_bucket_step: int,
    pad_values: Dict[str, float] | None = None,
    batch_multiple: int = 1,
) -> Dict[str, np.ndarray]:
    """Pad a collated batch to quantised (B, T) buckets for static-shape jit.

    Args:
      batch: dict of arrays with leading batch dim.
      time_keys: {key: axis} for arrays whose time axis should be padded to a
        multiple of ``length_bucket_step``.
      batch_buckets: allowed padded batch sizes.
      pad_values: per-key pad value (default 0).
      batch_multiple: final batch size is rounded up to this multiple (the
        device count, so the batch shards evenly over the data mesh axis).
    """
    pad_values = pad_values or {}
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and v.ndim >= 1}
    b = len(next(iter(arrays.values())))
    b_pad = round_up(bucket_batch_size(b, batch_buckets), batch_multiple)
    out = {}
    for k, v in batch.items():
        if k not in arrays:
            out[k] = v
            continue
        pads = [(0, 0)] * v.ndim
        pads[0] = (0, b_pad - b)
        if k in time_keys:
            ax = time_keys[k]
            t = v.shape[ax]
            pads[ax] = (0, round_up(max(t, 1), length_bucket_step) - t)
        out[k] = np.pad(v, pads, constant_values=pad_values.get(k, 0))
    return out
