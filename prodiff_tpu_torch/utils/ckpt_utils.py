"""Training checkpoints in the JAX package's layout (port of
``prodiff_tpu/utils/ckpt_utils.py``).

- files ``model_ckpt_steps_{N}.ckpt`` in the work dir, written to ``.part``
  and moved into place with ``os.replace``;
- the newest ``num_ckpt_keep`` kept by step number; ``model_ckpt_best.pt`` a
  copy of the step that improved the monitored metric;
- the payload keys of the JAX trainer: ``global_step``, ``epoch``,
  ``checkpoint_callback_best``, ``state_dict`` (the JAX param tree,
  ``utils/convert.py:teacher_flax_params``) and ``optimizer_state``;
- serialised as flax msgpack (arrays as ext type 1 holding ``(shape, dtype
  name, bytes)``, numpy scalars as ext type 3), which
  ``ckpt_utils.load_checkpoint_file`` of the JAX package and
  ``utils/convert.py:load_flax_checkpoint`` of the port both read.

The optimizer state is in the port's own layout: the JAX trainer cannot
resume it, while both packages load the params. Needs msgpack, imported
only when a checkpoint is written.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np

from prodiff_tpu_torch.utils.convert import last_checkpoint_path, load_flax_checkpoint, sorted_checkpoints


def msgpack_dumps(tree: Any) -> bytes:
    """A nested dict of numpy arrays, numpy scalars and Python numbers as
    flax's ``msgpack_serialize`` writes it (arrays under 1 GiB: flax
    chunks larger ones, which no parameter here reaches)."""
    import msgpack

    def array_bytes(a: np.ndarray) -> bytes:
        a = np.ascontiguousarray(a)
        if a.nbytes >= 2 ** 30:
            raise ValueError(f"array of {a.nbytes} bytes: flax would chunk it")
        return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, array_bytes(x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(3, array_bytes(np.asarray(x)))
        raise TypeError(f"cannot serialise {type(x).__name__}")

    return msgpack.packb(tree, default=default, strict_types=True)


def save_checkpoint(work_dir: str, step: int, payload: Dict[str, Any],
                    num_ckpt_keep: int = 3) -> str:
    """Write ``model_ckpt_steps_{step}.ckpt`` atomically, then prune."""
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        f.write(msgpack_dumps(payload))
    os.replace(tmp, path)
    prune_checkpoints(work_dir, num_ckpt_keep)
    return path


def prune_checkpoints(work_dir: str, keep: int) -> None:
    for path, _ in sorted_checkpoints(work_dir)[:-keep] if keep > 0 else []:
        os.remove(path)


def load_last_checkpoint(work_dir: str) -> Optional[Dict[str, Any]]:
    path = last_checkpoint_path(work_dir)
    return load_flax_checkpoint(path) if path else None


def save_best_copy(work_dir: str, step: int) -> None:
    src = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    if os.path.exists(src):
        shutil.copy(src, os.path.join(work_dir, "model_ckpt_best.pt"))
