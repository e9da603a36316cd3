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

The optimizer state is the tree of optax's state
(``training/optim.py``), so each package's trainer resumes the other's
checkpoints. ``extract_submodel`` and ``merge_subtree`` cut and splice
param trees (``merge_rectified``). Needs msgpack, imported when a
checkpoint is read or written.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np

from prodiff_tpu_torch.utils.convert import last_checkpoint_path, load_flax_checkpoint, sorted_checkpoints


def msgpack_dumps(tree: Any) -> bytes:
    """A nested dict of numpy arrays, numpy scalars and Python numbers as
    flax's ``msgpack_serialize`` writes it, byte for byte: every dict's keys
    sorted (flax maps the tree first, and JAX's pytrees sort dict keys);
    arrays under 1 GiB (flax chunks larger ones, which no parameter here
    reaches)."""
    import msgpack

    def array_bytes(a: np.ndarray) -> bytes:
        if a.nbytes >= 2 ** 30:
            raise ValueError(f"array of {a.nbytes} bytes: flax would chunk it")
        return msgpack.packb((a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True)

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, array_bytes(x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(3, array_bytes(np.asarray(x)))
        raise TypeError(f"cannot serialise {type(x).__name__}")

    def sort(x):
        return {k: sort(x[k]) for k in sorted(x)} if isinstance(x, dict) else x

    return msgpack.packb(sort(tree), default=default, strict_types=True)


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


def get_last_checkpoint_path(work_dir: str) -> Optional[str]:
    return last_checkpoint_path(work_dir)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    return load_flax_checkpoint(path)


def write_checkpoint_file(path: str, payload: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        f.write(msgpack_dumps(payload))


def load_last_checkpoint(work_dir: str) -> Optional[Dict[str, Any]]:
    path = last_checkpoint_path(work_dir)
    return load_flax_checkpoint(path) if path else None


def save_best_copy(work_dir: str, step: int) -> None:
    src = os.path.join(work_dir, f"model_ckpt_steps_{step}.ckpt")
    if os.path.exists(src):
        shutil.copy(src, os.path.join(work_dir, "model_ckpt_best.pt"))


def extract_submodel(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The subtree at a dotted ``prefix``, e.g. ``diffusion``."""
    node = params
    for part in prefix.split("."):
        if part not in node:
            raise KeyError(f"submodel prefix {prefix!r} not found at {part!r}")
        node = node[part]
    return node


def merge_subtree(target: Dict[str, Any], prefix: str, subtree: Dict[str, Any]) -> Dict[str, Any]:
    """Splice ``subtree`` into ``target`` at a dotted ``prefix``."""
    node = target
    parts = prefix.split(".")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = subtree
    return target
