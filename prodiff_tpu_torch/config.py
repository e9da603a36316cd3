"""Experiment config loading (the port's copy of ``load_config``,
``load_base_config``, ``apply_overrides`` and ``set_hparams`` of
``prodiff_tpu/config.py``).

:func:`predictor_hparams` resolves an auxiliary predictor's config as the
JAX package's ``infer/inferers.py:_resolve_hparams`` does.

A config is YAML with an optional ``base_config`` parent (one path, a list
of paths merged in order, or ``base``/``builtin`` for the shipped defaults);
the child's keys shallow-override the parent's. The shipped defaults are the
port's own copy of the JAX package's ``assets/base_config.yaml``, read as a
data file from ``prodiff_tpu_torch/assets/base_config.yaml`` (the tests hold
the two files equal). Needs PyYAML, imported only here.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml

BASE_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets", "base_config.yaml")


def _resolve_base_path(config_fn: str, base: str) -> str:
    if base in ("base", "builtin"):
        return BASE_CONFIG_PATH
    if not os.path.isabs(base) and not os.path.exists(base):
        cand = os.path.join(os.path.dirname(config_fn), base)
        return cand if os.path.exists(cand) else base
    return base


def load_config(config_fn: str) -> Dict[str, Any]:
    """Load a YAML config, recursively merging its ``base_config`` parent(s)."""
    with open(config_fn) as f:
        hp = yaml.safe_load(f) or {}
    base = hp.get("base_config", "")
    parents = list(base) if isinstance(base, (list, tuple)) else [base] if base else []
    merged: Dict[str, Any] = {}
    for parent in parents:
        merged.update(load_config(_resolve_base_path(config_fn, parent)))
    if isinstance(base, (list, tuple)):
        # a list of parents is resolved here and dropped, so the merged config
        # written to a work dir names no parent by a relative path
        hp = {k: v for k, v in hp.items() if k != "base_config"}
    merged.update(hp)
    return merged


def load_base_config() -> Dict[str, Any]:
    """The shipped defaults."""
    with open(BASE_CONFIG_PATH) as f:
        return yaml.safe_load(f)


def apply_overrides(cfg: Dict[str, Any], overrides: str) -> Dict[str, Any]:
    """Apply ``"a=1,b.c=2"`` dotted overrides to ``cfg`` in place (each value
    read as YAML, an empty one as None) and return it."""
    for item in (overrides or "").split(","):
        item = item.strip()
        if not item:
            continue
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw) if raw != "" else None
    return cfg


def set_hparams(exp_name: Optional[str] = None, task: Optional[str] = None,
                checkpoints_root: str = "checkpoints", config_fn: Optional[str] = None,
                make_work_dir: bool = False, *, overrides: str = "") -> Dict[str, Any]:
    """``config_fn`` when it exists, else the work dir's ``config.yaml``
    (``checkpoints_root/exp_name/task``, or ``checkpoints_root/task`` without
    an experiment, as for ``vocode``), with ``overrides``
    (:func:`apply_overrides`) applied and ``task``, ``exp_name`` (when
    given) and ``work_dir`` stamped in. ``make_work_dir`` creates the work dir
    and writes the merged config there as ``config.yaml``, as the JAX trainer
    does."""
    if config_fn is None and task is None:
        raise ValueError("set_hparams: give a config file or a task")
    work_dir = os.path.join(checkpoints_root, *([exp_name] if exp_name is not None else []),
                            task or "")
    if config_fn is None or not os.path.exists(config_fn):
        config_fn = os.path.join(work_dir, "config.yaml")
    if not os.path.exists(config_fn):
        raise FileNotFoundError(f"Config file not found: {config_fn}")
    hp = apply_overrides(load_config(config_fn), overrides)
    hp.update(task=task, work_dir=work_dir)
    if exp_name is not None:
        hp["exp_name"] = exp_name
    if make_work_dir:
        os.makedirs(work_dir, exist_ok=True)
        with open(os.path.join(work_dir, "config.yaml"), "w") as f:
            yaml.dump(hp, f)
    return hp


def predictor_hparams(exp_name: str, task: str, checkpoints_root: str = "checkpoints"
                      ) -> Dict[str, Any]:
    """A predictor's hparams (``task``: ``dur``, ``pitch``, ``voicing`` or
    ``breath``): the experiment's own ``{exp_name}/{task}/config.yaml``
    where it exists, else the global ``checkpoints_root/{task}``."""
    local = os.path.join(checkpoints_root, exp_name, task, "config.yaml")
    return set_hparams(exp_name if os.path.exists(local) else None, task, checkpoints_root)
