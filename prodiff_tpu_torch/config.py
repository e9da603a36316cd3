"""Experiment config loading (the port's copy of the ``exp_name`` route of
``prodiff_tpu/config.py:set_hparams``).

A config is YAML with an optional ``base_config`` parent (one path, a list
of paths merged in order, or ``base``/``builtin`` for the shipped defaults);
the child's keys shallow-override the parent's. The shipped defaults are read
as a data file from ``prodiff_tpu/assets/base_config.yaml``. Needs PyYAML,
imported only here.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import yaml

BASE_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "prodiff_tpu", "assets", "base_config.yaml",
)


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
    merged.update(hp)
    return merged


def set_hparams(exp_name: str, task: str, checkpoints_root: str = "checkpoints") -> Dict[str, Any]:
    """``checkpoints_root/exp_name/task/config.yaml`` with ``task``,
    ``exp_name`` and ``work_dir`` stamped in; writes nothing."""
    work_dir = os.path.join(checkpoints_root, exp_name, task)
    config_fn = os.path.join(work_dir, "config.yaml")
    if not os.path.exists(config_fn):
        raise FileNotFoundError(f"Config file not found: {config_fn}")
    hp = load_config(config_fn)
    hp.update(task=task, exp_name=exp_name, work_dir=work_dir)
    return hp
