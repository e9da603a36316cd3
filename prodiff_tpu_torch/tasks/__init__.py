"""Train-task registry (port of ``prodiff_tpu/tasks/__init__.py``)."""

from __future__ import annotations

_TASKS = {}


def register_task(name: str):
    def deco(cls):
        _TASKS[name] = cls
        cls.task_name = name
        return cls

    return deco


def get_task_cls(name: str):
    # import the task modules on demand so registration happens; a broken
    # task module raises instead of reading as an unknown task
    from prodiff_tpu_torch.tasks import (  # noqa: F401
        dur_predictor, pitch_predictor, svs, vari_predictor)

    if name not in _TASKS:
        raise KeyError(f"Unknown train task {name!r}; known: {sorted(_TASKS)}")
    return _TASKS[name]
