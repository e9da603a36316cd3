"""Trainer (``training/trainer.py``, ``training/optim.py``): device
operations the trace holds over the window's steps."""


def read(run):
    if run.trace is None or not run.trace.n_ops or not run.record.get("steps"):
        return None
    return run.trace.n_ops / run.record["steps"]
